"""k7_roofline.prefill: K7 (``flash_attention_tc``) at its roofline: its
bound (``counts.k7_bound_s``) for each launch the trace recorded in the
full traced steps, over those launches' device time.  Device trace."""

from portbench import counts

KERNEL = "flash_attention_tc"


def read(run):
    if not run.on_card or run.trace is None or run.peaks is None:
        return None
    seconds, launches = 0.0, 0
    for name, (sec, n) in run.trace.op_seconds().items():
        if KERNEL in name:
            seconds += sec
            launches += n
    if not launches:
        return None
    bound = launches * counts.k7_bound_s(run.model, run.batch, run.seq, run.peaks)
    return 100.0 * bound / seconds
