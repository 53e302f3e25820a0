"""ssm_scan_roofline.prefill: L3 (``selective_scan_fwd``) at its roofline:
its bound (``ssm_counts.scan_bound_s``) for each launch the trace recorded
in the full traced steps, over those launches' device time.  Device
trace; nothing where no launch was recorded (a program without L3)."""

from portbench import ssm_counts

KERNEL = "selective_scan_fwd_kernel"


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
    bound = launches * ssm_counts.scan_bound_s(run.model, run.batch, run.seq, run.peaks)
    return 100.0 * bound / seconds
