"""step_mfu_pct.prefill: the model FLOPs of the window's steps
(``counts.step_flops``) over the window's seconds, as a share of the
card's bf16 peak.  Host clock for the time, shapes for the FLOPs."""

from portbench import counts


def read(run):
    if not run.on_card or run.peaks is None:
        return None
    flops = counts.step_flops(run.model, run.family, run.batch, run.seq) * len(run.steps)
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops_per_s"]
