"""prefill_step_p90_ms: the 90th percentile over every step of the
window of the wall from the call to forward to the logits on the host,
the time to first token of every prompt in the step.  Host clock."""

import statistics


def read(run):
    if not run.on_card:
        return None
    walls = [1e3 * (s.done - s.dispatch) for s in run.steps]
    if len(walls) < 2:
        return walls[0]
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
