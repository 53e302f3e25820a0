"""dispatch_idle_ms.prefill: the device's idle time a step while the
host is inside ``models.model.forward``, dispatching its operations: the
Python dispatch and launch time that the device waits for, mean over the
full traced steps.  Device trace (the idle gaps under the harness's
``portbench.forward`` span)."""

SPAN = "portbench.forward"


def read(run):
    if not run.on_card or run.trace is None or not run.trace.full:
        return None
    steps = run.trace.full_steps
    return sum(s.gaps.get(SPAN, 0.0) for s in steps) / 1e3 / len(steps)
