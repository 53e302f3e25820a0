"""setup_s: process start to the first timed step (imports, the kernel
build on a checkout's first run, weights drawn on the card, warm-up
steps at the cell's shape).  Host clock."""


def read(run):
    return run.setup_s if run.on_card else None
