"""prefill_tokens_per_s: every prompt token of the window's steps over
the window's seconds, from the first step's draw to the last step's
logits on the host.  Host clock."""


def read(run):
    if not run.on_card:
        return None
    return run.tokens_per_step * len(run.steps) / run.window_s
