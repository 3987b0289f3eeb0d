"""Share of the traced slice of training steps in which no kernel, copy or
set ran on the card (torch.profiler's device intervals, merged), in %."""


def read(ctx):
    run = ctx["run"]
    if run.kind != "train" or run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
