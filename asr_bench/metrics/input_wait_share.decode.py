"""Share of the decode window the loop waited in ``next(prefetch)`` (the
harness's host-clock spans around the eval loader's prefetcher), in %."""


def read(ctx):
    run = ctx["run"]
    if run.kind != "decode" or run.wall_s <= 0:
        return None
    return 100.0 * run.wait_s / run.wall_s
