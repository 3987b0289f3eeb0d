"""Unpadded samples over padded samples (rows x bucket length) of the
training window's batches, in %: how much of each bucketed batch is audio."""


def read(ctx):
    run = ctx["run"]
    if run.kind != "train" or not run.batches:
        return None
    real = sum(sum(b["wav_len"]) for b in run.batches)
    slots = sum(b["b"] * b["n"] for b in run.batches)
    return 100.0 * real / slots
