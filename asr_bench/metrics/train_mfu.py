"""Model FLOPs the training window's batches need (forward and backward of
the layer equations at valid lengths, nothing recomputed; ``work.py``) over
the window's wall time times the compute type's peak, in %."""

from asr_bench import shapes, work


def read(ctx):
    run, recipe = ctx["run"], ctx["recipe"]
    if run.kind != "train" or not run.batches:
        return None
    feat_dim = recipe["data"]["audio"]["feat_dim"]
    flops = sum(work.train_step_flops(ctx["arch"], recipe["model"], feat_dim, ctx["vocab"],
                                      shapes.feat_lens(recipe, b), b["text_len"]) for b in run.batches)
    return 100.0 * flops / (run.wall_s * work.PEAK_FLOPS[recipe["hparas"]["dtype"]])
