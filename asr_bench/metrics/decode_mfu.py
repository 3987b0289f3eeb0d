"""Model FLOPs the decode window's batches need (the encoder's forward, and
per utterance and beam step inside its token window the speller, the LM and
the CTC prefix scores of every hypothesis; ``work.py``) over the window's
wall time times the float32 peak (decoding runs in float32), in %."""

from asr_bench import shapes, work


def read(ctx):
    run, recipe = ctx["run"], ctx["recipe"]
    if run.kind != "decode" or not run.batches:
        return None
    d, v = recipe["decode"], ctx["vocab"]
    flops = 0.0
    for b in run.batches:
        real = [i for i, u in enumerate(b["uids"]) if u]
        fl = shapes.feat_lens(recipe, b)
        flops += work.decode_flops(ctx["arch"], recipe["model"], recipe["lm"], recipe["data"]["audio"]["feat_dim"], v,
                                   d["beam_size"], shapes.k_cand(recipe, v), d["lm_weight"] > 0, d["ctc_weight"] > 0,
                                   [fl[i] for i in real], shapes.active_steps(recipe, b))
    return 100.0 * flops / (run.wall_s * work.PEAK_FLOPS["float32"])
