"""The CTC prefix and eos scores' share of their roofline over the traced
slice, in %: the least time of each utterance's candidates over its valid
frames at every beam step inside its token window (``work.ctc_prefix``,
float32) over the device time of the kernels named in
``kernels/ctc_prefix/``."""

from asr_bench import shapes, work


def read(ctx):
    run, recipe = ctx["run"], ctx["recipe"]
    if run.kind != "decode" or run.trace is None or recipe["decode"]["ctc_weight"] <= 0:
        return None
    names = ctx["kernel_names"]("ctc_prefix")
    dev_s = sum(t for k, t in run.trace["kernels"].items() if any(n in k for n in names))
    if dev_s <= 0:
        return None
    w, kc = recipe["decode"]["beam_size"], shapes.k_cand(recipe)
    least = 0.0
    for b in run.slice_batches:
        s = shapes.enc_frames(recipe, b)
        lens = [e for e, u in zip(shapes.enc_lens(recipe, b), b["uids"]) if u]
        for e_len, steps in zip(lens, shapes.active_steps(recipe, b)):
            least += steps * work.least_s(work.ctc_prefix(1, w, kc, s, shapes.VOCAB, float(e_len)), "float32")
    return 100.0 * least / dev_s
