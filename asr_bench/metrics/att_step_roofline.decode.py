"""The beam's location-attention step's share of its roofline over the
traced slice, in %: the least time of each utterance's attention over its
valid frames at every beam step inside its token window (``work.att_step``,
float32) over the device time of the kernels named in ``kernels/att_step/``."""

from asr_bench import shapes, work


def read(ctx):
    run, recipe = ctx["run"], ctx["recipe"]
    if run.kind != "decode" or run.trace is None:
        return None
    names = ctx["kernel_names"]("att_step")
    dev_s = sum(t for k, t in run.trace["kernels"].items() if any(n in k for n in names))
    if dev_s <= 0:
        return None
    m = recipe["model"]
    att, w = m["attention"], recipe["decode"]["beam_size"]
    least = 0.0
    for b in run.slice_batches:
        s = shapes.enc_frames(recipe, b)
        lens = [e for e, u in zip(shapes.enc_lens(recipe, b), b["uids"]) if u]
        for e_len, steps in zip(lens, shapes.active_steps(recipe, b)):
            one = work.att_step(1, w, s, att["dim"], 2 * m["encoder"]["dim"][-1], att["loc_kernel_num"],
                                2 * att["loc_kernel_size"] + 1, float(e_len))
            least += steps * work.least_s(one, "float32")
    return 100.0 * least / dev_s
