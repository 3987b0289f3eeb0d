"""The speller recurrence's share of its roofline over the traced slice, in
%: the least time of the scan's forward and backward at each step's shapes
and valid encoder frames (``work.scan_fwd`` / ``work.scan_bwd`` at the
compute type) over the device time of the kernels named in
``kernels/decoder_scan/``."""

from asr_bench import shapes, work


def read(ctx):
    run, recipe = ctx["run"], ctx["recipe"]
    if run.kind != "train" or run.trace is None:
        return None
    names = ctx["kernel_names"]("decoder_scan")
    dev_s = sum(t for k, t in run.trace["kernels"].items() if any(n in k for n in names))
    if dev_s <= 0:
        return None
    m, dt = recipe["model"], recipe["hparas"]["dtype"]
    att, h = m["attention"], m["decoder"]["dim"]
    dims = (att["dim"], 2 * m["encoder"]["dim"][-1], att["loc_kernel_num"], 2 * att["loc_kernel_size"] + 1, h, h,
            shapes.VOCAB)
    least = 0.0
    for b in run.slice_batches:
        args = (b["b"], shapes.enc_frames(recipe, b), *dims, b["l"], shapes.enc_lens(recipe, b), dt)
        least += work.least_s(work.scan_fwd(*args), dt) + work.least_s(work.scan_bwd(*args), dt)
    return 100.0 * least / dev_s
