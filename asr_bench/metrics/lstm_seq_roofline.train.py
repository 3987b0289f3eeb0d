"""The BiLSTM recurrences' share of their roofline over the traced slice, in
%: the least time of every layer's forward and backward sweep at each
step's shapes and valid frames (``work.lstm_seq_fwd`` / ``work.lstm_seq_bwd``
at the compute type) over the device time of the kernels named in
``kernels/lstm_seq/``."""

from asr_bench import shapes, work


def read(ctx):
    run, recipe = ctx["run"], ctx["recipe"]
    if run.kind != "train" or run.trace is None:
        return None
    names = ctx["kernel_names"]("lstm_seq")
    dev_s = sum(t for k, t in run.trace["kernels"].items() if any(n in k for n in names))
    if dev_s <= 0:
        return None
    dt = recipe["hparas"]["dtype"]
    least = 0.0
    for b in run.slice_batches:
        t = shapes.enc_frames(recipe, b)
        valid = float(sum(f // 4 for f in shapes.feat_lens(recipe, b)))
        for h in recipe["model"]["encoder"]["dim"]:
            least += (work.least_s(work.lstm_seq_fwd(t, b["b"], h, valid, 2, dt), dt)
                      + work.least_s(work.lstm_seq_bwd(t, b["b"], h, valid, 2, dt), dt))
    return 100.0 * least / dev_s
