"""The share of the card's SMs that the speller scan's backward kernel gave
frames to, in %: the program's host counter ``scan.bwd_frame_blocks`` (the
blocks each launch's grid deals frames to) over its host counter
``scan.bwd_sms`` (the card's SMs, each launch), untraced bank
(``utils/tracing.py``). None where the program has no such counters."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.snapshot("untraced")["counts"]
    blocks, sms = counts.get("scan.bwd_frame_blocks"), counts.get("scan.bwd_sms")
    if blocks is None or not sms:
        return None
    return 100.0 * blocks / sms
