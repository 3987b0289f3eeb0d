"""Seconds the run spent capturing CUDA graphs, each capture's eager warm-up
included: the program's ``graph.capture`` spans (``utils/tracing.py``),
untraced. None where the program has no such span."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.snapshot("untraced")["spans"].get("graph.capture")
    return s["total_s"] if s else None
