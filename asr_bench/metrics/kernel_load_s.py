"""Seconds the run spent making its kernel libraries ready: the program's
``setup.kernels`` spans (``utils/tracing.py``: ``cuda_build.build_all`` and
each library's first load; a checkout's first run compiles them),
untraced. None where the program has no such span."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.snapshot("untraced")["spans"].get("setup.kernels")
    return s["total_s"] if s else None
