"""The optimizer's device ms a replayed train step: the program's
``train.optimizer`` section (``utils/tracing.py``: device marks inside the
captured step around the global norm, the clip and the update) over its
intervals, untraced runs only. None where the program has no such section."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.snapshot("untraced")["sections"].get("train.optimizer")
    if not s or not s["n"]:
        return None
    return s["total_ms"] / s["n"]
