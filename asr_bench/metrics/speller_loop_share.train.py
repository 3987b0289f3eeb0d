"""The speller loop's share of a replayed train step's device time, in %:
the program's ``train.speller`` section (``utils/tracing.py``: device marks
inside the captured step around the Python loop's teacher-forced forward
steps, on the loop route only) over the sum of the step's ``train.*``
sections, untraced bank. None where the program has no such section (the
fused scan's route, or a program without the mark)."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    sections = tracing.snapshot("untraced")["sections"]
    loop = sections.get("train.speller")
    if not loop or not loop["n"]:
        return None
    total = sum(s["total_ms"] for name, s in sections.items() if name.startswith("train."))
    return 100.0 * loop["total_ms"] / total if total > 0 else None
