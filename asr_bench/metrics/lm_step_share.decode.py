"""The RNN-LM's share of the replayed beam step, in %: the program's
``beam.lm`` section over ``beam.speller`` + ``beam.lm`` + ``beam.search``
(``utils/tracing.py``: device marks inside the captured beam step), untraced
runs only. None where the program has no LM section."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    sec = tracing.snapshot("untraced")["sections"]
    if not sec.get("beam.lm"):
        return None
    step = sum(sec[k]["total_ms"] for k in ("beam.speller", "beam.lm", "beam.search") if k in sec)
    return 100.0 * sec["beam.lm"]["total_ms"] / step
