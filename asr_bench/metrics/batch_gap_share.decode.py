"""The share of the marked decode time that lies between batches, in %: the
program's ``beam.between_batches`` section (from a batch's last beam step to
the next batch's first: ``rank``, the readback, the host's turnaround, the
input wait, the features and the encoder) over every ``beam.*`` section
(``utils/tracing.py``), untraced runs only. None where the program has no
such section."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    sec = tracing.snapshot("untraced")["sections"]
    if not sec.get("beam.between_batches"):
        return None
    return 100.0 * sec["beam.between_batches"]["total_ms"] / sum(
        v["total_ms"] for k, v in sec.items() if k.startswith("beam."))
