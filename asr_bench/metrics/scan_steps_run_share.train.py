"""The share of the token buckets' speller steps that the fused scan ran, in
%: the program's device counter ``scan.steps_run`` (the steps each launch of
the scan's forward ran; a training step stops at its batch's longest label)
over its host counter ``scan.bucket_steps`` (each launch's bucket length L),
untraced bank (``utils/tracing.py``). None where the program has no such
counters."""


def read(ctx):
    try:
        from e2e_asr_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.snapshot("untraced")["counts"]
    run, bucket = counts.get("scan.steps_run"), counts.get("scan.bucket_steps")
    if run is None or not bucket:
        return None
    return 100.0 * run / bucket
