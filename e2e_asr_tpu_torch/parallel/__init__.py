"""Data parallelism over processes (``parallel/dist.py``): the port's
counterpart of ``e2e_asr_tpu/parallel/``."""
