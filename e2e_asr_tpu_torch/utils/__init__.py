"""Small helpers and the measurement layer: ``misc.py`` (number formatting,
resident memory, one-time warnings), ``profiling.py`` (the card's peaks,
``bound_ms``, ``trace``, ``time_fn``, ``Roofline``, each hand kernel's
least work) and ``stages.py`` (the train step's stages, each timed as its
own program and held against its own ceiling): the port's counterparts of
``e2e_asr_tpu/utils/``."""
