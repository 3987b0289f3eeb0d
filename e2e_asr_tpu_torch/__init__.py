"""e2e_asr_tpu_torch — the PyTorch/CUDA port of e2e_asr_tpu for NVIDIA Hopper.

The JAX package ``e2e_asr_tpu`` is the reference. This package imports
nothing of it and nothing of JAX. It holds the serving path (features ->
VGG + BiLSTM encoder -> location attention + CTC prefix beam search) and
the joint CTC/attention training step (``training/step.py``,
``bin/train_asr.py``), with hand-written CUDA kernels for ``sm_90a``
(``csrc/``), each beside its plain PyTorch version.
"""

__version__ = "0.1.0"
