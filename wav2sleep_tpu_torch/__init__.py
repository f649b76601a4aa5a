"""wav2sleep_tpu_torch: the PyTorch / CUDA port of wav2sleep_tpu for NVIDIA Hopper.

The JAX package ``wav2sleep_tpu`` is the reference. This package keeps its
layout (``models/``, ``ops/``, ``data/``, ``native/``, ``pipeline.py``,
``convert.py``, ``settings.py``) and its channels-last ``[B, T, C]`` tensors
at public functions, and replaces its Pallas TPU kernels with kernels
written for sm_90a (``csrc/``). It imports nothing of ``wav2sleep_tpu``:
what it needs of the JAX package's modules that import no JAX (settings,
the EDF reader, the resamplers, the native host library, the checkpoint
key mapping) it keeps as its own copies.
"""
