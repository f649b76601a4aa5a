"""wav2sleep_tpu_torch: the PyTorch / CUDA port of wav2sleep_tpu for NVIDIA Hopper.

The JAX package ``wav2sleep_tpu`` is the reference. This package keeps its
layout (``models/``, ``ops/``, ``pipeline.py``, ``convert.py``) and its
channels-last ``[B, T, C]`` tensors at public functions, and replaces its
Pallas TPU kernels with kernels written for sm_90a (``csrc/``). Modules of
the JAX package that import no JAX are shared: ``settings`` and ``utils`` by
import; the host EDF extractor (``pipeline.Q8NightExtractor``, with
``native``) and ``checkpoint``'s key mapping lazily, where they are used.
"""
