"""wav2sleep_tpu_torch: the PyTorch / CUDA port of wav2sleep_tpu for NVIDIA Hopper.

The JAX package ``wav2sleep_tpu`` is the reference. This package keeps its
layout (``models/``, ``ops/``, ``data/``, ``native/``, ``pipeline.py``,
``convert.py``, ``settings.py``) and its channels-last ``[B, T, C]`` tensors
at public functions, and replaces its Pallas TPU kernels with kernels
written for sm_90a (``csrc/``). It imports nothing of ``wav2sleep_tpu``:
what it needs of the JAX package's modules that import no JAX (settings,
the EDF reader, the resamplers, the native host library, the checkpoint
key mapping) it keeps as its own copies. The inference API's functions
(``load_model``, ``prepare``, ``load_dataset``, ``predict``,
``save_predictions``, ``predict_on_folder``) are importable from the
package, as from the JAX package.
"""

__all__ = [
    'load_model',
    'prepare',
    'load_dataset',
    'predict',
    'save_predictions',
    'predict_on_folder',
]


def __getattr__(name):
    # Lazy: ``import wav2sleep_tpu_torch`` stays light and cycle-free.
    if name in __all__:
        from . import api

        return getattr(api, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
