"""Back-compat re-export shim (reference: src/wav2sleep/cli/data_utils.py)."""

from ..api import load_dataset, prepare, save_predictions

prepare_dataset = prepare

__all__ = ['prepare', 'prepare_dataset', 'load_dataset', 'save_predictions']
