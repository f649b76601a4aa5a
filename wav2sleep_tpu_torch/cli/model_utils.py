"""Back-compat re-export shim (reference: src/wav2sleep/cli/model_utils.py)."""

from ..api import load_model, predict, predict_on_folder, save_predictions

apply_model = predict

__all__ = ['load_model', 'predict', 'apply_model', 'predict_on_folder', 'save_predictions']
