"""Command-line entry points of the port's inference API (``python -m
wav2sleep_tpu_torch.cli.predict``) and the JAX package's back-compat shims."""
