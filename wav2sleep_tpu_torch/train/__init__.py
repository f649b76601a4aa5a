"""The single-card training step of the port: the port's counterpart of
``wav2sleep_tpu/train/`` (``metrics``, ``scheduler``, ``masker``, ``step``)."""
