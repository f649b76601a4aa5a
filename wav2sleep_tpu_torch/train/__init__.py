"""Training on one card: the port's counterpart of ``wav2sleep_tpu/train/``
(``metrics``, ``scheduler``, ``masker``, ``step``; ``datamodule``, ``loop``,
``checkpointing``, ``tuning``, ``supervise``) and of ``scripts/train.py``
(``python -m wav2sleep_tpu_torch.train``, ``__main__``)."""
