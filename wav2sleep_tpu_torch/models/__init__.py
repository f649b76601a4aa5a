"""wav2sleep models as ``torch.nn.Module``s on channels-last tensors."""
