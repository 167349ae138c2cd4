"""Launch entry points: zoo-model serving (``python -m
repro_torch.launch.serve``)."""
