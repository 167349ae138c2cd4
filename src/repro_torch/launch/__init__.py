"""Launch entry points: serving (``python -m repro_torch.launch.serve``),
training (``python -m repro_torch.launch.train``), the meshes and the
multi-pod dry run (``python -m repro_torch.launch.dryrun``)."""
