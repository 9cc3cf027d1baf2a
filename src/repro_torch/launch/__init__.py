"""Launchers: the serving entry point (``python -m repro_torch.launch.serve``).
The mesh, training and dry-run launchers wait for ROADMAP A11."""
