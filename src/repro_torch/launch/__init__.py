"""Launchers: serving (``python -m repro_torch.launch.serve``) and training
(``python -m repro_torch.launch.train``). The mesh and dry-run launchers
wait for ROADMAP A11."""
