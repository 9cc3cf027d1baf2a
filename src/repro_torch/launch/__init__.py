"""Launchers: serving (``python -m repro_torch.launch.serve``) and training
(``python -m repro_torch.launch.train``), and the production mesh
(``mesh``). The dry-run and its compiled-graph analysis wait for ROADMAP
A11b."""
