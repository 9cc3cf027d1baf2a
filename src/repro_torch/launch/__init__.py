"""Launchers: serving (``python -m repro_torch.launch.serve``), training
(``python -m repro_torch.launch.train``) and the dry-run
(``python -m repro_torch.launch.dryrun``, its per-device trace analysis in
``hlo_analysis``), and the production mesh (``mesh``)."""
