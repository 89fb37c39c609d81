"""Launchers: ``python -m repro_torch.launch.serve`` drives the online
serving path."""
