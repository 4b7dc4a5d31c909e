"""Launchers (a port of ``repro.launch``): the serving driver
``python -m repro_torch.launch.serve``."""
