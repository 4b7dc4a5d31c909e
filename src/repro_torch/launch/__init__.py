"""Launchers (a port of ``repro.launch``): the step builders
(``launch.steps``), the training driver ``python -m repro_torch.launch.train``
and the serving driver ``python -m repro_torch.launch.serve``."""
