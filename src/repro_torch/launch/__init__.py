"""Launchers (a port of ``repro.launch``): the step builders
(``launch.steps``), the device mesh (``launch.mesh``), the training driver
``python -m repro_torch.launch.train``, the serving driver ``python -m
repro_torch.launch.serve``, the dry-run ``python -m
repro_torch.launch.dryrun`` and the roofline ``python -m
repro_torch.launch.roofline``."""
