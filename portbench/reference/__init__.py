"""The benchmark's plain reference of the Laminar engine's tick.

A frozen copy of the plain PyTorch path of the port (``repro_torch``'s
``core`` and ``workloads`` modules and the plain versions of its four
hot-path kernels), with every import made local to this package: it
imports nothing of the program and is not changed by a change to it. It
decides whether what the program's timed path produced is correct
(``benchlib.check``). ``tick.make_step`` is one tick, ``tick.init`` the
initial state, ``tick.summarize`` a run's summary, ``draws.TorchDraws`` the
random values of a tick from a seed; the four hot-path entries
(``hotpath``) run their plain versions on the CPU.
"""
