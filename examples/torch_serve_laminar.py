"""End-to-end serving driver on PyTorch: batched requests with declared
priorities are scheduled probe-first onto replica KV-page pools and decoded
by a real (reduced) model; under page pressure the Airlock ladder protects
high-priority sequences.

    PYTHONPATH=src python examples/torch_serve_laminar.py --arch qwen3-1.7b
    PYTHONPATH=src python examples/torch_serve_laminar.py --device cpu

The counterpart of ``examples/serve_laminar.py``: ``repro_torch.launch.serve``
run as a program with ``--smoke`` put first and the rest of the arguments
after it (``--device``, ``--ticks``, ...). On the card by default; without
one it raises unless given ``--device cpu``.
"""

import runpy
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    saved = sys.argv
    sys.argv = ["serve", "--smoke"] + argv
    try:
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    finally:
        sys.argv = saved


if __name__ == "__main__":
    main()
