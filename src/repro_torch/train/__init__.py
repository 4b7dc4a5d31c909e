"""Training substrate (a port of ``repro.train``): optimizer, data pipeline,
checkpointing, straggler monitor and the fault-tolerant loop."""

from repro_torch.train import checkpoint, data, optimizer, straggler, trainer

__all__ = ["checkpoint", "data", "optimizer", "straggler", "trainer"]
