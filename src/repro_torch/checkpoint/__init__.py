"""Checkpointing: atomic step directories, an async writer, resume."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
