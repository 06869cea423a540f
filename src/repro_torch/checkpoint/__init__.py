"""Fault-tolerant checkpointing: atomic, async, in the reference's layout."""
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]
