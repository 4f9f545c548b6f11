"""repro_torch.checkpoint — atomic async checkpoints."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
