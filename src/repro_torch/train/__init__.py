"""repro_torch.train — the fault-tolerant QAT training loop."""
from .trainer import TrainConfig, Trainer, make_loss_fn, make_train_step

__all__ = ["TrainConfig", "Trainer", "make_loss_fn", "make_train_step"]
