"""repro_torch.data — the deterministic synthetic LM pipeline."""
from .pipeline import DataConfig, SyntheticLM, host_batch_slice

__all__ = ["DataConfig", "SyntheticLM", "host_batch_slice"]
