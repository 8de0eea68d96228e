"""Data pipeline of the port (reference: ``repro/data``)."""
from repro_torch.data.pipeline import SyntheticLMDataset, prefetch

__all__ = ["SyntheticLMDataset", "prefetch"]
