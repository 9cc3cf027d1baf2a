"""Input pipeline of the port (``repro.data``)."""
from repro_torch.data.pipeline import PrefetchingLoader, SyntheticTokenDataset

__all__ = ["PrefetchingLoader", "SyntheticTokenDataset"]
