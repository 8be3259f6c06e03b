"""Data substrate: the deterministic synthetic LM pipeline (own copy of
``repro.data``)."""
from .pipeline import DataConfig, SyntheticLMDataset

__all__ = ["DataConfig", "SyntheticLMDataset"]
