"""Training data: deterministic synthetic and byte-corpus batches."""
from .pipeline import CorpusDataset, DataConfig, SyntheticLMDataset

__all__ = ["CorpusDataset", "DataConfig", "SyntheticLMDataset"]
