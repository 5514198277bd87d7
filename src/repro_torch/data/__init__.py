"""Synthetic data of the port (numpy only)."""
from repro_torch.data.pipeline import (  # noqa: F401
    Prefetcher,
    SyntheticASRDataset,
    SyntheticLMDataset,
    SyntheticSeq2SeqDataset,
    SyntheticVLMDataset,
    make_dataset,
)
