# Mirrors llm_bci_tpu/data/__init__.py (host code that imports no JAX): the port keeps its own copy.
from llm_bci_tpu_torch.data.datasets import (
    SpikingDataset,
    SpikingDatasetForDecoding,
    DaySpecificSpikingDatasetForDecoding,
    padded_array,
    pad_collate_fn,
)
