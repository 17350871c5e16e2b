"""Host-side evaluation utilities of the port (``eval_bci``: WER / CER and
the greedy CTC collapse). The other ``eval`` modules of ``llm_bci_tpu``
come with the slices that need them."""
