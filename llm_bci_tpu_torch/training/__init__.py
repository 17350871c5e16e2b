"""Training loop of the port. Import ``Trainer`` from
``llm_bci_tpu_torch.training.trainer``."""
