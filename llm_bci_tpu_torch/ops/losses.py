"""Elementwise losses, ``reduction="none"`` (counterpart of
``llm_bci_tpu/ops/losses.py``)."""
from __future__ import annotations

import torch


def poisson_nll_loss(preds: torch.Tensor, targets: torch.Tensor,
                     log_input: bool = True) -> torch.Tensor:
    """Poisson NLL without the Stirling term: ``exp(x) - t*x`` when
    ``log_input`` else ``x - t*log(x + 1e-8)``."""
    if log_input:
        return torch.exp(preds) - targets * preds
    return preds - targets * torch.log(preds + 1e-8)


def mse_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.square(preds - targets)


def cross_entropy_loss(
    logits: torch.Tensor,         # (..., V)
    targets: torch.Tensor,        # (...) int labels; ignore_index skipped
    ignore_index: int = -100,
) -> torch.Tensor:                # (...) per-position loss, 0 at ignored
    logits = logits.float()
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, torch.zeros_like(targets))
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe_targets[..., None].long())[..., 0]
    return torch.where(valid, logz - picked, torch.zeros_like(logz))
