"""Dense attention with explicit probabilities
(counterpart of the explicit-probs path of ``llm_bci_tpu/ops/attention.py``).

At the stacked NDT1-CTC length (T'=121) the JAX package takes the dense
path, not its flash kernel, so this module is plain tensor code: logits,
a masked softmax in float32, attention-probability dropout with torch SDPA
semantics (``probs * keep / (1 - p)``) drawn from an explicit generator,
and the value product. Layouts follow the JAX package: (B, T, H, D).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

MASK_VALUE = -1e30


def dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout whose keep mask comes from ``generator``
    (``F.dropout`` only reads the global RNG)."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def dot_product_attention(
    q: torch.Tensor,                      # (B, T, H, D)
    k: torch.Tensor,                      # (B, S, Hkv, D), H a multiple of Hkv
    v: torch.Tensor,                      # (B, S, Hkv, D)
    mask: Optional[torch.Tensor] = None,  # (B, 1|H, T, S) bool; True = attend
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:                        # (B, T, H, D)
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))    # (B, H | Hkv, T | S, D)
    if Hkv != H:
        # Grouped-query attention: query head h reads key / value head
        # h // G. The G query heads of a group are folded into the row
        # dimension, so K and V (the cache) are read as they are stored,
        # never repeated.
        if H % Hkv:
            raise ValueError(f"{H} query heads are not a multiple of {Hkv} key / value heads")
        qh = qh.reshape(B, Hkv, (H // Hkv) * T, D)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(D)
    logits = logits.view(B, H, T, S)
    if mask is not None:
        logits = logits.masked_fill(~mask, MASK_VALUE)
    probs = torch.softmax(logits.float(), dim=-1).to(vh.dtype)
    probs = dropout(probs, dropout_rate, dropout_rate > 0.0, generator)
    out = torch.matmul(probs.view(B, Hkv, (H // Hkv) * T, S), vh)
    return out.view(B, H, T, D).transpose(1, 2)


def make_attention_mask(
    spikes_mask: torch.Tensor,                    # (B, T) 1 = valid
    context_mask: Optional[torch.Tensor],         # (T, T) 1 = in-window, or None
) -> torch.Tensor:                                # (B, 1, T, T) bool
    """Padding mask AND the banded context window, OR the diagonal: every
    position may attend to itself, so a padded query never sees an
    all-masked row (``llm_bci_tpu/ops/attention.py:89-106``)."""
    B, T = spikes_mask.shape
    mask = spikes_mask.bool()[:, None, :]                       # (B, 1, T) keys
    if context_mask is not None:
        mask = mask & context_mask.bool()[None, :, :]
    else:
        mask = mask.expand(B, T, T)
    eye = torch.eye(T, dtype=torch.bool, device=spikes_mask.device)
    return (mask | eye[None, :, :])[:, None, :, :]
