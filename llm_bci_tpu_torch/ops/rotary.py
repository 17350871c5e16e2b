"""Rotary position embeddings, Llama convention (counterpart of
``llm_bci_tpu/ops/rotary.py``). The cos / sin tables are numpy, computed in
float64 once per maximum length."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_cos_sin(dim: int, max_len: int, base: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)                       # (max_len, dim//2)
    emb = np.concatenate([freqs, freqs], axis=-1)       # (max_len, dim)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(
    q: torch.Tensor,          # (B, H, T, D)
    k: torch.Tensor,          # (B, H, T, D)
    pos_ids: torch.Tensor,    # (B, T) int positions
    cos: torch.Tensor,        # (max_len, D)
    sin: torch.Tensor,        # (max_len, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    c = cos[pos_ids][:, None, :, :].to(q.dtype)   # (B, 1, T, D)
    s = sin[pos_ids][:, None, :, :].to(q.dtype)
    return q * c + _rotate_half(q) * s, k * c + _rotate_half(k) * s
