"""Gaussian temporal smoothing of spike trains
(counterpart of ``llm_bci_tpu/ops/smoothing.py``).

One normalized gaussian window correlated along the time axis of every
channel: a depthwise ``conv1d`` with 'same' padding, asymmetric for an even
window (``pad_lo = (W - 1) // 2``). Always float32, autocast off. A time
shard of a sequence (sequence parallelism) is smoothed from its bins and
the halo of ``pad_lo`` bins before it and ``pad_hi`` after it that its
neighbours own, with zeros only where the halo passes the sequence's ends:
the shard's result is then the whole sequence's, sliced.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(smooth_sd: float) -> np.ndarray:
    """Normalized gaussian window of width ``1 + 6*sd``."""
    width = int(1 + 6 * smooth_sd)
    n = np.arange(width, dtype=np.float64) - (width - 1) / 2.0
    k = np.exp(-0.5 * (n / smooth_sd) ** 2)
    return (k / k.sum()).astype(np.float32)


def smoothing_pads(width: int) -> Tuple[int, int]:
    """``(pad_lo, pad_hi)`` of a window of ``width`` bins: the bins before and
    after a bin that its smoothed value reads."""
    pad_lo = (width - 1) // 2
    return pad_lo, width - 1 - pad_lo


def smooth_spikes(spikes: torch.Tensor, kernel: torch.Tensor,
                  pads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Correlate ``spikes (B, T, N)`` with ``kernel (W,)`` along T, zero-padded
    by :func:`smoothing_pads` (T bins out), or by ``pads`` where the input
    already holds some halo bins (``T + sum(pads) - W + 1`` bins out)."""
    B, T, N = spikes.shape
    W = kernel.shape[0]
    pad_lo, pad_hi = smoothing_pads(W) if pads is None else pads
    with torch.autocast(spikes.device.type, enabled=False):
        x = F.pad(spikes.float().transpose(1, 2), (pad_lo, pad_hi))   # (B, N, T+W-1)
        weight = kernel.float().to(spikes.device).view(1, 1, W).expand(N, 1, W)
        out = F.conv1d(x, weight, groups=N)                           # (B, N, T)
    return out.transpose(1, 2).to(spikes.dtype)
