"""Gaussian temporal smoothing of spike trains
(counterpart of ``llm_bci_tpu/ops/smoothing.py``).

One normalized gaussian window correlated along the time axis of every
channel: a depthwise ``conv1d`` with 'same' padding, asymmetric for an even
window (``pad_lo = (W - 1) // 2``). Always float32, autocast off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(smooth_sd: float) -> np.ndarray:
    """Normalized gaussian window of width ``1 + 6*sd``."""
    width = int(1 + 6 * smooth_sd)
    n = np.arange(width, dtype=np.float64) - (width - 1) / 2.0
    k = np.exp(-0.5 * (n / smooth_sd) ** 2)
    return (k / k.sum()).astype(np.float32)


def smooth_spikes(spikes: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Correlate ``spikes (B, T, N)`` with ``kernel (W,)`` along T."""
    B, T, N = spikes.shape
    W = kernel.shape[0]
    pad_lo = (W - 1) // 2
    pad_hi = W - 1 - pad_lo
    with torch.autocast(spikes.device.type, enabled=False):
        x = F.pad(spikes.float().transpose(1, 2), (pad_lo, pad_hi))   # (B, N, T+W-1)
        weight = kernel.float().to(spikes.device).view(1, 1, W).expand(N, 1, W)
        out = F.conv1d(x, weight, groups=N)                           # (B, N, T)
    return out.transpose(1, 2).to(spikes.dtype)
