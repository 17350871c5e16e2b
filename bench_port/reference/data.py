"""The reference's batches, rebuilt from the raw trials: what the timed path
trains on, padded as the configuration says (zeros on its side, to the
longest trial of the dataset), with a valid-bin mask, per-bin timestamps,
lengths and, for CTC, the phoneme targets padded with 0 to the longest
target. Imports nothing of the port."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def pad_widths(splits: Dict[str, List[dict]]) -> Dict[str, int]:
    """The padded lengths: the longest trial and the longest target over
    every split."""
    rows = [row for split in splits.values() for row in split]
    out = {"bins": max(len(row["spikes"]) for row in rows)}
    if "phonemes_idx" in rows[0]:
        out["targets"] = max(len(row["phonemes_idx"]) for row in rows)
    return out


def _pad(x: np.ndarray, length: int, side: str) -> np.ndarray:
    grow = length - x.shape[0]
    width = [(grow, 0) if side == "left" else (0, grow)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, width)


def batch(rows: Sequence[dict], widths: Dict[str, int], side: str, device) -> Dict[str, torch.Tensor]:
    """The batch of ``rows`` (raw trials) as tensors on ``device``."""
    T = widths["bins"]
    spikes = np.stack([_pad(np.asarray(r["spikes"], np.float32), T, side) for r in rows])
    n = [len(r["spikes"]) for r in rows]
    mask = np.stack([_pad(np.ones(k, np.int64), T, side) for k in n])
    stamps = np.stack([_pad(np.arange(k, dtype=np.int64), T, side) for k in n])
    out = {"spikes": spikes, "spikes_mask": mask, "spikes_timestamp": stamps,
           "spikes_lengths": np.asarray(n, np.int64)}
    if "targets" in widths:
        S = widths["targets"]
        t = [np.asarray(r["phonemes_idx"], np.int64) for r in rows]
        out["targets"] = np.stack([_pad(x, S, "right") for x in t])
        out["targets_lengths"] = np.asarray([len(x) for x in t], np.int64)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
