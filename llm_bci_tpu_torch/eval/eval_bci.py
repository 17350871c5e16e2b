# Mirrors llm_bci_tpu/eval/eval_bci.py (host code that imports no JAX): the port keeps its own copy.
"""WER/CER utilities + greedy CTC collapse (host-side, eval-only).

Reimplements the reference ``utils/eval_bci.py:11-64``. The reference leans
on the ``editdistance`` C++ extension; this is eval-path code far off the hot
loop, so a vectorized numpy Levenshtein is plenty (SURVEY.md §2.6).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np


def edit_distance(source: Sequence, target: Sequence) -> int:
    """Levenshtein distance between two token sequences.

    Uses the C kernel in :mod:`llm_bci_tpu_torch.native` when it builds (the
    equivalent of the reference's ``editdistance`` C++ ext), else a numpy
    DP fallback."""
    from llm_bci_tpu_torch.native import edit_distance_native

    native = edit_distance_native(source, target)
    if native is not None:
        return native
    m, n = len(source), len(target)
    if m == 0:
        return n
    if n == 0:
        return m
    # target tokens as an array for vectorized compare per source token
    prev = np.arange(n + 1)
    tgt = np.asarray(list(target), dtype=object)
    for i, s_tok in enumerate(source, start=1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (tgt != s_tok)
        # deletion from prev row is vectorizable; insertion needs the scan
        np.minimum(sub, prev[1:] + 1, out=sub)
        running = cur[0]
        for j in range(1, n + 1):
            running = min(sub[j - 1], running + 1)
            cur[j] = running
        prev = cur
    return int(prev[n])


def word_edit_distance(source: str, target: str) -> Tuple[int, int]:
    """(errors, n_target_words) between two sentences
    (reference ``utils/eval_bci.py:11-14``)."""
    s = source.split(" ")
    t = target.split(" ")
    return edit_distance(s, t), len(t)


def word_error_count(
    preds: Union[str, List[str]], targets: Union[str, List[str]]
) -> Tuple[int, int]:
    """Accumulate (errors, words) over paired lists so several calls can be
    averaged exactly (reference ``utils/eval_bci.py:19-36``)."""
    if not isinstance(preds, list):
        preds = [preds]
    if not isinstance(targets, list):
        targets = [targets]
    assert len(preds) == len(targets), "Lengths of prediction and target lists don't match"
    errors = 0
    words = 0
    for pred, target in zip(preds, targets):
        e, w = word_edit_distance(pred, target)
        errors += e
        words += w
    return errors, words


def format_ctc(pred: Sequence[int], vocab: List[str], blank_id: int) -> List[str]:
    """Greedy CTC collapse: drop repeats and blanks, map to vocab strings
    (reference ``utils/eval_bci.py:41-48``)."""
    phonemes = []
    last = -1
    for idx in pred:
        idx = int(idx)
        if idx != last and idx != blank_id:
            phonemes.append(vocab[idx])
        last = idx
    return phonemes


def smoothed_RMS(
    preds: np.ndarray,        # (B, T, N)
    features: np.ndarray,     # (B, T, N) raw spikes
    targets_mask: np.ndarray, # broadcastable to preds
    width: int,
) -> Tuple[float, float]:
    """MSE of predicted rates vs boxcar-smoothed spikes
    (reference ``utils/eval_bci.py:53-64``). Returns (masked_sum, total_sum)."""
    kernel = np.ones(width) / width
    pad_lo = (width - 1) // 2
    pad_hi = width - 1 - pad_lo
    f = np.pad(np.asarray(features, dtype=np.float64), ((0, 0), (pad_lo, pad_hi), (0, 0)))
    # correlate along time for every (batch, channel)
    T = preds.shape[1]
    targets = np.stack(
        [np.sum(f[:, t : t + width, :] * kernel[None, :, None], axis=1) for t in range(T)],
        axis=1,
    )
    mse = (np.asarray(preds, dtype=np.float64) - targets) ** 2
    return float((mse * targets_mask).sum()), float(mse.sum())
