"""Banded context (attention-window) masks.

Re-implemented rather than imported: ``llm_bci_tpu/ops/context.py`` is
pure numpy, but importing it runs ``llm_bci_tpu/ops/__init__.py``, which
loads the JAX kernels. Semantics are those of
``llm_bci_tpu/ops/context.py:13``: ``mask[i, j] = 1`` iff key ``j`` lies in
``[i - backward, i + forward]``; ``-1`` masks the self-offset in that
direction, ``-2`` means unbounded.
"""
from __future__ import annotations

import numpy as np


def create_context_mask(context_forward: int, context_backward: int, max_F: int) -> np.ndarray:
    if context_forward == -2 and context_backward == -2:
        return np.ones((max_F, max_F), dtype=np.int64)
    fwd = context_forward if context_forward >= -1 else max_F
    i = np.arange(max_F)[:, None]
    j = np.arange(max_F)[None, :]
    mask = (j <= i + fwd).astype(np.int64)
    if context_backward >= -1:
        mask &= (j >= i - context_backward).astype(np.int64)
    return mask
