"""The yardstick's arithmetic: the published peaks of one H100, the least
time a piece of work can take on it, and the operations and bytes that
kernels need, counted from the shapes alone (the kernel that does the work
does not change the count). A model's step operations are its reference
module's (``reference/<model>.py``, ``step_flops_per_sample``).
"""
from __future__ import annotations

from typing import Sequence

# Published dense peaks of one H100 SXM (NVIDIA's data sheet; 700 W):
# operations a second by input type, and bytes a second of device memory.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    return max(ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES)


def ctc_fused_bound_s(batch: int, frames: int, vocab: int, target_width: int) -> float:
    """The CTC loss with its gradient of one batch: the log-probs read and
    their gradient written (float32), the targets (int32) and the lengths
    read, the losses written; the alpha and beta recursions' log-sum-exps
    (about 6 operations an extended label a frame each) at the float32
    rate."""
    extended = 2 * target_width + 1
    nbytes = 2 * batch * frames * vocab * 4 + batch * target_width * 4 + batch * 3 * 4
    ops = 2 * 6.0 * batch * frames * extended
    return bound_s(ops, nbytes, "float32")


def flash_bound_s(key_lengths: Sequence[int], queries: int, heads: int, head_dim: int,
                  layers: int, elem_bytes: int = 2) -> float:
    """Banded attention (unbounded band) forward and backward of one batch
    over ``layers`` layers: every query against the valid keys of its row,
    4 T L D operations a head forward and 10 backward (scores recomputed,
    dP, dV, dQ, dK); bytes: Q, K, V, O, dO, dQ, dK, dV once each in
    ``elem_bytes``, the row statistics (lse, delta) in float32."""
    T, Dh = queries, head_dim
    ops = sum(14.0 * heads * T * int(n) * Dh for n in key_lengths)
    B = len(key_lengths)
    nbytes = 8 * B * T * heads * Dh * elem_bytes + 4 * B * heads * T * 4
    return layers * bound_s(ops, nbytes, "bfloat16")
