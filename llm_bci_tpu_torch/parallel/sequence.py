"""Sequence parallelism: a rank's part of the time axis and the collectives
over the ``sp`` group (the port's side of the JAX package's
``sequence_sharding`` and of the K/V all-gathers that GSPMD inserts).

Every rank of an ``sp`` group holds the same rows. The model says what a
rank computes of a sequence (:class:`SequenceShard`, made by the model's
``sequence_layout``): its tokens (bins, or stacked frames), the bins its
first layers compute, and the range of each time-dim batch key that it
reads from the host batch, halo included. The trainer slices the host batch
by those ranges and hands the shard to the model's forward (``seq_shard``).

Collectives (:func:`gather_time`): an all-gather of the ranks' parts of a
time axis in rank order, the parts' lengths allowed to differ by one (121
frames over 2 ranks: 61 and 60). Its backward either sums the whole axis's
gradient over the group and keeps the rank's part (K and V: every rank's
queries read every rank's keys) or only keeps the rank's part (a value that
every rank then uses the same way, as the CTC loss on the gathered
log-probs: each rank holds the same gradient, and summing it would count it
``sp`` times). A half-precision tensor travels as its bytes and a bool as
uint8, dtypes that gloo (which stages a CUDA tensor through the host, and
has no 16-bit integer) gathers on the CPU and on the card; gradients are
summed in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from llm_bci_tpu_torch.ops.attention import TimeSlice

SP_KEYS = ("spikes", "spikes_mask", "spikes_timestamp")


@dataclasses.dataclass(frozen=True)
class SequenceShard:
    """What rank ``index`` of ``n_sp`` computes of a sequence of ``bins``
    bins: the tokens ``bounds[index]:bounds[index + 1]`` of the
    ``tokens`` the trunk runs on (``real_tokens`` of them before the
    padding frames of ``stack.pad_to_multiple``), the bins ``computed`` that
    its first layers produce, and ``slices``, the range of each time-dim
    batch key it reads. ``group`` is the ``sp`` process group (``None`` in
    a pure function's test, where nothing is gathered)."""

    n_sp: int
    index: int
    bins: int
    tokens: int
    real_tokens: int
    bounds: Tuple[int, ...]
    computed: Tuple[int, int]
    slices: Dict[str, Tuple[int, int]]
    group: Optional[object] = None

    @property
    def token_range(self) -> Tuple[int, int]:
        return self.bounds[self.index], self.bounds[self.index + 1]

    @property
    def token_time(self) -> TimeSlice:
        """The rank's tokens as a part of the token axis (dropout draws)."""
        return TimeSlice(self.tokens, self.bounds[self.index])

    @property
    def bin_time(self) -> TimeSlice:
        """The bins the rank computes as a part of the bin axis (noise and
        masker draws)."""
        return TimeSlice(self.bins, self.computed[0])

    def with_group(self, group) -> "SequenceShard":
        return dataclasses.replace(self, group=group)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over the group (a 0-dim tensor); the ranks'
        computed bins together cover the sequence."""
        t = t.detach().float().reshape(1).clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t[0]


def _wire(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` in a dtype that every backend gathers: a bool as uint8, a
    half-precision tensor as its bytes (uint8, the last dim twice as long;
    float32 when the gather runs along the last dim)."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8) if dim != t.dim() - 1 else t.float()
    return t


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return t.bool()
    if dtype in (torch.bfloat16, torch.float16):
        return t.view(dtype) if t.dtype == torch.uint8 else t.to(dtype)
    return t


def all_gather_time(x: torch.Tensor, shard: SequenceShard, dim: int = 1) -> torch.Tensor:
    """The whole axis ``dim`` from every rank's part (no autograd): each part
    padded to the longest, gathered, and cut back to its length."""
    sizes = [shard.bounds[r + 1] - shard.bounds[r] for r in range(shard.n_sp)]
    if x.shape[dim] != sizes[shard.index]:
        raise ValueError(f"gather_time: the rank's part has {x.shape[dim]} steps on dim {dim}, "
                         f"its shard {sizes[shard.index]}")
    longest = max(sizes)
    dim = dim % x.dim()
    wire = _wire(x.contiguous(), dim)
    if wire.shape[dim] < longest:
        pad = list(wire.shape)
        pad[dim] = longest - wire.shape[dim]
        wire = torch.cat([wire, wire.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(wire) for _ in range(shard.n_sp)]
    dist.all_gather(parts, wire.contiguous(), group=shard.group)
    whole = torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim=dim)
    return _unwire(whole, x.dtype)


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim, sum_grads):
        ctx.shard, ctx.dim, ctx.sum_grads = shard, dim, sum_grads
        return all_gather_time(x, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        if ctx.sum_grads:
            total = grad.float().contiguous()
            dist.all_reduce(total, group=shard.group)
            grad = total.to(grad.dtype)
        start, stop = shard.token_range
        return grad.narrow(ctx.dim, start, stop - start).contiguous(), None, None, None


def gather_time(x: torch.Tensor, shard: SequenceShard, dim: int = 1,
                sum_grads: bool = True) -> torch.Tensor:
    """The whole token axis ``dim`` of ``x`` gathered over the ``sp`` group;
    the backward hands the rank its part of the gradient, summed over the
    group (``sum_grads``) or as it is."""
    return _GatherTime.apply(x, shard, dim, sum_grads)


def whole_sequence_outputs(outputs: Dict, shard: SequenceShard, time_keys: Sequence[str],
                           summed: bool, gather: bool) -> Dict:
    """A step's outputs over the whole sequence: with ``summed`` the 0-dim
    tensors (``loss``, ``n_examples``: each rank's sum over its tokens) are
    summed over the group, else every rank holds them whole already; with
    ``gather`` each of ``time_keys`` is gathered along dim 1."""
    out = dict(outputs)
    for k, v in outputs.items():
        if not torch.is_tensor(v):
            continue
        if v.dim() == 0 and summed:
            total = v.detach().clone()
            dist.all_reduce(total, group=shard.group)
            out[k] = total
        elif gather and k in time_keys and v.dim() >= 2:
            out[k] = all_gather_time(v.detach(), shard)
    return out
