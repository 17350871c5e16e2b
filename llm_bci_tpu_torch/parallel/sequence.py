"""Sequence parallelism: a rank's part of the time axis and the collectives
over the ``sp`` group (the port's side of the JAX package's
``sequence_sharding`` and of the collectives that GSPMD inserts).

Every rank of an ``sp`` group holds the same rows. The model says what a
rank computes of a sequence (:class:`SequenceShard`, made by the model's
``sequence_layout``): its tokens (bins, stacked frames or patches), the bins
its first layers compute, and the range of each time-dim batch key that it
reads from the host batch, halo included. Tokens that come before the time
axis (NDT1's day and block tokens, the univariate transformer's CLS) are the
``prefix`` of shard 0. The trainer slices the host batch by those ranges and
hands the shard to the model's forward (``seq_shard``).

Collectives, each turning the ranks' parts into a whole:

* :func:`gather_time`: an all-gather of the parts of a time axis in rank
  order, the parts' lengths allowed to differ by one (121 frames over 2
  ranks: 61 and 60);
* :func:`row_parallel_linear`: a Linear over the time axis from the ranks'
  partial products, summed over the group;
* :func:`synced_mean_var`: a mean and a biased variance over the ranks'
  elements (count, sum and sum of squared deviations summed over the group),
  and :func:`synced_batch_norm`, BatchNorm's training pass on them;
* :func:`broadcast_first`: shard 0's value (a prefix token's output) on
  every rank.

The gradient rule: the backward of each sums the whole's gradient over the
group (the gather keeps the rank's part, the broadcast gives it to shard 0
only). The trainer scales the loss by ``sp`` where a rank's loss is its part
of the whole (``sequence_outputs``), and leaves it as it is where every rank
holds the whole loss; after FSDP2's average over ``data x sp`` every
parameter's gradient is one process's either way. A parameter that only
shard 0 reads is kept in the other ranks' graphs with a zero gradient
(:func:`keep_in_graph`), as FSDP2's reduce needs the same gradients on every
rank. A half-precision tensor travels as its bytes and a bool as uint8,
dtypes that gloo (which stages a CUDA tensor through the host, and has no
16-bit integer) moves on the CPU and on the card; sums run in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from llm_bci_tpu_torch.ops.attention import TimeSlice

SP_KEYS = ("spikes", "spikes_mask", "spikes_timestamp")


@dataclasses.dataclass(frozen=True)
class SequenceShard:
    """What rank ``index`` of ``n_sp`` computes of a sequence of ``bins``
    bins: the tokens ``bounds[index]:bounds[index + 1]`` of the
    ``tokens`` the trunk runs on (``real_tokens`` of them before the
    padding frames of ``stack.pad_to_multiple``), the bins ``computed`` that
    its first layers produce, and ``slices``, the range of each time-dim
    batch key it reads. The first ``prefix`` tokens come before the time
    axis and are shard 0's (``tokens``, ``real_tokens`` and ``bounds``
    count them; :meth:`body` is the shard without them). ``group`` is the
    ``sp`` process group (``None`` in a pure function's test, where nothing
    is gathered)."""

    n_sp: int
    index: int
    bins: int
    tokens: int
    real_tokens: int
    bounds: Tuple[int, ...]
    computed: Tuple[int, int]
    slices: Dict[str, Tuple[int, int]]
    group: Optional[object] = None
    prefix: int = 0

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

    @property
    def local_prefix(self) -> int:
        """Prefix tokens this rank holds (shard 0: all of them)."""
        return self.prefix if self.index == 0 else 0

    def body(self) -> "SequenceShard":
        """The shard of the time axis alone, the prefix tokens dropped."""
        if not self.prefix:
            return self
        p = self.prefix
        return dataclasses.replace(self, prefix=0, tokens=self.tokens - p,
                                   real_tokens=self.real_tokens - p,
                                   bounds=(0,) + tuple(b - p for b in self.bounds[1:]))

    def with_prefix(self, prefix: int) -> "SequenceShard":
        """The shard with ``prefix`` tokens before the time axis."""
        return dataclasses.replace(self, prefix=prefix, tokens=self.tokens + prefix,
                                   real_tokens=self.real_tokens + prefix,
                                   bounds=(0,) + tuple(b + prefix for b in self.bounds[1:]))

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


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, reduced in float32 (no autograd)."""
    total = t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(total, group=group)
    return total.to(t.dtype)


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return all_gather_time(x, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.shard.token_range
        grad = all_reduce_sum(grad, ctx.shard.group)
        return grad.narrow(ctx.dim, start, stop - start).contiguous(), None, None


def gather_time(x: torch.Tensor, shard: SequenceShard, dim: int = 1) -> torch.Tensor:
    """The whole token axis ``dim`` of ``x`` gathered over the ``sp`` group;
    the backward hands the rank its part of the gradient summed over the
    group."""
    return _GatherTime.apply(x, shard, dim)


class _RowParallelLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, group, dtype):
        if dtype is not None:
            x, weight = x.to(dtype), weight.to(dtype)
            bias = None if bias is None else bias.to(dtype)
        ctx.save_for_backward(x, weight)
        ctx.group, ctx.has_bias = group, bias is not None
        y = all_reduce_sum(F.linear(x.float(), weight.float()), group)
        if bias is not None:
            y = y + bias.float()
        return y if dtype is None else y.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        # the sum's backward: the group's gradients summed; then the product's
        # in the operands' dtype, as one device's backward GEMMs
        dsum = all_reduce_sum(dy, ctx.group).to(x.dtype)
        dx = dsum @ weight if ctx.needs_input_grad[0] else None
        dw = dsum.reshape(-1, dsum.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        db = dy.reshape(-1, dy.shape[-1]).float().sum(0).to(x.dtype) if ctx.has_bias else None
        return dx, dw, db, None, None


def row_parallel_linear(x: torch.Tensor, layer: torch.nn.Linear, shard: SequenceShard,
                        start: int, stop: int) -> torch.Tensor:
    """``layer(whole_x)`` from the rank's part ``x`` of its input features
    (``start:stop`` of them, its bins): the rank's columns of the weight,
    their products summed over the group, the bias added once. Under
    autocast the operands are rounded to its dtype, the partial products
    summed in float32 and the result rounded once, as one device's GEMM
    accumulates; the backward's products run in that dtype, as one
    device's do."""
    dev = x.device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else None
    with torch.autocast(dev, enabled=False):
        return _RowParallelLinear.apply(x, layer.weight[:, start:stop], layer.bias, shard.group,
                                        dtype)


@torch.no_grad()
def synced_mean_var(x: torch.Tensor, dims: Tuple[int, ...], group
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mean, biased variance and count of ``x`` over ``dims`` and over the
    ranks of ``group``, whose elements together are the whole: the count and
    sum, then the sum of squared deviations, summed over the group (two
    passes, as one device computes them); no gradient flows through them
    (:func:`synced_batch_norm` takes BatchNorm's through its own)."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    count = all_reduce_sum(torch.tensor(float(n), device=x.device), group)
    mean = all_reduce_sum(x.sum(dim=dims, keepdim=True), group) / count
    var = all_reduce_sum(((x - mean) ** 2).sum(dim=dims, keepdim=True), group) / count
    return mean, var, count


class _SyncedBatchNorm(torch.autograd.Function):
    """BatchNorm's training forward over rows ``x`` (N, C) that, with the
    other ranks' of ``group``, make up the batch: the statistics summed over
    the group, the input and its statistics saved (as ``F.batch_norm``
    saves them), the backward's two row sums summed over the group, as
    ``torch.nn.SyncBatchNorm`` computes them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        mean, var, ctx.count = synced_mean_var(x, (0,), group)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.group = group
        mean_out, var_out = mean[0], var[0]
        ctx.mark_non_differentiable(mean_out, var_out)
        return (x - mean) * invstd * weight + bias, mean_out, var_out

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, invstd, weight = ctx.saved_tensors
        xhat = (x - mean) * invstd
        dbias, dweight = dy.sum(0), (dy * xhat).sum(0)
        sum_dy = all_reduce_sum(dbias, ctx.group) / ctx.count
        sum_dy_xhat = all_reduce_sum(dweight, ctx.group) / ctx.count
        dx = (dy - sum_dy - xhat * sum_dy_xhat) * (invstd * weight)
        return dx, dweight, dbias, None, None


def synced_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                      group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm in training over the rows ``x`` (N, C) of every rank of
    ``group``: ``(out, the batch mean, its biased variance)``. The gradient
    of ``weight`` and ``bias`` is the rank's rows' part."""
    return _SyncedBatchNorm.apply(x, weight, bias, eps, group)


class _BroadcastFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        wire = _wire(x.contiguous(), 0).clone()
        dist.broadcast(wire, src=dist.get_global_rank(shard.group, 0), group=shard.group)
        return _unwire(wire, x.dtype)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_sum(grad, ctx.shard.group)
        return (total if ctx.shard.index == 0 else torch.zeros_like(grad)), None


def broadcast_first(x: torch.Tensor, shard: SequenceShard) -> torch.Tensor:
    """Shard 0's ``x`` on every rank of the group (every rank hands in a
    tensor of that shape; only shard 0's is read). The backward gives shard
    0 the gradient summed over the group and the others zeros."""
    return _BroadcastFirst.apply(x, shard)


def keep_in_graph(x: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
    """``x``, made to depend on ``tensors`` with a zero gradient: a rank
    that does not read a parameter (a prefix token on shard 1 and up) still
    gives it a gradient, as FSDP2's reduce over the ranks needs."""
    for t in tensors:
        x = x + 0.0 * t.sum().to(x.dtype)
    return x


def whole_sequence_outputs(outputs: Dict, shard: SequenceShard, time_dims: Mapping[str, int],
                           summed: bool, gather: bool) -> Dict:
    """A step's outputs over the whole sequence: with ``summed`` the 0-dim
    tensors (``loss``, ``n_examples``: each rank's sum over its tokens) are
    summed over the group, else every rank holds them whole already; with
    ``gather`` each key of ``time_dims`` is gathered along its time dim (the
    time axis alone: no prefix token reaches an output)."""
    out = dict(outputs)
    body = shard.body()
    for k, v in outputs.items():
        if not torch.is_tensor(v):
            continue
        if v.dim() == 0 and summed:
            total = v.detach().clone()
            dist.all_reduce(total, group=shard.group)
            out[k] = total
        elif gather and k in time_dims and v.dim() > time_dims[k]:
            out[k] = all_gather_time(v.detach(), body, time_dims[k])
    return out
