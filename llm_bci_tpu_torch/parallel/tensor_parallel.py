"""Megatron tensor parallelism of the Llama decoder on plain local shards.

:func:`apply_tp_plan` cuts each rank's share out of a built (and loaded)
``LlamaForCausalLM`` by the plan of ``parallel/mesh.py`` (``TP_COLUMN``,
``TP_ROW``, ``tp_layout``):

* column-parallel q / k / v / gate / up keep their rank's output features
  (whole heads, an equal share of the MLP): ``weight`` rows, or the int8
  ``kernel``'s columns with their ``kernel_scale``; their input passes
  :func:`copy_to_tp` (identity forward, gradient summed over ``tp``);
* row-parallel o / down keep the matching input features; their partial
  products (the base and the LoRA delta) are summed by :func:`reduce_from_tp`
  (all-reduce forward, identity backward), then the bias is added;
* LoRA factors, norms, embeddings and ``lm_head`` stay whole. A split
  projection uses its rank's slice of its LoRA ``B`` (column) or ``A`` (row);
  each factor passes :func:`sum_grad_over_tp`, so its gradient is summed over
  ``tp`` and every rank holds the same whole factor after the update.

No DTensor: the int8, flash and CTC kernels (``torch.library`` custom ops)
see the plain tensors of their rank, and a decode's token step with its
all-reduces stays one CUDA graph under NCCL, whose collectives can be
captured (gloo's cannot: the CPU path runs eager, as it does without a
group). The collectives are ``torch.autograd.Function`` s of their own:
``torch.distributed.nn.functional.all_reduce`` also all-reduces the
gradient, which is right when every rank's loss counts apart and wrong for
the one replicated loss here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from llm_bci_tpu_torch.parallel.mesh import TP_COLUMN, TP_ROW, check_tp_heads, split_range


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product: the same tensor forward, the
    gradient summed over the ``tp`` ranks backward."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ``tp`` ranks of a row-parallel product's partial
    output; the gradient passes unchanged (every rank's is the whole one)."""
    return _ReduceFromTP.apply(x, group)


# A replicated parameter used through a slice (or on a partial input) gets a
# partial gradient on each rank; summing it makes the whole one, the same
# on every rank. Forward it is the identity, as copy_to_tp.
sum_grad_over_tp = copy_to_tp


class TPShard:
    """What a split projection keeps of the plan: its role, the ``tp``
    group and the ``[start, stop)`` of the features it holds (output features
    for ``column``, input features for ``row``)."""

    def __init__(self, role: str, group, start: int, stop: int):
        self.role, self.group, self.start, self.stop = role, group, start, stop


def _keep(t: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    return t.narrow(dim, start, stop - start).contiguous()


def shard_dense(dense, role: str, group, rank: int, size: int) -> None:
    """Cut ``dense`` (a ``LoRADense``) to rank ``rank``'s share of ``size``."""
    n = dense.features if role == "column" else dense.in_features
    start, stop = split_range(n, size, rank)
    if dense.quant is not None:
        dense.kernel = _keep(dense.kernel, 1 if role == "column" else 0, start, stop)
        if role == "column":
            dense.kernel_scale = _keep(dense.kernel_scale, 0, start, stop)
    else:
        w = dense.weight
        dense.weight = torch.nn.Parameter(
            _keep(w.detach(), 0 if role == "column" else 1, start, stop),
            requires_grad=w.requires_grad)
    if dense.bias is not None and role == "column":
        b = dense.bias
        dense.bias = torch.nn.Parameter(_keep(b.detach(), 0, start, stop),
                                        requires_grad=b.requires_grad)
    dense.tp = TPShard(role, group, start, stop)


def apply_tp_plan(llm, group) -> None:
    """Split ``llm`` (a ``LlamaForCausalLM`` with its weights loaded) over the
    ranks of ``group`` in place. Every rank must hold the same weights
    before. A group of one rank keeps every weight whole and still runs the
    plan's collectives."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    cfg = llm.config
    check_tp_heads(cfg.num_attention_heads, cfg.n_kv, cfg.intermediate_size, size)
    for layer in llm.model.layers:
        attn, mlp = layer.self_attn, layer.mlp
        for role, names in (("column", TP_COLUMN), ("row", TP_ROW)):
            for name in names:
                owner = attn if hasattr(attn, name) else mlp
                shard_dense(getattr(owner, name), role, group, rank, size)
        attn.n_heads = cfg.num_attention_heads // size
        attn.n_kv = cfg.n_kv // size
        attn.tp_group = mlp.tp_group = group
