"""The trainer's multi-device plan: applying it to a model, reducing a step's
outputs over the ``data`` ranks, and the full state of a planned model for a
checkpoint in the single-device format and back (the port's side of the JAX
trainer's sharded ``TrainState`` and Orbax's distributed save).

A tensor of a planned model has two layers of sharding: tensor parallelism
splits some Llama tensors over ``tp`` along one dim (``Plan.tp_dims``, by
``state_dict`` name), and FSDP2 turns parameters into ``DTensor`` s sharded
over ``fsdp``. :func:`full_tensor` undoes both (a collective: every rank
calls it for the same tensors in the same order); :func:`tp_share` and
``distribute_tensor`` redo them from a whole tensor that every rank holds.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from llm_bci_tpu_torch.parallel.mesh import TP_DIMS, fsdp_groups, fsdp_mesh, split_range
from llm_bci_tpu_torch.parallel.tensor_parallel import apply_tp_plan


class Plan:
    """What the plan did to a model: ``tp_dims`` (state_dict name -> the dim
    split over ``tp``), the ``tp`` and ``fsdp`` groups, this rank's place in
    ``tp`` and the 2-D mesh FSDP2 shards over (``dp_mesh``, whose first dim's
    group holds the ranks of the global batch's rows and time parts). The
    empty plan (one device) has no groups."""

    def __init__(self, tp_dims: Optional[Dict[str, int]] = None, tp_group=None,
                 fsdp_group=None, dp_mesh=None):
        self.tp_dims = tp_dims or {}
        self.tp_group, self.fsdp_group, self.dp_mesh = tp_group, fsdp_group, dp_mesh
        self.tp_size = dist.get_world_size(tp_group) if tp_group is not None else 1
        self.tp_rank = dist.get_rank(tp_group) if tp_group is not None else 0


def apply_plan(model: torch.nn.Module, mesh, fsdp_min_size: int) -> Plan:
    """Cut every Llama decoder of ``model`` to this rank's ``tp`` share,
    then ``fully_shard`` the modules of :func:`fsdp_groups` and the root over
    the ``(data, fsdp)`` sub-mesh (``(data x sp, fsdp)`` with ``sp > 1``,
    ``parallel/mesh.py::fsdp_mesh``). With ``fsdp == 1`` nothing is sharded (the
    JAX rule shards no leaf then either), so the groups keep their whole
    parameters from forward to backward instead of gathering them twice.
    When no module reaches ``fsdp_min_size`` the root's group holds every
    parameter; its backward is hooked on the tensors of the model's output,
    which FSDP2 finds because ``ModelOutput`` is a pytree node
    (``model_output.py``). Raises when ``tp > 1`` and the model has no Llama
    decoder to split."""
    from torch.distributed.fsdp import fully_shard

    from llm_bci_tpu_torch.models.llama import LlamaForCausalLM

    tp_group = mesh["tp"].get_group()
    llms = [m for m in model.modules() if isinstance(m, LlamaForCausalLM)]
    if mesh["tp"].size() > 1 and not llms:
        raise ValueError(f"parallelism.tp={mesh['tp'].size()} needs a model with a Llama "
                         f"decoder (BCI, PhonemeLLM); {type(model).__name__} has none")
    for llm in llms:
        apply_tp_plan(llm, tp_group)
    tp_dims = {}
    names = set(model.state_dict())
    for prefix, module in model.named_modules():
        shard = getattr(module, "tp", None)
        if shard is None:
            continue
        for leaf, dim in TP_DIMS[shard.role].items():
            name = f"{prefix}.{leaf}"
            if name in names:
                tp_dims[name] = dim
    dp_mesh = fsdp_mesh(mesh)
    reshard = mesh["fsdp"].size() > 1
    for name in fsdp_groups(model, fsdp_min_size):
        module = model.get_submodule(name)
        if hasattr(module, "copy_deferred"):      # a LoRADense: see its forward
            module.copy_deferred = True
        fully_shard(module, mesh=dp_mesh, reshard_after_forward=reshard)
    fully_shard(model, mesh=dp_mesh, reshard_after_forward=reshard)
    return Plan(tp_dims, tp_group, mesh["fsdp"].get_group(), dp_mesh)


def global_outputs(outputs: Dict[str, Any], group, gather: bool) -> Dict[str, Any]:
    """``outputs`` of a rank's rows over the global batch: every 0-dim tensor
    summed over ``group`` (``loss``, ``n_examples``), and with ``gather``
    every tensor whose first dim is the rank's rows concatenated in rank
    order; other entries pass."""
    rows = None
    for v in outputs.values():
        if torch.is_tensor(v) and v.dim() > 0:
            rows = v.shape[0]
            break
    world = dist.get_world_size(group)
    out = {}
    for k, v in outputs.items():
        if not torch.is_tensor(v):
            out[k] = v
        elif v.dim() == 0:
            total = v.detach().clone()
            dist.all_reduce(total, group=group)
            out[k] = total
        elif gather and v.shape[0] == rows:
            t = v.detach().contiguous()
            wire = t.to(torch.uint8) if t.dtype == torch.bool else t
            parts = [torch.empty_like(wire) for _ in range(world)]
            dist.all_gather(parts, wire, group=group)
            out[k] = torch.cat(parts).to(t.dtype)
        else:
            out[k] = v
    return out


def full_tensor(t: torch.Tensor, tp_dim: Optional[int], plan: Plan) -> torch.Tensor:
    """The whole tensor on every rank: the FSDP2 shards gathered, then the
    ``tp`` shares along ``tp_dim``. A collective."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach()
    if tp_dim is not None and plan.tp_size > 1:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(plan.tp_size)]
        dist.all_gather(parts, t, group=plan.tp_group)
        t = torch.cat(parts, dim=tp_dim)
    return t


def tp_share(t: torch.Tensor, tp_dim: Optional[int], plan: Plan) -> torch.Tensor:
    """This rank's ``tp`` share of a whole tensor (the tensor itself when
    nothing is split)."""
    if tp_dim is None or plan.tp_size == 1:
        return t
    start, stop = split_range(t.shape[tp_dim], plan.tp_size, plan.tp_rank)
    return t.narrow(tp_dim, start, stop - start).contiguous()


def whole_shape(t: torch.Tensor, tp_dim: Optional[int], plan: Plan) -> tuple:
    """The shape of the whole tensor of which ``t`` (a ``DTensor`` or a
    plain tensor) is this rank's ``tp`` share."""
    shape = list(t.shape)
    if tp_dim is not None:
        shape[tp_dim] *= plan.tp_size
    return tuple(shape)


def model_full_state(model: torch.nn.Module, plan: Plan, keep: bool) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` as whole tensors on the CPU (where ``keep``;
    the other ranks take part in the collectives and keep nothing)."""
    out = {}
    for name, value in model.state_dict().items():
        whole = full_tensor(value, plan.tp_dims.get(name), plan)
        if keep:
            out[name] = whole.cpu()
    return out


def optimizer_full_state(optimizer: torch.optim.Optimizer, names: List[str], plan: Plan,
                         keep: bool) -> Dict[str, Any]:
    """``checkpoint.optimizer_state``'s dict with whole tensors: each
    parameter's AdamW moments gathered like the parameter."""
    sd = optimizer.state_dict()
    state = {}
    for idx, name in enumerate(names):
        entry = sd["state"].get(idx)
        if entry is None:
            continue
        whole = {}
        for k, v in entry.items():
            if torch.is_tensor(v) and v.dim() > 0:
                v = full_tensor(v, plan.tp_dims.get(name), plan)
            whole[k] = v.cpu() if torch.is_tensor(v) else v
        state[idx] = whole
    if not keep:
        return {}
    return {"names": list(names), "state_dict": {"state": state,
                                                 "param_groups": sd["param_groups"]}}


def local_like(whole: torch.Tensor, live: torch.Tensor, tp_dim: Optional[int],
               plan: Plan) -> torch.Tensor:
    """``whole`` laid out as ``live`` is on this rank: its ``tp`` share, then
    the FSDP2 shard when ``live`` is a ``DTensor`` (sliced locally, no
    communication)."""
    from torch.distributed.tensor import distribute_tensor

    share = tp_share(whole, tp_dim, plan)
    if hasattr(live, "device_mesh"):
        return distribute_tensor(share.to(live.device), live.device_mesh, live.placements,
                                 src_data_rank=None)
    return share


def load_model_full_state(model: torch.nn.Module, take: Dict[str, torch.Tensor],
                          plan: Plan) -> None:
    """Load whole tensors (every rank holds them) into the planned model:
    each cut to this rank's ``tp`` share, then sharded by FSDP2."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

    local = {k: tp_share(v, plan.tp_dims.get(k), plan) for k, v in take.items()}
    set_model_state_dict(model, local,
                         options=StateDictOptions(full_state_dict=True, strict=False))


def optimizer_local_state(saved: Dict[str, Any], names: List[str], params: List[torch.Tensor],
                          plan: Plan) -> Dict[str, Any]:
    """A saved ``optimizer_state`` dict with each whole moment laid out as its
    live parameter is on this rank (a moment whose whole shape does not fit
    passes as saved, and the overlay keeps the live one)."""
    live = dict(zip(names, params))
    state = {}
    for idx, entry in saved["state_dict"]["state"].items():
        name = saved["names"][idx] if idx < len(saved["names"]) else None
        p = live.get(name)
        if p is None:
            state[idx] = entry
            continue
        dim = plan.tp_dims.get(name)
        want = whole_shape(p, dim, plan)
        state[idx] = {k: (local_like(v, p, dim, plan)
                          if torch.is_tensor(v) and v.dim() > 0 and tuple(v.shape) == want
                          else v)
                      for k, v in entry.items()}
    return {"names": saved["names"],
            "state_dict": {**saved["state_dict"], "state": state}}
