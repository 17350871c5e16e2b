"""Device mesh and the layout rules of multi-device training (counterpart of
``llm_bci_tpu/parallel/mesh.py``).

One ``torch.distributed.device_mesh.DeviceMesh`` over the world with the dim
names ``("data", "fsdp", "sp", "tp")``, the JAX package's axes in its order:

* ``data``: the batch. Every rank iterates the same global batch and keeps
  the rows of its ``data`` index (:func:`batch_rows`); a batch that the axis
  does not divide stays whole on every rank, as the JAX trainer replicates
  it. Ranks that differ only in ``fsdp`` or ``tp`` hold the same rows.
* ``fsdp``: parameters and optimizer state, sharded by FSDP2 ``fully_shard``
  over the ``(data, fsdp)`` sub-mesh (replicated over ``data``, sharded over
  ``fsdp``); :func:`fsdp_groups` says which modules get a group of their own.
* ``tp``: Megatron tensor parallelism of the Llama projections on plain
  local shards (:func:`tp_layout`, applied by
  ``parallel/tensor_parallel.py``).
* ``sp``: sequence parallelism. Every rank of an ``sp`` group holds the same
  rows and its part of their time axis (:func:`sequence_range`); the model
  says which bins, frames, patches and halo each part needs (its
  ``sequence_layout``), its collectives make the wholes it needs over the
  group (``parallel/sequence.py``), and FSDP2 averages the gradients with
  ``sp`` on the replicate side of its mesh (:func:`fsdp_mesh`).

Where GSPMD gives the JAX package its collectives, the port's come from
FSDP2 (all-gather, reduce-scatter, all-reduce over ``data``) and from the
hand-written tensor-parallel products; the kernels (CTC, flash, int8) see the
plain local tensors of their rank, as ``ops/spmd.py``'s ``shard_map`` gives
them to the Pallas kernels.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

AXES = ("data", "fsdp", "sp", "tp")


def mesh_shape(world_size: int, data: int = -1, fsdp: int = 1, tp: int = 1,
               sp: int = 1) -> Dict[str, int]:
    """Axis sizes for ``world_size`` ranks by the JAX package's rules: at most
    one ``-1``, which takes the ranks the others leave, and a product equal to
    the world size (the same error texts)."""
    sizes = {"data": int(data), "fsdp": int(fsdp), "sp": int(sp), "tp": int(tp)}
    free = [k for k, v in sizes.items() if v == -1]
    if len(free) > 1:
        raise ValueError("Only one mesh axis may be -1")
    if free:
        fixed = 1
        for k, v in sizes.items():
            if v != -1:
                fixed *= v
        sizes[free[0]] = world_size // fixed
    if sizes["data"] * sizes["fsdp"] * sizes["sp"] * sizes["tp"] != world_size:
        raise ValueError(
            f"mesh {sizes['data']}x{sizes['fsdp']}x{sizes['sp']}x{sizes['tp']}"
            f" (data x fsdp x sp x tp) != {world_size} devices"
        )
    return sizes


def make_mesh(data: int = -1, fsdp: int = 1, tp: int = 1, sp: int = 1, device_type=None):
    """A ``DeviceMesh`` of the sizes :func:`mesh_shape` gives over the
    process group's world, dims ``("data", "fsdp", "sp", "tp")`` (``tp``
    innermost: its ranks are neighbours). ``device_type`` defaults to the
    type of ``torch.distributed``'s default device for the backend (``cuda``
    for NCCL, ``cpu`` for gloo). Needs an initialized process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sizes = mesh_shape(dist.get_world_size(), data, fsdp, tp, sp)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXES), mesh_dim_names=AXES)


def fsdp_mesh(mesh):
    """The 2-D mesh FSDP2 shards over: ``(data, fsdp)``, replicated over the
    first dim and sharded over the second. With ``sp > 1`` the first dim is
    ``data`` and ``sp`` flattened (``data_sp``): the ranks of a time shard
    hold gradients of the same parameters, which FSDP2 then averages with
    the data replicas' (``parallel/sequence.py`` gives the rule that makes
    the average one process's gradient), and the ``fsdp`` groups stay the
    ranks that share a ``data`` and an ``sp`` index. Either way a rank's
    mesh holds only the ranks of its ``tp`` index, whose tensors are the
    same shares of the Llama. The ``data_sp`` mesh is made from process
    groups (every rank makes the group of each ``(fsdp, tp)`` index, in one
    order), not by slicing: a ``DeviceMesh`` slice must keep its dims'
    order in the world's ranks, which ``data x sp`` across ``fsdp`` does
    not."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if mesh["sp"].size() == 1:
        return mesh["data", "fsdp"]
    ranks = mesh.mesh                                  # (data, fsdp, sp, tp)
    mine = tp_index = None
    for f in range(ranks.shape[1]):
        for t in range(ranks.shape[3]):
            members = ranks[:, f, :, t].flatten().tolist()
            group = dist.new_group(members)
            if dist.get_rank() in members:
                mine, tp_index = group, t
    grid = ranks[:, :, :, tp_index].permute(0, 2, 1).reshape(-1, ranks.shape[1])
    return DeviceMesh.from_group([mine, mesh["fsdp"].get_group()], mesh.device_type,
                                 mesh=grid, mesh_dim_names=("data_sp", "fsdp"))


def coordinates(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """The index of ``rank`` along each axis of a row-major mesh of
    ``sizes``."""
    out = {}
    for axis in reversed(AXES):
        out[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return {a: out[a] for a in AXES}


def sequence_range(length: int, n_sp: int, sp_index: int) -> Tuple[int, int]:
    """``(start, stop)`` of the time steps an ``sp`` rank keeps of a sequence
    of ``length`` steps: its even share when the axis divides the length
    (``sequence_sharding``'s ``P("data", "sp")`` of the JAX package), else
    all of it (the JAX trainer's ``_put_batch`` then keeps the key whole)."""
    if n_sp > 1 and length % n_sp == 0:
        size = length // n_sp
        return sp_index * size, (sp_index + 1) * size
    return 0, length


def batch_rows(batch_size: int, n_data: int, data_index: int) -> Tuple[int, int]:
    """``(start, stop)`` of the rows a rank keeps of a global batch of
    ``batch_size`` rows: its ``data`` shard when the axis divides the batch,
    else all of it (the JAX trainer's ``_put_batch`` replicates such a batch,
    a partial last one for instance)."""
    if n_data > 1 and batch_size % n_data == 0:
        rows = batch_size // n_data
        return data_index * rows, (data_index + 1) * rows
    return 0, batch_size


# Megatron tensor parallelism of the Llama decoder (the JAX package's
# ``tp_llama_rules``, which gives PartitionSpecs of the flax (in, out)
# kernels): column-parallel projections split their output features (whole
# heads, an equal share of the MLP), row-parallel ones their input features,
# their partial products summed over ``tp`` by an all-reduce.
TP_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
TP_ROW = ("o_proj", "down_proj")
# a split projection's state_dict leaf -> the dim its tp share cuts (an int8
# ``kernel`` is (in, out), a float ``weight`` (out, in); a row-parallel
# projection's ``kernel_scale`` and bias stay whole)
TP_DIMS = {"column": {"weight": 0, "bias": 0, "kernel": 1, "kernel_scale": 0},
           "row": {"weight": 1, "kernel": 0}}


def tp_layout(name: str) -> str:
    """How the plan lays out a Llama ``state_dict`` leaf: ``column`` or
    ``row`` (split over ``tp``) or ``replicated``. LoRA factors, norms,
    embeddings and ``lm_head`` stay whole; a split projection uses its rank's
    slice of its LoRA factors, whose gradients are summed over ``tp`` so that
    every rank holds the same whole factor."""
    parts = name.split(".")
    if len(parts) >= 2:
        module, leaf = parts[-2], parts[-1]
        for role, names in (("column", TP_COLUMN), ("row", TP_ROW)):
            if module in names and leaf in TP_DIMS[role]:
                return role
    return "replicated"


def fsdp_groups(model: torch.nn.Module, min_size: int = 1 << 20) -> List[str]:
    """Names of the submodules that get an FSDP2 group of their own: each
    module that directly holds a parameter of at least ``min_size`` elements
    (``parallelism.fsdp_min_size``), deepest first. The root module's group
    takes every other parameter.

    How the JAX rule maps: ``fsdp_param_spec`` shards a leaf of at least
    ``min_size`` elements over ``fsdp`` and replicates the smaller ones. FSDP2
    shards every parameter of a group, so here the large leaves each travel in
    their own module's all-gather and reduce-scatter, while the small leaves
    (norms, biases, LoRA factors and whatever else falls under the threshold)
    share the root's one group: one collective for all of them, the nearest
    FSDP2 comes to leaving them whole. Buffers (the int8 base's codes and
    scales) are never sharded."""
    names = []
    for name, module in model.named_modules():
        if name and any(p.numel() >= min_size for p in module.parameters(recurse=False)):
            names.append(name)
    return sorted(names, key=lambda n: -n.count("."))


def check_tp_heads(n_heads: int, n_kv: int, intermediate: int, tp: int) -> None:
    """The tensor-parallel split must give every rank whole heads (query and
    key/value) and an equal share of the MLP."""
    if n_kv % tp or n_heads % tp or intermediate % tp:
        raise ValueError(
            f"tensor parallelism tp={tp} needs num_key_value_heads ({n_kv}), "
            f"num_attention_heads ({n_heads}) and intermediate_size ({intermediate}) "
            "divisible by it")


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``(start, stop)`` of part ``index`` of ``n`` items cut into ``parts``
    contiguous parts, evenly when ``parts`` divides ``n`` (a tensor-parallel
    share), else in sizes that differ by one, the first ``n % parts`` parts
    the longer: how the ``sp`` ranks share stacked frames whose count the
    axis does not divide (121 frames over 2: 61 and 60)."""
    size, extra = divmod(n, parts)
    start = index * size + min(index, extra)
    return start, start + size + (index < extra)
