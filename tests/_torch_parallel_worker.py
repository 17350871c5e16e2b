"""Ranks of the port's multi-rank CPU tests (``tests/test_torch_port_parallel*.py``,
``tests/test_torch_port_sequence_parallel*.py``,
``tests/test_torch_port_sequence_tensor_parallel.py``,
``tests/test_torch_port_patchtst_data_parallel.py``,
``tests/test_torch_port_cache_batches_parallel.py``).

``python tests/_torch_parallel_worker.py <job.pt>`` is started as every rank
of one gloo group (``llm_bci_tpu_torch.parallel.process.spawn``); it runs the
job's cases in order and writes ``rank<r>.pt`` with each case's result (or
its traceback) beside the job file. The same case functions run in the test
process without a group for the single-process reference. Nothing here
imports JAX: the tests hand over configs, datasets and weights as files.
"""
from __future__ import annotations

import copy
import os
import pickle
import re
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llm_bci_tpu_torch.config import DictConfig  # noqa: E402


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _config(plain: dict, parallelism: dict, **training) -> DictConfig:
    plain = copy.deepcopy(plain)
    plain["parallelism"] = dict(parallelism)
    plain["training"].update(training)
    return DictConfig(plain)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _trainer(plain, parallelism, dataset_path, weights_path, trainer_class=None,
             metric_fns=None, **training):
    from llm_bci_tpu_torch.training.trainer import Trainer, build_model

    cfg = _config(plain, parallelism, **training)
    model = build_model(cfg, torch.device("cpu"))
    model.load_state_dict(torch.load(weights_path, weights_only=True), strict=True)
    return (trainer_class or Trainer)(cfg, model=model, dataset=_load(dataset_path),
                                      metric_fns=metric_fns, device="cpu")


def train(plain, parallelism, dataset_path, weights_path, **training):
    """Train; the per-step losses (summed over the global batch), the whole
    final state on rank 0, this rank's planned shapes and LoRA factors, a
    flash forward with dropout seeded as the models seed it (``draw_seed``
    from the training generator) and the generator's next draws, both from a
    copy of the generator taken before training."""
    from llm_bci_tpu_torch.ops.flash_attention import banded_flash_attention, draw_seed
    from llm_bci_tpu_torch.parallel.mesh import fsdp_groups

    losses, pred_shapes = [], []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(outputs["loss"]))
        if torch.is_tensor(outputs.get("preds")):
            pred_shapes.append(tuple(outputs["preds"].shape))
        return 0.0

    trainer = _trainer(plain, parallelism, dataset_path, weights_path,
                       metric_fns={"rec": record}, **training)
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    gen = torch.Generator().set_state(trainer.generator.get_state())
    flash = banded_flash_attention(q, k, v, dropout_rate=0.5, seed=draw_seed(gen, "cpu"))
    draws = torch.rand(8, generator=gen)
    groups = fsdp_groups(trainer.model, int(trainer.config.parallelism.get(
        "fsdp_min_size", 1 << 20)))
    trainer.train()
    state = trainer.whole_state()
    local = {n: tuple((p.to_local() if hasattr(p, "to_local") else p).shape)
             for n, p in trainer.model.named_parameters()}
    lora = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
            for n, p in trainer.model.named_parameters() if ".lora_" in n}
    encoder = getattr(trainer.model, "encoder", None)
    buffers = {n: b.detach().clone() for n, b in trainer.model.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    return {"losses": losses, "model": state["model"], "n_micro": trainer.n_micro,
            "host_batches": trainer.host_batches, "buffers": buffers, "first_moments": first_moments(state["optimizer"]),
            "pred_shapes": pred_shapes, "eval": trainer.eval_history,
            "flash_fallback": getattr(encoder, "flash_fallback", None),
            "shard": (None if getattr(trainer, "_seq_shard", None) is None else
                      (trainer._seq_shard.token_range, trainer._seq_shard.tokens)),
            "shapes": {n: tuple(v.shape) for n, v in trainer.model.state_dict().items()},
            "local": local, "lora": lora, "flash": flash, "draws": draws,
            "coords": dict(trainer.coords), "groups": groups}


def train_pooled(plain, parallelism, dataset_path, weights_path, **training):
    """``train`` with every device batch that does not stream held against
    ``Trainer.to_device`` of the same host batch, bit for bit: ``sources``
    counts the batches by their source's kind (``NoneType``: streamed,
    ``dict``: kept by the caching pass, ``PoolRows``: gathered), ``unequal``
    names each key that differed, ``shapes`` the rank's batch shapes seen;
    with the pool's bytes on this rank and the step graphs' counts."""
    from llm_bci_tpu_torch.training import step_graph
    from llm_bci_tpu_torch.training.trainer import Trainer

    sources, unequal, shapes, pool = {}, [], set(), {}
    real = Trainer.device_batch

    def checked(self, source, model_inputs, out=None):
        dev = real(self, source, model_inputs, out)
        kind = type(source).__name__
        sources[kind] = sources.get(kind, 0) + 1
        shapes.update((k, tuple(v.shape)) for k, v in dev.items() if torch.is_tensor(v))
        if source is not None:
            host_batches = self.host_batches
            want = self.to_device(model_inputs)
            self.host_batches = host_batches
            for k, v in want.items():
                same = torch.equal(dev[k], v) if torch.is_tensor(v) else dev.get(k) == v
                if not same:
                    unequal.append((sources[kind], kind, k))
        if self.batch_cache is not None:
            pool["bytes"] = self.batch_cache.bytes
        return dev

    Trainer.device_batch = checked
    step_graph.reset_counters()
    try:
        out = train(plain, parallelism, dataset_path, weights_path, **training)
    finally:
        Trainer.device_batch = real
    return {**out, "sources": sources, "unequal": unequal, "shapes": sorted(shapes),
            "pool_bytes": pool.get("bytes"),
            "graph": (step_graph.EAGER_STEPS, step_graph.CAPTURES, step_graph.REPLAYS)}


def first_moments(optimizer_state) -> dict:
    """AdamW's first moment of each parameter by name (empty off rank 0):
    it scales with the gradients, which Adam's update does not."""
    if not optimizer_state:
        return {}
    state = optimizer_state["state_dict"]["state"]
    return {name: state[i]["exp_avg"] for i, name in enumerate(optimizer_state["names"])
            if i in state}


def assert_moments_close(got, want, what, rtol):
    """The first moments of ``got`` within ``rtol`` of ``want``'s, as one
    vector's relative L2 (the noise-only leaves left out): a gradient off by
    a factor shows here where Adam's update hides it."""
    keys = [k for k in want if not NOISE_ONLY.search(k) and not k.endswith("qkv.bias")]
    assert keys and set(keys) <= set(got), (what, sorted(set(keys) - set(got))[:5])
    num = sum(float((got[k].float() - want[k].float()).square().sum()) for k in keys)
    den = sum(float(want[k].float().square().sum()) for k in keys)
    rel = (num / den) ** 0.5
    assert rel <= rtol, (what, rel)


def fixed_uniform(shape):
    """A fixed uniform array of ``shape``, the same for every row of dim 0
    (a data rank's rows then get what one process gives them)."""
    row = np.random.default_rng(int(np.prod(shape[1:]))).uniform(size=(1, *shape[1:]))
    return np.broadcast_to(row, shape).astype(np.float32)


def fixed_patch_noise(shape, consistent, generator, device):
    """PatchTST's masking noise from :func:`fixed_uniform` (the JAX package's
    ``jax.random.uniform`` replaced by the same array makes both packages
    mask the same patches)."""
    B, C, P = shape
    return torch.from_numpy(fixed_uniform((B, 1 if consistent else C, P))).to(device).expand(
        B, C, P)


def train_fixed_noise(plain, parallelism, dataset_path, weights_path, **training):
    """``train`` with PatchTST's masking noise fixed (:func:`fixed_patch_noise`)."""
    from llm_bci_tpu_torch.models import patchtst

    real = patchtst.patch_noise
    patchtst.patch_noise = fixed_patch_noise
    try:
        return train(plain, parallelism, dataset_path, weights_path, **training)
    finally:
        patchtst.patch_noise = real


def collectives(x, weight, bias, bn_x, bn_grad):
    """The ``sp`` collectives on pairs of ranks (0 1, 2 3), each rank holding
    the half of the time axis of its index in the pair: a row-parallel
    Linear over the bins of ``x`` (B, N, T), BatchNorm with statistics synced
    over the pair on its half of ``bn_x``'s rows (B, T, D), forward and the
    backward of ``(out * bn_grad).sum()``, and a broadcast from the pair's
    first rank. This rank's results."""
    import torch.distributed as dist

    from llm_bci_tpu_torch.models.patchtst import FlaxBatchNorm
    from llm_bci_tpu_torch.parallel.sequence import broadcast_first, row_parallel_linear
    from llm_bci_tpu_torch.models.ndt1 import sequence_layout

    rank = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    index = rank % 2
    T = x.shape[-1]
    shard = sequence_layout(T, 2, index).with_group(pairs[rank // 2])
    t0, t1 = shard.token_range
    layer = torch.nn.Linear(T, weight.shape[0])
    with torch.no_grad():
        layer.weight.copy_(weight)
        layer.bias.copy_(bias)
    linear = row_parallel_linear(x[..., t0:t1], layer, shard, t0, t1)
    linear.sum().backward()
    bn = FlaxBatchNorm(bn_x.shape[-1])
    part = bn_x[:, t0:t1].clone().requires_grad_(True)
    out = bn(part, shard.group)
    (out * bn_grad[:, t0:t1]).sum().backward()
    sent = broadcast_first(torch.full((3,), float(rank), requires_grad=True), shard)
    return {"index": index, "linear": linear.detach(), "weight_grad": layer.weight.grad,
            "bias_grad": layer.bias.grad, "bn": out.detach(), "bn_x_grad": part.grad,
            "bn_weight_grad": bn.weight.grad, "bn_bias_grad": bn.bias.grad,
            "running": (bn.running_mean.clone(), bn.running_var.clone()),
            "broadcast": sent.detach()}


def train_hooked_by_tree_flatten(plain, parallelism, dataset_path, weights_path, **training):
    """``train`` with FSDP2's pre-backward hooks placed on the tensors that
    ``tree_flatten`` finds in a forward's output, as torch 2.11 places them
    (later versions also walk a dataclass that pytree does not know), and
    with the FSDP2 groups of the plan's modules (none: the root's one group
    holds every parameter and alone hooks the backward)."""
    from torch.distributed.fsdp._fully_shard._fsdp_state import FSDPState
    from torch.utils._pytree import tree_flatten

    def register(self, output):
        if torch.is_grad_enabled():
            for t in tree_flatten(output)[0]:
                if torch.is_tensor(t) and t.requires_grad:
                    t.register_hook(self._pre_backward)
        return output

    real = FSDPState._register_pre_backward_hook
    FSDPState._register_pre_backward_hook = register
    try:
        out = train(plain, parallelism, dataset_path, weights_path, **training)
    finally:
        FSDPState._register_pre_backward_hook = real
    return out


def resume(plain, parallelism, dataset_path, weights_path, **training):
    """A fresh trainer resumed from the newest train state of its run: the
    restored step and the whole state right after."""
    trainer = _trainer(plain, parallelism, dataset_path, weights_path, **training)
    step = trainer.resume_from()
    state = trainer.whole_state()
    return {"step": step, "model": state["model"], "optimizer": state["optimizer"]}


def resume_train(plain, parallelism, dataset_path, weights_path, **training):
    """A fresh trainer resumed from the newest train state of its run and
    trained on to ``max_steps``: the restored step, the losses of the steps
    after it and the whole final state."""
    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(outputs["loss"]))
        return 0.0

    trainer = _trainer(plain, parallelism, dataset_path, weights_path,
                       metric_fns={"rec": record}, **training)
    step = trainer.resume_from()
    trainer.train()
    return {"step": step, "losses": losses, "model": trainer.whole_state()["model"]}


def preempt(plain, parallelism, dataset_path, weights_path, stop_rank, stop_after, **training):
    """Train with a preemption request on rank ``stop_rank`` after step
    ``stop_after``: the step at which this rank stopped."""
    from llm_bci_tpu_torch.training.trainer import Trainer

    class Preempted(Trainer):
        def train_step(self, batch):
            out = super().train_step(batch)
            if _rank() == stop_rank and self.n_micro == stop_after:
                self.request_preemption()
            return out

    trainer = _trainer(plain, parallelism, dataset_path, weights_path, Preempted, **training)
    trainer.train()
    return {"n_micro": trainer.n_micro,
            "saved": sorted(os.listdir(trainer.checkpoint_dir))}


def clip(plain, parallelism, dataset_path, weights_path, grads_path, max_norm):
    """``clip_by_global_norm`` over a planned model's gradients, set from the
    whole arrays of ``grads_path``: the norm and the whole clipped
    gradients (rank 0)."""
    from llm_bci_tpu_torch.training import distributed as tdist
    from llm_bci_tpu_torch.training.optim import clip_by_global_norm

    trainer = _trainer(plain, parallelism, dataset_path, weights_path)
    grads = torch.load(grads_path, weights_only=True)
    plan = trainer.plan
    for name, p in zip(trainer.trainable_names, trainer.trainable):
        p.grad = tdist.local_like(grads[name], p, plan.tp_dims.get(name), plan)
    norm = clip_by_global_norm(trainer.trainable, max_norm, trainer.tp_split,
                               fsdp_group=plan.fsdp_group, tp_group=plan.tp_group)
    whole = {n: tdist.full_tensor(p.grad, plan.tp_dims.get(n), plan)
             for n, p in zip(trainer.trainable_names, trainer.trainable)}
    return {"norm": float(norm), "grads": whole if _rank() == 0 else {}}


def decode(plain, batch_path, quant, dtype):
    """Greedy ids of a BCI before and after the tensor-parallel plan over
    the whole group; every rank builds the same seeded weights (LoRA ``B``
    drawn too, so that the adapters' slices count) and takes the same
    batch."""
    import torch.distributed as dist

    from llm_bci_tpu_torch.parallel.tensor_parallel import apply_tp_plan
    from llm_bci_tpu_torch.training.trainer import build_model

    cfg = _config(plain, {"data": 1, "fsdp": 1})
    torch.manual_seed(0)
    model = build_model(cfg, torch.device("cpu"), quantize=quant, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    batch = {k: torch.from_numpy(v) for k, v in _load(batch_path).items()}
    with torch.no_grad():
        plain_ids = model.generate(**batch, max_new_tokens=6)
        apply_tp_plan(model.llm, dist.group.WORLD)
        tp_ids = model.generate(**batch, max_new_tokens=6)
    return {"plain": plain_ids, "tp": tp_ids,
            "q_rows": tuple(model.llm.model.layers[0].self_attn.q_proj.state_dict()[
                "kernel" if quant else "weight"].shape)}


def dryrun(tmp):
    """``dryrun_multichip``'s steps on this group (every rank): rank 0's
    report line."""
    from llm_bci_tpu_torch.entry import dryrun_steps

    report = dryrun_steps(tmp, device="cpu")
    return {"report": report if _rank() == 0 else None}


def mesh_groups(meshes):
    """For each ``(data, fsdp, sp, tp)`` of ``meshes``: the ranks of this
    rank's groups on the two dims of ``parallel/mesh.py::fsdp_mesh``
    (replicate, shard) and of its ``tp`` group, each in group order."""
    import torch.distributed as dist

    from llm_bci_tpu_torch.parallel import mesh as pmesh

    out = {}
    for data, fsdp, sp, tp in meshes:
        mesh = pmesh.make_mesh(data=data, fsdp=fsdp, sp=sp, tp=tp)
        dp = pmesh.fsdp_mesh(mesh)
        out[(data, fsdp, sp, tp)] = {
            "replicate": dist.get_process_group_ranks(dp.get_group(0)),
            "shard": dist.get_process_group_ranks(dp.get_group(1)),
            "tp": dist.get_process_group_ranks(mesh["tp"].get_group())}
    return out


CASES = {f.__name__: f for f in (train, train_pooled, train_fixed_noise, train_hooked_by_tree_flatten, resume,
                                  resume_train, preempt, clip, decode, dryrun, collectives,
                                  mesh_groups)}


def main(job_path: str) -> None:
    from llm_bci_tpu_torch.parallel import process

    # below the test workers' priority: the ranks wait on each other, not on
    # the other test files running beside them
    os.nice(5)
    process.init_process("cpu", timeout_s=300.0)
    job = _load(job_path)
    results = {}
    for name, kind, kwargs in job["cases"]:
        try:
            results[name] = CASES[kind](**kwargs)
        except Exception:            # the test of this case reports it
            results[name] = {"error": traceback.format_exc()}
            print(results[name]["error"], flush=True)
    torch.save(results, os.path.join(os.path.dirname(job_path), f"rank{_rank()}.pt"))


def run_ranks(tmp, n: int, cases) -> list:
    """Run ``cases`` (``(name, kind, kwargs)``) on ``n`` ranks of one group;
    each rank's results."""
    from llm_bci_tpu_torch.parallel import process

    job = os.path.join(str(tmp), "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"cases": cases}, f)
    # one thread a rank: the ranks share the host with the other test workers
    process.spawn([os.path.abspath(__file__), job], n, env={"OMP_NUM_THREADS": "1"},
                  timeout_s=300.0)
    return [torch.load(os.path.join(str(tmp), f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


# An attention key bias gets a gradient that is 0 in exact arithmetic (the
# softmax does not see a shift shared by all keys) and rounding noise in
# float; Adam moves a leaf by up to lr a step whatever the gradient's size, so
# such a leaf is held to what Adam can move it: 2 * lr * steps.
NOISE_ONLY = re.compile(r"attn\.key\.bias$")


def assert_states_close(got, want, what, lr, steps, **tol):
    """Every leaf of ``want`` within ``tol`` of ``got``'s (the noise-only
    leaves within ``2 * lr * steps``); lists every leaf that is not."""
    assert set(want) <= set(got), (what, sorted(set(want) - set(got))[:5])
    bad = []
    for key in want:
        kw = dict(atol=2 * lr * steps, rtol=0) if NOISE_ONLY.search(key) else tol
        a, b = got[key].float().numpy(), want[key].float().numpy()
        if not np.allclose(a, b, **kw):
            bad.append(f"{key} {np.abs(a - b).max():.3g}")
    assert not bad, (what, bad)


def dump(obj, path) -> str:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


if __name__ == "__main__":
    main(sys.argv[1])
