"""Megatron tensor parallelism of the BCI's Llama on gloo CPU ranks
(``parallel/tensor_parallel.py``), with FSDP2, held against the JAX package.

* the debug BCI (int8 base, LoRA r=2 on all seven projections, float32,
  stochastic parts off) trains 3 steps on ``tp=2`` (2 ranks) and on
  ``fsdp=2 x tp=2`` (4 ranks): losses and final parameters against the port's
  single process (rtol 1e-5, atol 1e-6) and against the JAX trainer on the
  8-device virtual mesh (rtol 1e-4, atol 1e-5); the frozen int8 base keeps its
  bits; the LoRA factors come out the same on every ``tp`` rank (their
  gradients summed over ``tp``); each rank holds its share of the split
  projections;
* ``clip_by_global_norm`` over the planned shards (FSDP2 ``DTensor`` s, ``tp``
  splits, replicated leaves counted once) against ``optax`` on the whole
  arrays, on a BCI without LoRA whose Llama trains;
* greedy decode under ``tp=2`` gives the unplanned model's ids, on a float
  and an int8 base (float32 compute);
* the int8 kernels' plans accept the tensor-parallel shapes at Llama-2-7B
  width; ``dryrun_multichip(4)``'s steps on the module's 4 ranks.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu.models import bci as jbci
from llm_bci_tpu_torch.interop import bci_state_dict_from_jax
from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

from tests import _torch_parallel_worker as W
from tests.test_bci import synth_bci_dataset
from tests.test_torch_port_bci import port_cfg, trainer_config

STEPS = 3
SINGLE = dict(rtol=1e-5, atol=1e-6)
JAX = dict(rtol=1e-4, atol=1e-5)
MESHES = {"tp2": (2, {"data": 1, "fsdp": 1, "tp": 2}),
          "fsdp2_tp2": (4, {"data": 1, "fsdp": 2, "tp": 2})}
GEN_KEYS = ("input_ids", "attention_mask", "input_split", "spikes", "spikes_mask",
            "spikes_timestamp", "spikes_lengths", "block_idx", "day_idx")


def _plain(tmp, tag, lora=True):
    cfg = to_plain_dict(trainer_config(tmp / tag, "int8" if lora else None))
    cfg["training"].update(max_steps=STEPS)
    if not lora:
        cfg["method"]["model_kwargs"]["lora"] = None
    return cfg


@pytest.fixture(scope="module")
def background():
    """A thread pool for the module's subprocess runs (gloo ranks, the dry
    run), which wait on their processes while this one compiles JAX."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        yield pool


@pytest.fixture(scope="module")
def runs(tmp_path_factory, background):
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer
    from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

    tmp = tmp_path_factory.mktemp("parallel_bci")
    dataset = synth_bci_dataset(n_train=10, n_test=4)
    data_path = W.dump(dataset, tmp / "data.pkl")
    jax_losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        jax_losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    cfg = trainer_config(tmp / "jax", "int8")
    cfg["training"]["max_steps"] = STEPS
    jmodel = jbci.BCI.from_config(cfg["model"], **cfg["method"]["model_kwargs"]).clone(
        dtype=jnp.float32)
    jt = JaxTrainer(cfg, model=jmodel, dataset=dataset, metric_fns={"rec": record})
    weights = os.path.join(tmp, "weights.pt")
    torch.save(bci_state_dict_from_jax(jax.device_get(jt.state.params)), weights)

    single = W.train(_plain(tmp, "single"), {"data": 1, "fsdp": 1}, data_path, weights)
    initial = torch.load(weights, weights_only=True)

    # the clip: a BCI whose Llama trains (no LoRA, float base), seeded
    # weights and gradients
    from llm_bci_tpu_torch.training.trainer import build_model

    clip_plain = _plain(tmp, "clip", lora=False)
    torch.manual_seed(0)
    full = build_model(W._config(clip_plain, {}), torch.device("cpu"))
    float_weights = os.path.join(tmp, "float_weights.pt")
    torch.save(full.state_dict(), float_weights)
    rng = np.random.default_rng(3)
    grads = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32) * 0.01)
             for n, p in full.named_parameters() if p.requires_grad}
    grads_path = os.path.join(tmp, "grads.pt")
    torch.save(grads, grads_path)
    clip_kwargs = dict(plain=clip_plain, dataset_path=data_path, weights_path=float_weights,
                       grads_path=grads_path, max_norm=1.0)

    # a test batch for the decodes
    pt = PortTrainer(port_cfg(trainer_config(tmp / "batch")), dataset=dataset, device="cpu")
    batch = {k: v for k, v in next(iter(pt.test_dataloader))[0].items() if k in GEN_KEYS}
    batch_path = W.dump(batch, tmp / "batch.pkl")
    del pt

    ranks = {}
    for tag, (n, par) in MESHES.items():
        cases = [(tag, "train", dict(plain=_plain(tmp, tag), parallelism=par,
                                     dataset_path=data_path, weights_path=weights)),
                 ("clip", "clip", dict(parallelism=par, **clip_kwargs))]
        if n == 2:
            cases += [(f"decode_{q or 'float'}", "decode",
                       dict(plain=_plain(tmp, "decode"), batch_path=batch_path, quant=q,
                            dtype="float32"))
                      for q in (None, "int8")]
        else:   # dryrun_multichip(4)'s steps, on this group's 4 ranks
            cases.append(("dryrun", "dryrun", dict(tmp=str(tmp / "dryrun"))))
        os.makedirs(tmp / tag)
        ranks[tag] = background.submit(W.run_ranks, tmp / tag, n, cases)
    jt.train()                                  # while the ranks run
    jax_final = bci_state_dict_from_jax(jax.device_get(jt.state.params))
    ranks = {tag: future.result() for tag, future in ranks.items()}
    return {"jax_losses": jax_losses, "jax_final": jax_final, "single": single,
            "initial": initial, "ranks": ranks, "grads": grads}


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def _trainable(state):
    return {k: v for k, v in state.items() if ".lora_" in k or not k.startswith("llm.")}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bci_multi_rank_matches_the_single_process(runs, mesh):
    single = runs["single"]
    for res in runs["ranks"][mesh]:
        res = _ok(res[mesh])
        assert len(res["losses"]) == STEPS
        np.testing.assert_allclose(res["losses"], single["losses"], **SINGLE)
    got = runs["ranks"][mesh][0][mesh]["model"]
    assert set(got) == set(single["model"])
    W.assert_states_close(got, single["model"], mesh, lr=1e-3, steps=STEPS, **SINGLE)
    # the frozen base keeps its bits
    for key, value in runs["initial"].items():
        if key.startswith("llm.") and ".lora_" not in key:
            assert torch.equal(got[key].to(value.dtype), value), key


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bci_multi_rank_matches_the_jax_trainer(runs, mesh):
    res = _ok(runs["ranks"][mesh][0][mesh])
    np.testing.assert_allclose(res["losses"], runs["jax_losses"], **JAX)
    W.assert_states_close(res["model"], _trainable(runs["jax_final"]), mesh, lr=1e-3,
                          steps=STEPS, **JAX)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_ranks_hold_their_share_and_the_same_lora(runs, mesh):
    ranks = [_ok(r[mesh]) for r in runs["ranks"][mesh]]
    whole = runs["single"]["shapes"]
    q = "llm.model.layers.0.self_attn.q_proj.kernel"
    o = "llm.model.layers.0.self_attn.o_proj.kernel"
    for res in ranks:
        assert res["shapes"][q] == (whole[q][0], whole[q][1] // 2)         # columns
        assert res["shapes"][o] == (whole[o][0] // 2, whole[o][1])         # rows
        assert res["shapes"][q.replace("kernel", "kernel_scale")] == (whole[q][1] // 2,)
    moved = 0
    for name, value in ranks[0]["lora"].items():
        for res in ranks[1:]:
            assert torch.equal(res["lora"][name], value), name
        moved += not torch.equal(value, runs["initial"][name])
    assert moved == len(ranks[0]["lora"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_global_norm_clip_matches_optax(runs, mesh):
    grads = runs["grads"]
    res = _ok(runs["ranks"][mesh][0]["clip"])
    tree = {k: jnp.asarray(v.numpy()) for k, v in grads.items()}
    norm, clipped = jax.jit(lambda t: (optax.global_norm(t), optax.clip_by_global_norm(
        1.0).update(t, optax.EmptyState())[0]))(tree)
    want_norm = float(norm)
    assert want_norm > 1.0           # the clip acts
    np.testing.assert_allclose(res["norm"], want_norm, rtol=1e-6)
    assert set(res["grads"]) == set(grads)
    for key, want in clipped.items():
        np.testing.assert_allclose(res["grads"][key].numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-8, err_msg=key)
    for rank in runs["ranks"][mesh]:
        assert _ok(rank["clip"])["norm"] == res["norm"]


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_tp_greedy_decode_gives_the_unplanned_ids(runs, quant):
    """float32 compute: under bf16 the all-reduce sums two rounded partial
    products where one device rounds once, which can flip a near-tie (one row
    of four after three tokens on this batch)."""
    for rank in runs["ranks"]["tp2"]:
        res = _ok(rank[f"decode_{quant}"])
        assert res["plain"].shape[1] == 6
        assert torch.equal(res["tp"], res["plain"])
    whole = runs["single"]["shapes"]["llm.model.layers.0.self_attn.q_proj.kernel"]
    want = (whole[1] // 2, whole[0]) if quant == "float" else (whole[0], whole[1] // 2)
    assert res["q_rows"] == want


@pytest.mark.parametrize("shape", [(4096, 5504), (4096, 2048), (5504, 4096), (2048, 4096)])
def test_int8_plans_take_the_tp2_shapes_at_llama_7b_width(shape):
    K, N = shape
    assert K % 16 == 0 and N % 16 == 0
    for M in (1, 5, 8, 40, 64):
        plan = ic.cluster_plan(M, K, N)
        ic.check_cluster_plan(plan, M, K, N)
    for M in (137, 185, 685, 1480):
        plan = ic.tile_plan(M, K, N)
        assert plan.grid[1] == -(-N // ic.TILE_N) and plan.smem_bytes <= ic.MAX_SMEM_BYTES


def test_dryrun_multichip_four_ranks(runs):
    """The dry run's steps on the module's 4 ranks (``dryrun_multichip``
    spawns its own group; ``test_torch_port_parallel.py`` calls it for 2)."""
    from llm_bci_tpu_torch.entry import dryrun_meshes

    assert "dryrun_multichip(4) OK" in _ok(runs["ranks"]["fsdp2_tp2"][0]["dryrun"])["report"]
    assert dryrun_meshes(4) == ({"data": 2, "fsdp": 2, "sp": 1},
                                {"data": 1, "fsdp": 2, "tp": 2})
