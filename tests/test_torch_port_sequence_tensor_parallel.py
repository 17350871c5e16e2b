"""Sequence parallelism with tensor parallelism (``parallelism.sp`` with
``parallelism.tp``) and ``parallelism.sp_keys`` on gloo CPU ranks, held
against one process of the port and against the JAX trainer.

One group of 4 ranks (``tests/_torch_parallel_worker.py``, spawned once for
the module):

* the debug BCI (int8 base, LoRA on the seven projections) at ``(sp=2,
  tp=2)``: its trunk on the rank's frames, the output gathered over ``sp``,
  the Llama cut over ``tp``; quiet, and with the trunk's dropout, noise and
  LoRA dropout on; the debug PhonemeLLM (no time key: whole over ``sp``, cut
  over ``tp``). 4 steps, float32: losses within rtol 1e-5 of one process,
  parameters within atol 1e-5, the int8 base's bits kept, the LoRA factors
  the same on every rank; the checkpoint written at that mesh resumes in one
  process and equals the ranks' whole state; the quiet BCI within rtol 1e-4
  of the JAX trainer's ``{data: 2, sp: 2, tp: 2}`` run;
* ``clip_by_global_norm`` at ``(sp=2, tp=2)`` against ``optax``;
* ``parallel/mesh.py::fsdp_mesh``'s groups at ``(data, fsdp, sp, tp)`` in
  (1, 1, 2, 2), (1, 2, 2, 1), (2, 1, 1, 2): replicate over ``data x sp``,
  shard over ``fsdp``, each at one ``tp`` index;
* NDT1 ``ctc`` at ``(data=2, sp=2)`` with ``sp_keys`` ``["spikes"]`` and
  with the default list and ``targets`` (no time dim): losses bit-equal to
  the default list's, and within rtol 1e-4 of the JAX trainer's run with the
  same list on the conftest's virtual CPU devices.
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_bci_tpu.config import DictConfig as JaxDictConfig
from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu_torch.interop import bci_state_dict_from_jax, ndt1_state_dict_from_jax
from llm_bci_tpu_torch.parallel.sequence import SP_KEYS

from tests import _torch_parallel_worker as W
from tests.test_bci import synth_bci_dataset
from tests.test_torch_port_sequence_parallel import _rows
from tests.test_torch_port_sequence_parallel_bci import _bci, _phoneme, _phoneme_rows, _plain
from tests.test_torch_port_trainer import trainer_config

STEPS = 4
LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-5, atol=1e-5)
MOMENTS_RTOL = 1e-4
JAX = dict(rtol=1e-4)
SP2_TP2 = {"data": 1, "fsdp": 1, "sp": 2, "tp": 2}
DATA2_SP2 = {"data": 2, "fsdp": 1, "sp": 2}
ONE = {"data": 1, "fsdp": 1}
JAX_SP_TP = {"data": 2, "fsdp": 1, "sp": 2, "tp": 2}
JAX_SP = {"data": 2, "fsdp": 2, "sp": 2}
MESHES = [(1, 1, 2, 2), (1, 2, 2, 1), (2, 1, 1, 2)]
# Leaves with an element whose gradient reads below Adam's eps in a step:
# PhonemeLLM's ``coupler_in.weight`` [1246, 15] at step 1 (-4.7e-9 against
# eps 1e-8), where the update ``lr * g / (|g| + eps)`` follows the rounding
# of ``g``, which the sum over ``tp`` orders otherwise; the port at ``tp=2``
# without ``sp`` gives the same.
ADAM_EPS_LEAVES = {"phoneme": {"coupler_in.weight"}}
SP_KEY_LISTS = {"default": list(SP_KEYS), "spikes": ["spikes"],
                "targets": [*SP_KEYS, "targets"]}

# name: (its config, dataset, parallelism)
CONFIGS = {
    "bci": (lambda tmp: _bci(tmp, False), "bci", SP2_TP2),
    "bci_noisy": (lambda tmp: _bci(tmp, True), "bci", SP2_TP2),
    "phoneme": (_phoneme, "phoneme", SP2_TP2),
    **{f"ndt1_keys_{k}": (lambda tmp: to_plain_dict(trainer_config(tmp)), "ctc42", DATA2_SP2)
       for k in SP_KEY_LISTS},
}


def _jax_trainer(plain, mesh, dataset, bci):
    """A JAX trainer of ``plain`` at ``mesh`` (its weights as a port state
    dict) and its losses' list, filled when it trains."""
    from llm_bci_tpu.models import bci as jbci
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    cfg = copy.deepcopy(plain)
    cfg["parallelism"] = {**cfg["parallelism"], **mesh}
    cfg["training"]["eval_every"] = None
    cfg = JaxDictConfig(cfg)
    model = None
    if bci:
        model = jbci.BCI.from_config(cfg["model"], **cfg["method"]["model_kwargs"]).clone(
            dtype=jnp.float32)
    jt = JaxTrainer(cfg, model=model, dataset=dataset, metric_fns={"rec": record})
    to_port = bci_state_dict_from_jax if bci else ndt1_state_dict_from_jax
    return jt, to_port(jax.device_get(jt.state.params)), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from llm_bci_tpu_torch.training.trainer import build_model

    tmp = tmp_path_factory.mktemp("sequence_tensor_parallel")
    data = {"bci": synth_bci_dataset(n_train=10, n_test=4),
            "phoneme": {"train": _phoneme_rows(8, 0), "test": _phoneme_rows(4, 1)},
            "ctc42": {"train": _rows(8, 2, (30, 40)), "test": _rows(4, 3, (30, 40))}}
    paths = {k: W.dump(v, tmp / f"{k}.pkl") for k, v in data.items()}
    plains = {n: _plain(build(tmp / n), tmp, n) for n, (build, *_) in CONFIGS.items()}
    plains["bci"]["training"]["save_every"] = STEPS
    for k, keys in SP_KEY_LISTS.items():
        plains[f"ndt1_keys_{k}"]["parallelism"]["sp_keys"] = keys
    weights = {n: os.path.join(str(tmp), f"{n}.pt") for n in CONFIGS}

    # the JAX trainers start first: their initial weights are the port's
    jax_runs = {"bci": _jax_trainer(plains["bci"], JAX_SP_TP, data["bci"], True)}
    torch.save(jax_runs["bci"][1], weights["bci"])
    for k in ("spikes", "targets"):
        n = f"ndt1_keys_{k}"
        jax_runs[n] = _jax_trainer(plains[n], JAX_SP, data["ctc42"], False)
    for n in CONFIGS:
        if n.startswith("ndt1_keys_"):
            torch.save(jax_runs["ndt1_keys_spikes"][1], weights[n])
        elif n != "bci":
            torch.manual_seed(0)
            torch.save(build_model(W._config(plains[n], ONE), torch.device("cpu")).state_dict(),
                       weights[n])

    # the clip: a BCI whose Llama trains (no LoRA, float base), seeded
    # weights and gradients
    clip_plain = _plain(_bci(tmp / "clip", False), tmp, "clip")
    clip_plain["method"]["model_kwargs"].update(lora=None, quantize=None)
    torch.manual_seed(0)
    full = build_model(W._config(clip_plain, ONE), torch.device("cpu"))
    clip_weights = os.path.join(str(tmp), "clip.pt")
    torch.save(full.state_dict(), clip_weights)
    rng = np.random.default_rng(3)
    grads = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32) * 0.01)
             for n, p in full.named_parameters() if p.requires_grad}
    grads_path = os.path.join(str(tmp), "grads.pt")
    torch.save(grads, grads_path)

    def case(n, parallelism):
        return dict(plain=copy.deepcopy(plains[n]), parallelism=parallelism,
                    dataset_path=paths[CONFIGS[n][1]], weights_path=weights[n])

    cases = [(n, "train", case(n, par)) for n, (_, _, par) in CONFIGS.items()]
    cases += [("clip", "clip", dict(plain=clip_plain, parallelism=SP2_TP2,
                                    dataset_path=paths["bci"], weights_path=clip_weights,
                                    grads_path=grads_path, max_norm=1.0)),
              ("mesh_groups", "mesh_groups", dict(meshes=MESHES))]
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(W.run_ranks, tmp, 4, cases)
        jax_losses = {}
        for n, (jt, _, losses) in jax_runs.items():
            jt.train()
            jax_losses[n] = losses
        single = {}
        for n in ("bci", "bci_noisy", "phoneme"):
            kw = case(n, ONE)
            kw["plain"]["savestring"] = f"{n}_single"
            kw["plain"]["training"]["save_every"] = None
            single[n] = W.train(**kw)
        ranks = pending.result()
    # the ranks' checkpoint, resumed in one process
    resumed = W.resume(**case("bci", ONE))
    initial = {n: torch.load(weights[n], weights_only=True) for n in ("bci", "bci_noisy")}
    return {"ranks": ranks, "single": single, "jax": jax_losses, "initial": initial,
            "resumed": resumed, "grads": grads}


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


@pytest.mark.parametrize("name", ["bci", "bci_noisy", "phoneme"])
def test_sp_with_tp_trains_as_the_single_process(runs, name):
    single = runs["single"][name]
    coords = {(_ok(r[name])["coords"]["sp"], r[name]["coords"]["tp"]) for r in runs["ranks"]}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for rank in runs["ranks"]:
        res = _ok(rank[name])
        assert res["n_micro"] == STEPS
        np.testing.assert_allclose(res["losses"], single["losses"], **LOSS)
        (ev,) = res["eval"]
        (want,) = single["eval"]
        np.testing.assert_allclose(ev["test_avg_loss"], want["test_avg_loss"], **LOSS)
        # PhonemeLLM's batch has no spikes: every sp rank computes it whole
        assert (res["shard"] is None) == (name == "phoneme")
    _params_close(runs["ranks"][0][name]["model"], single["model"], name)
    W.assert_moments_close(runs["ranks"][0][name]["first_moments"], single["first_moments"],
                           name, MOMENTS_RTOL)


def _params_close(got, want, what):
    """Every leaf within ``PARAMS`` of one process's (the noise-only leaves
    within what Adam can move them, 2 * lr * steps), but for the leaves of
    ``ADAM_EPS_LEAVES``: there at most one element in 10^4 may pass
    ``PARAMS``, held to what Adam can move it, the leaf then within relative
    L2 1e-5."""
    exempt = ADAM_EPS_LEAVES.get(what, set())
    assert exempt <= set(want), (what, sorted(exempt - set(want)))
    W.assert_states_close(got, {k: v for k, v in want.items() if k not in exempt}, what,
                          lr=1e-3, steps=STEPS, **PARAMS)
    for key in exempt:
        a, b = got[key].double(), want[key].double()
        assert torch.allclose(a, b, rtol=0.0, atol=2e-3 * STEPS), (what, key)
        off = ~torch.isclose(a, b, **PARAMS)
        assert int(off.sum()) <= max(1, b.numel() // 10_000), (what, key, int(off.sum()))
        rel = float((a - b).norm() / b.norm())
        assert rel <= 1e-5, (what, key, rel)


@pytest.mark.parametrize("name", ["bci", "bci_noisy", "phoneme"])
def test_tp_shares_and_lora_factors_at_sp2_tp2(runs, name):
    ranks = [_ok(r[name]) for r in runs["ranks"]]
    whole = runs["single"][name]["shapes"]
    q = "llm.model.layers.0.self_attn.q_proj." + ("weight" if name == "phoneme" else "kernel")
    for res in ranks:
        cut = (whole[q][0] // 2, whole[q][1]) if name == "phoneme" else \
            (whole[q][0], whole[q][1] // 2)
        assert res["shapes"][q] == cut
    for key, value in ranks[0]["lora"].items():
        for res in ranks[1:]:
            assert torch.equal(res["lora"][key], value), key


@pytest.mark.parametrize("name", ["bci", "bci_noisy"])
def test_the_int8_base_keeps_its_bits(runs, name):
    state = _ok(runs["ranks"][0][name])["model"]
    frozen = [k for k in runs["initial"][name] if k.endswith(("kernel", "kernel_scale"))]
    assert frozen
    for k in frozen:
        assert torch.equal(state[k], runs["initial"][name][k]), k


def test_checkpoint_at_sp2_tp2_resumes_in_one_process(runs):
    res = _ok(runs["ranks"][0]["bci"])
    resumed = runs["resumed"]
    assert resumed["step"] == STEPS
    assert set(resumed["model"]) == set(res["model"])
    for k, v in res["model"].items():
        assert torch.equal(resumed["model"][k], v), k


def test_sp_with_tp_matches_the_jax_trainer(runs):
    np.testing.assert_allclose(_ok(runs["ranks"][0]["bci"])["losses"][:STEPS],
                               runs["jax"]["bci"], **JAX)


def test_global_norm_clip_at_sp2_tp2_matches_optax(runs):
    grads = runs["grads"]
    res = _ok(runs["ranks"][0]["clip"])
    tree = {k: jnp.asarray(v.numpy()) for k, v in grads.items()}
    norm, clipped = jax.jit(lambda t: (optax.global_norm(t), optax.clip_by_global_norm(
        1.0).update(t, optax.EmptyState())[0]))(tree)
    assert float(norm) > 1.0           # the clip acts
    np.testing.assert_allclose(res["norm"], float(norm), rtol=1e-6)
    assert set(res["grads"]) == set(grads)
    for key, want in clipped.items():
        np.testing.assert_allclose(res["grads"][key].numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-8, err_msg=key)
    for rank in runs["ranks"]:
        assert _ok(rank["clip"])["norm"] == res["norm"]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_fsdp_mesh_groups_keep_each_tp_index(runs, sizes):
    data, fsdp, sp, tp = sizes
    grid = np.arange(4).reshape(data, fsdp, sp, tp)
    for r, rank in enumerate(runs["ranks"]):
        got = _ok(rank["mesh_groups"])[sizes]
        d, f, s, t = (int(i[0]) for i in np.nonzero(grid == r))
        assert got["replicate"] == grid[:, f, :, t].flatten().tolist()
        assert got["shard"] == grid[d, :, s, t].tolist()
        assert got["tp"] == grid[d, f, s, :].tolist()


@pytest.mark.parametrize("keys", ["spikes", "targets"])
def test_any_sp_keys_list_gives_the_default_lists_results(runs, keys):
    default = _ok(runs["ranks"][0]["ndt1_keys_default"])
    for rank in runs["ranks"]:
        res = _ok(rank[f"ndt1_keys_{keys}"])
        assert res["shard"] is not None
        assert res["losses"] == default["losses"]
        assert res["pred_shapes"] == default["pred_shapes"]
    got = _ok(runs["ranks"][0][f"ndt1_keys_{keys}"])
    np.testing.assert_allclose(got["losses"][:STEPS], runs["jax"][f"ndt1_keys_{keys}"], **JAX)
    for k, v in default["model"].items():
        assert torch.equal(got["model"][k], v), k
