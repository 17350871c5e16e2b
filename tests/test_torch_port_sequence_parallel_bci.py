"""Sequence parallelism (``parallelism.sp``) of BCI, PhonemeLLM and NDT1 with
its day and block prefix tokens on gloo CPU ranks, held against one process
of the port and against the JAX trainer's ``sp`` run.

* pure functions: NDT1's embedding with day and block tokens on a shard
  (prefix on shard 0, kept in the other shards' graphs with a zero
  gradient) equals the rows of the whole sequence's, stacked and unstacked;
* one group of 4 ranks (``tests/_torch_parallel_worker.py``, spawned once
  for the module) trains 4 steps, float32: the debug BCI (int8 base, LoRA on
  the seven projections, the trunk stacked 4/2 and its frames regrouped by a
  projector stacking of 2) at ``(data=2, sp=2)`` with the stochastic parts
  off and, with a block token, the trunk's dropout, smoothing noise and LoRA
  dropout on, at ``(data=1, fsdp=2, sp=2)``; the debug PhonemeLLM (no
  time-dim key: whole on every rank, its loss not scaled); NDT1 ``ctc``
  (stacked) with day and block tokens at ``(data=2, sp=2)``, and ``mlm`` and
  ``ctc`` (stack 32/4) with them and the stochastic parts on at ``(data=1,
  fsdp=2, sp=2)``. Losses within rtol 1e-5 of one process, parameters within
  atol 1e-5 (the key bias, whose gradient is rounding noise, within what
  Adam can move it), the int8 base's bits kept, the eval after the last step
  equal to one process's;
* the quiet BCI, PhonemeLLM and NDT1 ``ctc`` runs at ``(data=2, sp=2)``
  against the JAX trainer's ``{data: 2, fsdp: 2, sp: 2}`` run from the same
  weights on the conftest's virtual CPU devices (rtol 1e-4).
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu_torch.interop import (
    bci_state_dict_from_jax,
    ndt1_state_dict_from_jax,
    phoneme_llm_state_dict_from_jax,
)
from llm_bci_tpu_torch.models.ndt1 import NeuralEmbeddingLayer, sequence_layout

from tests import _torch_parallel_worker as W
from tests.test_bci import synth_bci_dataset
from tests.test_torch_port_bci import LORA
from tests.test_torch_port_bci import trainer_config as bci_trainer_config
from tests.test_torch_port_sequence_parallel import _ctc324, _mlm, _noisy, _rows
from tests.test_torch_port_trainer import V, trainer_config

STEPS = 4
LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=0.0, atol=1e-5)
MOMENTS_RTOL = 1e-4
JAX = dict(rtol=1e-4)
SP2 = {"data": 1, "fsdp": 2, "sp": 2}
DATA2_SP2 = {"data": 2, "fsdp": 1, "sp": 2}
ONE = {"data": 1, "fsdp": 1}
JAX_MESH = {"data": 2, "fsdp": 2, "sp": 2}


# ------------------------------------------------------------ pure functions

@pytest.mark.parametrize("stack", [None, {"active": True, "size": 4, "stride": 2,
                                          "pad_to_multiple": 1}], ids=["bins", "stacked"])
def test_prefix_tokens_of_a_shard_are_the_wholes_rows(stack):
    torch.manual_seed(0)
    emb = NeuralEmbeddingLayer(hidden_size=8, n_channels=5, n_blocks=3, n_days=2, max_F=64,
                               input_dim=4, adapt=False, day_token=True, block_token=True,
                               pos=True, act="softsign", use_bias=True, dropout=0.3,
                               stack_active=bool(stack), stack_size=4, stack_stride=2)
    T = 20
    rng = np.random.default_rng(0)
    spikes = torch.from_numpy(rng.poisson(1.0, size=(2, T, 5)).astype(np.float32))
    mask = torch.ones(2, T, dtype=torch.int64)
    mask[1, 15:] = 0
    ts = torch.arange(T)[None].expand(2, T)
    block, day = torch.tensor([2, 0]), torch.tensor([1, 0])
    x, m, _ = emb(spikes, mask, ts, block, day, torch.Generator().manual_seed(3))
    for i in range(2):
        shard = sequence_layout(T, 2, i, 0, stack, prefix=2)
        sl = shard.slices
        xs, ms, _ = emb(spikes[:, slice(*sl["spikes"])], mask[:, slice(*sl["spikes_mask"])],
                        ts[:, slice(*sl["spikes_timestamp"])], block, day,
                        torch.Generator().manual_seed(3), seq_shard=shard)
        t0, t1 = shard.token_range
        assert shard.tokens == x.shape[1] and xs.shape[1] == t1 - t0
        assert (t0 == 0) == (i == 0) and shard.local_prefix == (2 if i == 0 else 0)
        torch.testing.assert_close(xs, x[:, t0:t1], rtol=1e-5, atol=1e-6)
        assert torch.equal(ms, m[:, t0:t1])
        # shard 1 keeps the tables in its graph: a zero gradient, not none
        xs.sum().backward()
        grads = (emb.day_embedding.weight.grad, emb.block_embedding.weight.grad)
        assert all(g is not None for g in grads)
        if i == 1:
            assert not any(g.any() for g in grads)
        emb.zero_grad(set_to_none=True)


# ---------------------------------------------------------- multi-rank runs

def _bci(tmp, noisy):
    cfg = to_plain_dict(bci_trainer_config(tmp, "int8"))
    if noisy:
        enc = cfg["model"]["ndt1"]["encoder"]
        enc["smooth_and_noise"] = {"noise": True, "smooth_sd": 1.5, "white_noise_sd": 0.5,
                                   "constant_offset_sd": 0.2}
        enc["embedder"]["dropout"] = 0.2
        enc["embedder"]["block_token"] = True
        enc["transformer"]["dropout"] = 0.3
        cfg["method"]["model_kwargs"]["lora"] = dict(LORA, dropout=0.1)
    return cfg


PH_L, PH_P, PH_V = 8, 6, 41


def _phoneme_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        ids = rng.integers(3, 32000, size=(PH_L,))
        probs = rng.dirichlet(np.ones(PH_V), size=PH_P).astype(np.float32)
        mask = np.ones(PH_P, np.int64)
        mask[int(rng.integers(4, PH_P + 1)):] = 0
        rows.append({"spikes": probs, "phoneme_probs": probs, "phonemes_mask": mask,
                     "input_ids": ids, "attention_mask": np.ones(PH_L, np.int64),
                     "input_split": np.atleast_1d(2),
                     "targets": np.where(np.arange(PH_L) >= 5, ids, -100)})
    return rows


def _phoneme(tmp):
    cfg = to_plain_dict(bci_trainer_config(tmp, None))
    cfg["model"] = {"model_class": "PhonemeLLM"}
    cfg["data"] = {"dataset_class": "base"}
    cfg["method"]["model_kwargs"] = {"method_name": "endtoend", "debug": True,
                                     "lora": dict(LORA)}
    cfg["method"]["dataset_kwargs"] = {}
    cfg["method"]["dataloader_kwargs"]["pad_dict"] = {}
    return cfg


def _prefixed(cfg):
    cfg = to_plain_dict(cfg)
    cfg["model"]["encoder"]["embedder"].update(day_token=True, block_token=True)
    return cfg


def _plain(cfg, tmp, tag):
    plain = to_plain_dict(cfg)
    plain["savestring"] = tag
    plain["dirs"]["checkpoint_dir"] = str(tmp / "ck")
    plain["training"].update(max_steps=STEPS, num_epochs=4, save_every=None, eval_every=STEPS,
                             save_on_preemption=False)
    return plain


# name: (its config, dataset, parallelism, compared with the JAX trainer)
CONFIGS = {
    "bci": (lambda tmp: _bci(tmp, False), "bci", DATA2_SP2, True),
    "bci_noisy": (lambda tmp: _bci(tmp, True), "bci", SP2, False),
    "phoneme": (_phoneme, "phoneme", DATA2_SP2, True),
    "ndt1_prefix_ctc": (lambda tmp: _prefixed(trainer_config(tmp)), "ctc42", DATA2_SP2, True),
    "ndt1_prefix_mlm_noisy": (lambda tmp: _noisy(_prefixed(_mlm(tmp))), "mlm", SP2, False),
    "ndt1_prefix_ctc324_noisy": (lambda tmp: _noisy(_prefixed(_ctc324(tmp))), "ctc324", SP2,
                                 False),
}


def _jax_run(name, plain, dataset):
    """The JAX trainer's ``sp=2`` run: its initial weights as a port state
    dict and its per-step losses."""
    from llm_bci_tpu.config import DictConfig as JaxDictConfig
    from llm_bci_tpu.models import bci as jbci
    from llm_bci_tpu.models import phoneme_llm as jphon
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    cfg = copy.deepcopy(plain)
    cfg["parallelism"] = dict(JAX_MESH)
    cfg["training"]["eval_every"] = None
    cfg = JaxDictConfig(cfg)
    model, to_port = None, ndt1_state_dict_from_jax
    kwargs = cfg["method"]["model_kwargs"]
    if name == "bci":
        model = jbci.BCI.from_config(cfg["model"], **kwargs).clone(dtype=jnp.float32)
        to_port = bci_state_dict_from_jax
    elif name == "phoneme":
        model = jphon.PhonemeLLM.from_config({}, debug=True, lora=dict(LORA)).clone(
            dtype=jnp.float32)
        to_port = phoneme_llm_state_dict_from_jax
    jt = JaxTrainer(cfg, model=model, dataset=dataset, metric_fns={"rec": record})
    state = to_port(jax.device_get(jt.state.params))
    jt.train()
    return state, losses, jt.mesh.shape["sp"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from llm_bci_tpu_torch.training.trainer import build_model

    tmp = tmp_path_factory.mktemp("sequence_parallel_bci")
    data = {"bci": synth_bci_dataset(n_train=10, n_test=4),
            "phoneme": {"train": _phoneme_rows(8, 0), "test": _phoneme_rows(4, 1)},
            "mlm": {"train": _rows(8, 0, (10, 32)), "val": _rows(4, 1, (10, 32))},
            "ctc42": {"train": _rows(8, 2, (30, 40)), "test": _rows(4, 3, (30, 40))},
            "ctc324": {"train": _rows(8, 4, (40, 64)), "test": _rows(4, 5, (40, 64))}}
    paths = {k: W.dump(v, tmp / f"{k}.pkl") for k, v in data.items()}
    plains = {n: _plain(build(tmp / n), tmp, n) for n, (build, *_) in CONFIGS.items()}
    weights = {n: os.path.join(str(tmp), f"{n}.pt") for n in CONFIGS}
    jax_results = {}
    for n, (_, key, _, jax_too) in CONFIGS.items():
        if jax_too:
            state, losses, sp_axis = _jax_run(n, plains[n], data[key])
            jax_results[n] = (losses, sp_axis)
        else:
            torch.manual_seed(0)
            state = build_model(W._config(plains[n], ONE), torch.device("cpu")).state_dict()
        torch.save(state, weights[n])

    def case(n, parallelism, tag):
        plain = copy.deepcopy(plains[n])
        plain["savestring"] = tag
        return dict(plain=plain, parallelism=parallelism,
                    dataset_path=paths[CONFIGS[n][1]], weights_path=weights[n])

    cases = [(n, "train", case(n, par, n)) for n, (_, _, par, _) in CONFIGS.items()]
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(W.run_ranks, tmp, 4, cases)
        single = {n: W.train(**case(n, ONE, f"{n}_single")) for n in CONFIGS}
        ranks = ranks.result()
    initial = {n: torch.load(weights[n], weights_only=True) for n in ("bci", "bci_noisy")}
    return {"ranks": ranks, "single": single, "jax": jax_results, "initial": initial}


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sp_trains_as_the_single_process(runs, name):
    single = runs["single"][name]
    for rank in runs["ranks"]:
        res = _ok(rank[name])
        assert res["n_micro"] == STEPS
        np.testing.assert_allclose(res["losses"], single["losses"], **LOSS)
        (ev,) = res["eval"]
        (want,) = single["eval"]
        np.testing.assert_allclose(ev["test_avg_loss"], want["test_avg_loss"], **LOSS)
        assert res["pred_shapes"] == single["pred_shapes"]
        # PhonemeLLM's batch has no spikes: every rank computes it whole
        assert (res["shard"] is None) == (name == "phoneme")
    W.assert_states_close(runs["ranks"][0][name]["model"], single["model"], name, lr=1e-3,
                          steps=STEPS, **PARAMS)
    # the gradients themselves (Adam's update hides a factor on them)
    W.assert_moments_close(runs["ranks"][0][name]["first_moments"], single["first_moments"],
                           name, MOMENTS_RTOL)


@pytest.mark.parametrize("name", ["bci", "bci_noisy"])
def test_the_int8_base_keeps_its_bits(runs, name):
    state = _ok(runs["ranks"][0][name])["model"]
    frozen = [k for k in runs["initial"][name] if k.endswith(("kernel", "kernel_scale"))]
    assert frozen
    for k in frozen:
        assert torch.equal(state[k], runs["initial"][name][k]), k


def test_prefix_tokens_count_on_shard_zero(runs):
    for rank in runs["ranks"]:
        res = _ok(rank["ndt1_prefix_ctc"])
        # 40 bins stack (4/2) to 19 frames, 10 / 9 a rank; the two prefix
        # tokens are shard 0's
        want = {0: ((0, 12), 21), 1: ((12, 21), 21)}[res["coords"]["sp"]]
        assert res["shard"] == want
        # the metric fns see the log-probs of the 19 frames, gathered over
        # sp, and the 4 rows, gathered over data
        assert set(res["pred_shapes"]) == {(4, 19, V)}


@pytest.mark.parametrize("name", sorted(n for n, c in CONFIGS.items() if c[3]))
def test_sp_matches_the_jax_trainers_sp_run(runs, name):
    losses, sp_axis = runs["jax"][name]
    assert sp_axis == 2 and len(losses) == STEPS
    # the port's run evaluates after its last step: its metric fn sees the
    # eval batches too
    np.testing.assert_allclose(_ok(runs["ranks"][0][name])["losses"][:STEPS], losses, **JAX)
