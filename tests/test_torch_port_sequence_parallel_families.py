"""Sequence parallelism (``parallelism.sp``) of iTransformer and PatchTST on
gloo CPU ranks, held against one process of the port and against the JAX
trainer's ``sp`` run.

* pure functions: PatchTST's patch ownership (near-even patch parts, the
  bins each rank owns for the scaling statistics partition the sequence, a
  rank's patches from its read range equal the whole's), the univariate
  transformer's CLS as shard 0's prefix token;
* one group of 4 ranks (``tests/_torch_parallel_worker.py``, spawned once
  for the module): the collectives on pairs of ranks (a row-parallel time
  embedding against the whole product, BatchNorm synced over two ranks
  against whole-batch statistics, forward and backward, the running averages,
  a broadcast from shard 0); iTransformer ``mlm`` / ``ctc`` /
  ``stat_behaviour`` in both embedder modes and PatchTST ``mlm`` / ``ctc``
  (BatchNorm, ``std`` scaling; ``ctc`` also with LayerNorm and ``mean``
  scaling) trained 4 steps, float32: at ``(data=1,
  fsdp=2, sp=2)`` with the stochastic parts on (dropout, a random masker,
  PatchTST's masking noise) and at ``(data=2, sp=2)`` with them off
  (PatchTST ``mlm``'s masking noise fixed), losses within rtol 1e-5 of one
  process and parameters within atol 1e-5 (the key bias, whose gradient is
  rounding noise, within what Adam can move it), BatchNorm's running
  averages equal on every rank; the metric fns see whole outputs and the
  eval after the last step matches one process's;
* the quiet iTransformer ``mlm`` (``mlp`` embedder) and ``ctc``
  (``transformer`` embedder) and PatchTST ``mlm`` / ``ctc`` at ``(data=2,
  sp=2)`` against the JAX trainer's ``{data: 2, fsdp: 2, sp: 2}`` run from
  the same weights on the conftest's virtual CPU devices (rtol 1e-4).
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu_torch.interop import itransformer_state_dict_from_jax, patchtst_state_dict_from_jax
from llm_bci_tpu_torch.models import patchtst as tpt
from llm_bci_tpu_torch.models.itransformer import UnivariateTransformer
from llm_bci_tpu_torch.models.ndt1 import sequence_layout

from tests import _torch_parallel_worker as W

STEPS = 4
LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=0.0, atol=1e-5)
MOMENTS_RTOL = 1e-4
JAX = dict(rtol=1e-4)
SP2 = {"data": 1, "fsdp": 2, "sp": 2}
DATA2_SP2 = {"data": 2, "fsdp": 1, "sp": 2}
ONE = {"data": 1, "fsdp": 1}
JAX_MESH = {"data": 2, "fsdp": 2, "sp": 2}
T, N, V = 12, 6, 7              # iTransformer bins, channels; the CTC vocabulary
PT_T, PT_C, PT_L = 24, 4, 4     # PatchTST bins, channels, patch length = stride


# ------------------------------------------------------------ pure functions

@pytest.mark.parametrize("T_,L,S,n_sp", [(520, 10, 10, 2), (24, 6, 4, 2), (23, 3, 5, 2),
                                         (24, 4, 4, 3)],
                         ids=["patchtst_yaml", "overlap", "gaps", "three"])
def test_patch_layout_owns_every_bin_once_and_reads_its_patches(T_, L, S, n_sp):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, T_, 3)).astype(np.float32))
    whole = tpt.patchify(x, L, S)
    P = whole.shape[2]
    owned = []
    for i in range(n_sp):
        shard = tpt.patch_layout(T_, n_sp, i, L, S)
        p0, p1 = shard.token_range
        assert shard.tokens == P and abs((p1 - p0) - P / n_sp) < 1
        owned.append(shard.computed)
        lo, hi = shard.slices["spikes"]
        got = tpt.patchify(x[:, lo:hi], L, S)[:, :, :p1 - p0]
        assert torch.equal(got, whole[:, :, p0:p1])
    assert owned[0][0] == 0 and owned[-1][1] == T_
    assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))
    if (T_, L, S) == (520, 10, 10):     # configs/patchtst.yaml: 26 / 26, no halo
        assert [tpt.patch_layout(T_, 2, i, L, S).slices["spikes"] for i in range(2)] == [
            (0, 260), (260, 520)]
    with pytest.raises(ValueError, match="leaves a rank no patch"):
        tpt.patch_layout(8, 4, 0, 4, 4)


def test_univariate_cls_is_shard_zeros_prefix():
    shards = [sequence_layout(T, 2, i, prefix=1) for i in range(2)]
    assert [s.token_range for s in shards] == [(0, 7), (7, 13)]
    assert [s.local_prefix for s in shards] == [1, 0]
    assert [s.body().token_range for s in shards] == [(0, 6), (6, 12)]
    assert all(s.tokens == T + 1 and s.body().tokens == T for s in shards)
    # one process: the CLS output of each channel's sequence
    torch.manual_seed(0)
    uni = UnivariateTransformer(8, 2, 1, "relu", 0.0, T).eval()
    x = torch.randn(2, T, 3)
    assert uni(x, None).shape == (2, 3, 8)


def test_masked_patches_of_a_part_are_the_wholes():
    rng = np.random.default_rng(1)
    patches = torch.from_numpy(rng.normal(size=(2, 3, 9, 4)).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(size=(2, 3, 9)).astype(np.float32))
    whole, wmask = tpt.random_patch_masking(patches, noise, 0.4, 0.0)
    part, pmask = tpt.random_patch_masking(patches[:, :, 5:], noise, 0.4, 0.0, start=5)
    assert torch.equal(part, whole[:, :, 5:]) and torch.equal(pmask, wmask[:, :, 5:])


# ---------------------------------------------------------- multi-rank runs

def _pad(n):
    return {"dim": 0, "side": "left", "value": 0, "truncate": n, "min_length": n}


def itr_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        S = int(rng.integers(2, 4))
        idx = rng.integers(1, V, size=S)
        rows.append({"spikes": rng.poisson(1.0, size=(int(rng.integers(9, T + 1)), N)).astype(
            np.float32), "choice": np.atleast_1d(int(rng.integers(0, 2))),
            "phonemes_idx": idx, "phonemes": ["P"] * S, "sentence": f"t{seed} {i}"})
    return rows


def pt_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        S = int(rng.integers(2, 4))
        rows.append({"spikes": rng.poisson(1.0, size=(int(rng.integers(18, PT_T + 1)), PT_C)
                                           ).astype(np.float32),
                     "phonemes_idx": rng.integers(1, V, size=S), "phonemes": ["P"] * S,
                     "sentence": f"p{seed} {i}"})
    return rows


def _base(tmp, tag, model, method_kwargs, dataset_class, dataset_kwargs, pads):
    return {
        "seed": 2, "savestring": tag, "verbosity": 3,
        "dirs": {"checkpoint_dir": str(tmp / "ck"), "log_dir": None},
        "training": {"num_epochs": 4, "train_batch_size": 4, "test_batch_size": 4,
                     "max_steps": STEPS, "eval_every": STEPS, "save_every": None,
                     "save_on_preemption": False},
        "parallelism": {"data": 1, "fsdp": -1},
        "precision": {"compute_dtype": "float32"},
        "model": model,
        "data": {"dataset_class": dataset_class},
        "method": {"model_kwargs": method_kwargs, "dataset_kwargs": dataset_kwargs,
                   "dataloader_kwargs": {"pad_dict": pads}, "metric_kwargs": {}},
        "optimizer": {"lr": 1e-3, "wd": 0.01, "scheduler": "cosine", "warmup_pct": 0.15},
    }


def itr_config(tmp, method, mode, noisy):
    """iTransformer at a debug width; ``noisy``: dropout in the embedder and
    the stack, and for ``mlm`` a random neuron masker with random
    replacement (else the deterministic ``co-smooth`` masker)."""
    drop = 0.2 if noisy else 0.0
    masker = {"active": False}
    if method == "mlm":
        masker = ({"active": True, "force_active": True, "mode": "neuron", "ratio": 0.3,
                   "zero_ratio": 0.5, "random_ratio": 0.5} if noisy else
                  {"active": True, "force_active": True, "mode": "co-smooth", "channels": [1, 4],
                   "zero_ratio": 1.0})
    kwargs = {"mlm": {"loss": "poisson_nll", "log_input": True},
              "ctc": {"vocab_size": V, "blank_id": 0, "zero_infinity": True},
              "stat_behaviour": {"loss": "xent", "n_labels": 2}}[method]
    pads = {k: _pad(T) for k in ("spikes", "spikes_mask", "spikes_timestamp")}
    dataset_kwargs = {}
    if method == "ctc":
        pads["targets"] = {"dim": 0, "side": "right", "value": 0, "truncate": None,
                           "min_length": None}
        dataset_kwargs = {"targets_name": "phonemes_idx"}
    elif method == "stat_behaviour":
        dataset_kwargs = {"targets_name": "choice"}
    model = {
        "model_class": "iTransformer", "masker": {"main": masker},
        "encoder": {"embedder": {"mode": mode, "max_n_bins": T, "dropout": drop, "hidden_size": 8,
                                 "n_heads": 2, "n_layers": 2},
                    "hidden_size": 16, "n_heads": 2, "n_layers": 2, "dropout": drop,
                    "max_n_channels": 8, "embed_region": False, "embed_depth": False},
        "decoder": {"mlp_decoder": True, "use_cls": True},
    }
    return _base(tmp, f"itr_{method}_{mode}", model, {"method_name": method, **kwargs},
                 "base" if method == "mlm" else "decoding", dataset_kwargs, pads)


def pt_config(tmp, method, noisy, norm="batchnorm", scaling="std"):
    """PatchTST at a debug width, with BatchNorm and ``std`` scaling by
    default; ``noisy``: every dropout on and, for ``ctc``, patch masking
    too."""
    drop = 0.2 if noisy else 0.0
    pads = {k: _pad(PT_T) for k in ("spikes", "spikes_mask", "spikes_timestamp")}
    dataset_kwargs = {}
    if method == "ctc":
        pads["targets"] = {"dim": 0, "side": "right", "value": 0, "truncate": None,
                           "min_length": None}
        dataset_kwargs = {"targets_name": "phonemes_idx"}
    model = {
        "model_class": "PatchTST",
        "encoder": {"num_input_channels": PT_C, "context_length": PT_T, "patch_length": PT_L,
                    "patch_stride": PT_L, "num_hidden_layers": 2, "d_model": 16,
                    "num_attention_heads": 2, "ffn_dim": 32, "norm_type": norm,
                    "scaling": scaling, "attention_dropout": drop, "ff_dropout": drop,
                    "positional_dropout": drop, "path_dropout": drop,
                    "do_mask_input": method == "mlm" or noisy, "random_mask_ratio": 0.4},
        "decoder": {"head_dropout": drop},
    }
    return _base(tmp, f"pt_{method}", model, {"method_name": method, "loss": "poisson_nll",
                                              "log_input": True, "vocab_size": V},
                 "base" if method == "mlm" else "decoding", dataset_kwargs, pads)


ITR = [(m, e) for m in ("mlm", "ctc", "stat_behaviour") for e in ("mlp", "transformer")]
# name: (its config, dataset, compared with the JAX trainer)
CONFIGS = {}
for _m, _e in ITR:
    CONFIGS[f"itr_{_m}_{_e}"] = (lambda tmp, m=_m, e=_e: itr_config(tmp, m, e, False), "itr",
                                 (_m, _e) in (("mlm", "mlp"), ("ctc", "transformer")))
    CONFIGS[f"itr_{_m}_{_e}_noisy"] = (lambda tmp, m=_m, e=_e: itr_config(tmp, m, e, True), "itr",
                                       False)
for _m in ("mlm", "ctc"):
    CONFIGS[f"pt_{_m}"] = (lambda tmp, m=_m: pt_config(tmp, m, False), "pt", True)
    CONFIGS[f"pt_{_m}_noisy"] = (lambda tmp, m=_m: pt_config(tmp, m, True), "pt", False)
# ``mean`` scaling's statistic summed over sp, LayerNorm (no statistic across rows)
CONFIGS["pt_ctc_mean_layernorm"] = (
    lambda tmp: pt_config(tmp, "ctc", False, "layernorm", "mean"), "pt", False)


def _jax_run(plain, dataset, fixed_noise):
    """The JAX trainer's ``sp=2`` run of ``plain``: its initial weights as a
    port state dict and its per-step losses."""
    from llm_bci_tpu.config import DictConfig as JaxDictConfig
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    cfg = copy.deepcopy(plain)
    cfg["parallelism"] = dict(JAX_MESH)
    cfg["training"]["eval_every"] = None
    jt = JaxTrainer(JaxDictConfig(cfg), dataset=dataset, metric_fns={"rec": record})
    if plain["model"]["model_class"] == "PatchTST":
        state = patchtst_state_dict_from_jax(jax.device_get(
            {"params": jt.state.params, **jt.state.extra_vars}))
    else:
        state = itransformer_state_dict_from_jax(jax.device_get(jt.state.params))
    real = jax.random.uniform
    if fixed_noise:
        jax.random.uniform = lambda key, shape, *a, **k: jnp.asarray(W.fixed_uniform(shape))
    try:
        jt.train()
    finally:
        jax.random.uniform = real
    return state, losses, jt.mesh.shape["sp"]


def _seeded_weights(plain):
    from llm_bci_tpu_torch.training.trainer import build_model

    torch.manual_seed(0)
    return build_model(W._config(plain, ONE), torch.device("cpu")).state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence_parallel_families")
    data = {"itr": {"train": itr_rows(8, 0), "test": itr_rows(4, 1)},
            "pt": {"train": pt_rows(8, 2), "test": pt_rows(4, 3)}}
    paths = {k: W.dump(v, tmp / f"{k}.pkl") for k, v in data.items()}
    plains = {name: build(tmp) for name, (build, _, _) in CONFIGS.items()}
    rng = np.random.default_rng(5)
    coll = dict(x=torch.from_numpy(rng.normal(size=(2, 3, T)).astype(np.float32)),
                weight=torch.from_numpy(rng.normal(size=(5, T)).astype(np.float32)),
                bias=torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)),
                bn_x=torch.from_numpy(rng.normal(1.0, 2.0, size=(3, T, 4)).astype(np.float32)),
                bn_grad=torch.from_numpy(rng.normal(size=(3, T, 4)).astype(np.float32)))

    def kind(name, fixed):
        return "train_fixed_noise" if fixed and name == "pt_mlm" else "train"

    def case(name, parallelism, weights_path):
        plain = copy.deepcopy(plains[name])
        return dict(plain=plain, parallelism=parallelism,
                    dataset_path=paths[CONFIGS[name][1]], weights_path=weights_path)

    # the JAX-compared configs take the JAX trainer's initial weights: those
    # runs start first, in this process
    jax_names = [n for n, (_, _, j) in CONFIGS.items() if j]
    weights = {n: os.path.join(str(tmp), f"{n}.pt") for n in CONFIGS}
    for n in CONFIGS:
        if n not in jax_names:
            torch.save(_seeded_weights(plains[n]), weights[n])
    jax_results = {}
    with ThreadPoolExecutor(max_workers=1) as pool:
        for n in jax_names:
            state, losses, sp_axis = _jax_run(plains[n], data[CONFIGS[n][1]], n == "pt_mlm")
            torch.save(state, weights[n])
            jax_results[n] = (losses, sp_axis)
        cases = [("collectives", "collectives", coll)]
        for n in CONFIGS:
            par = SP2 if n.endswith("_noisy") else DATA2_SP2
            cases.append((n, kind(n, True), case(n, par, weights[n])))
        pending = pool.submit(W.run_ranks, tmp, 4, cases)
        single = {}
        for n in CONFIGS:
            kw = case(n, ONE, weights[n])
            kw["plain"]["savestring"] = f"{n}_single"
            single[n] = getattr(W, kind(n, True))(**kw)
        ranks = pending.result()
    return {"ranks": ranks, "single": single, "jax": jax_results, "coll": coll}


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
        # BatchNorm's running averages move alike on every rank
        for k, v in single["buffers"].items():
            torch.testing.assert_close(res["buffers"][k], v, rtol=1e-5, atol=1e-6)
        # the eval after the last step
        (ev,) = res["eval"]
        (want,) = single["eval"]
        np.testing.assert_allclose(ev["test_avg_loss"], want["test_avg_loss"], **LOSS)
        # the metric fns see whole outputs
        assert res["pred_shapes"] == single["pred_shapes"]
        assert res["shard"] is not None
    _close(runs["ranks"][0][name]["model"], single["model"], name)
    # the gradients themselves (Adam's update hides a factor on them)
    W.assert_moments_close(runs["ranks"][0][name]["first_moments"], single["first_moments"],
                           name, MOMENTS_RTOL)


def _close(got, want, what):
    """``W.assert_states_close``, a fused ``qkv`` bias split in three: its
    key third gets a gradient that is rounding noise, held to what Adam can
    move it (``W.NOISE_ONLY``)."""
    got, want = dict(got), dict(want)
    for key in [k for k in want if k.endswith("qkv.bias")]:
        for name, g, w in zip(("query", "key", "value"), got.pop(key).chunk(3),
                              want.pop(key).chunk(3)):
            got[f"{key}.attn.{name}.bias"], want[f"{key}.attn.{name}.bias"] = g, w
    W.assert_states_close(got, want, what, lr=1e-3, steps=STEPS, **PARAMS)


def test_sp_shards_split_the_time_axis(runs):
    for rank in runs["ranks"]:
        sp = rank["itr_ctc_transformer_noisy"]["coords"]["sp"]
        # 12 bins and the univariate CLS: 7 / 6 tokens
        assert _ok(rank["itr_ctc_transformer_noisy"])["shard"] == (((0, 7), (7, 13))[sp], 13)
        assert _ok(rank["itr_mlm_mlp"])["shard"] == (
            ((0, 6), (6, 12))[rank["itr_mlm_mlp"]["coords"]["sp"]], 12)
        # 24 bins, patches of 4: 3 / 3 patches
        assert _ok(rank["pt_ctc"])["shard"][1] == 6
    assert set(runs["single"]["itr_mlm_mlp"]["pred_shapes"]) == {(4, T, N)}
    assert set(runs["single"]["pt_mlm"]["pred_shapes"]) == {(4, PT_C, PT_T // PT_L, PT_L)}
    assert set(runs["single"]["pt_ctc"]["pred_shapes"]) == {(4, PT_T // PT_L, V)}


@pytest.mark.parametrize("name", sorted(n for n, (_, _, j) in CONFIGS.items() if j))
def test_sp_matches_the_jax_trainers_sp_run(runs, name):
    losses, sp_axis = runs["jax"][name]
    assert sp_axis == 2 and len(losses) == STEPS
    # the port's run evaluates after its last step: its metric fn sees the
    # eval batches too
    np.testing.assert_allclose(_ok(runs["ranks"][0][name])["losses"][:STEPS], losses, **JAX)


def test_row_parallel_embedding_equals_the_whole_product(runs):
    c = runs["coll"]
    layer = torch.nn.Linear(T, 5)
    with torch.no_grad():
        layer.weight.copy_(c["weight"])
        layer.bias.copy_(c["bias"])
    want = layer(c["x"])
    want.sum().backward()
    for rank in runs["ranks"]:
        res = _ok(rank["collectives"])
        torch.testing.assert_close(res["linear"], want.detach(), rtol=1e-6, atol=1e-6)
        # every rank holds the whole loss: the bias, added once after the sum,
        # gets the whole gradient on each rank; the weight's columns of the
        # rank get the gradient summed over the pair (2x its part, zeros
        # elsewhere): FSDP2's average over the pair is the whole's either way
        torch.testing.assert_close(res["bias_grad"], layer.bias.grad)
        t0, t1 = ((0, 6), (6, 12))[res["index"]]
        torch.testing.assert_close(res["weight_grad"][:, t0:t1],
                                   2 * layer.weight.grad[:, t0:t1])
        assert not res["weight_grad"][:, :t0].any() and not res["weight_grad"][:, t1:].any()


def test_synced_batchnorm_equals_whole_batch_statistics(runs):
    c = runs["coll"]
    bn = tpt.FlaxBatchNorm(4)
    x = c["bn_x"].clone().requires_grad_(True)
    out = bn(x)
    (out * c["bn_grad"]).sum().backward()
    for r, rank in enumerate(runs["ranks"]):
        res = _ok(rank["collectives"])
        t0, t1 = ((0, 6), (6, 12))[res["index"]]
        torch.testing.assert_close(res["bn"], out.detach()[:, t0:t1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(res["bn_x_grad"], x.grad[:, t0:t1], rtol=1e-4, atol=1e-5)
        # each rank's parameter gradients are its rows' part: the pair's sum
        # is the whole's
        other = runs["ranks"][r ^ 1]["collectives"]
        torch.testing.assert_close(res["bn_weight_grad"] + other["bn_weight_grad"],
                                   bn.weight.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(res["bn_bias_grad"] + other["bn_bias_grad"], bn.bias.grad,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(res["running"][0], bn.running_mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(res["running"][1], bn.running_var, rtol=1e-5, atol=1e-6)
        # the broadcast: the pair's first rank's value on both
        assert torch.equal(res["broadcast"], torch.full((3,), float(r - res["index"])))
