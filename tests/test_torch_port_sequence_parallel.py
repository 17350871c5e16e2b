"""Sequence parallelism of the port (``parallelism.sp``) on gloo CPU ranks,
NDT1 held against one process and against the JAX trainer's ``sp`` run.

* pure functions: a rank's time range and the near-even frame split, the
  layout of bins, frames and halo; smoothing, ``StackProjection`` and the
  masker on a shard plus its halo equal the whole sequence's result, sliced
  (T' = 121 included); dense attention of a query shard with its offset
  against whole K / V equals the rows of full attention (banded and
  unbanded); ``dryrun_meshes`` picks the JAX dry run's ``(data, fsdp, sp)``;
* one group of 4 ranks (``tests/_torch_parallel_worker.py``, spawned once
  for the module) trains NDT1 4 steps, float32: ``mlm`` at ``(data=1,
  fsdp=2, sp=2)`` and ``(data=2, sp=2)`` with the stochastic parts off and
  on (smoothing, white and offset noise, a random masker with random
  replacement, dropout) and in bf16 autocast, ``ctc`` with a stack of 4/2
  and of 32/4 (T' = 9, padded to 12: frames 6 / 6, the last rank's 3 of
  them padding; gradients clipped by their global norm), ``ar`` (with remat
  and RoPE) with ragged lengths whose padding crosses the shard edge, and a T that ``sp`` does not divide (kept
  whole). Losses within rtol 1e-5 of one
  process, parameters within atol 1e-5 (the key bias, whose gradient is
  rounding noise, within what Adam can move it); the noisy ``(data=2,
  sp=2)`` run against ``(data=2, fsdp=2)`` (data ranks draw streams of
  their own); a checkpoint saved at ``sp=2`` resumed in one process at
  ``sp=1``, and one saved by one process resumed at ``sp=2``, continue as
  the uninterrupted run; the ``ctc`` run at ``(data=2,
  sp=2)`` against the JAX trainer's ``{data: 2, fsdp: 2, sp: 2}`` on the
  conftest's virtual CPU devices (rtol 1e-4, the port's trainer-parity
  tolerance).
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import to_plain_dict
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.models.ndt1 import (
    NeuralEmbeddingLayer,
    SmoothAndNoise,
    sequence_layout,
)
from llm_bci_tpu_torch.ops.attention import TimeSlice, dot_product_attention, make_attention_mask
from llm_bci_tpu_torch.ops.context import create_context_mask
from llm_bci_tpu_torch.ops.smoothing import gaussian_kernel, smooth_spikes, smoothing_pads
from llm_bci_tpu_torch.parallel import mesh as pmesh

from tests import _torch_parallel_worker as W
from tests.test_torch_port_trainer import C, V, mlm_trainer_config, trainer_config

STEPS = 4
LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=0.0, atol=1e-5)
JAX = dict(rtol=1e-4)
BF16_RTOL = 5e-3
SP2 = {"data": 1, "fsdp": 2, "sp": 2}
DATA2_SP2 = {"data": 2, "fsdp": 1, "sp": 2}
ONE = {"data": 1, "fsdp": 1}


# ------------------------------------------------------------ pure functions

def test_sequence_ranges():
    assert [pmesh.sequence_range(512, 2, i) for i in range(2)] == [(0, 256), (256, 512)]
    # a time dim the axis does not divide stays whole
    assert [pmesh.sequence_range(31, 2, i) for i in range(2)] == [(0, 31)] * 2
    assert [pmesh.split_range(121, 2, i) for i in range(2)] == [(0, 61), (61, 121)]
    assert [pmesh.split_range(10, 4, i) for i in range(4)] == [(0, 3), (3, 6), (6, 8),
                                                                  (8, 10)]


def test_flagship_layout_reads_each_frame_window_and_halo():
    stack = {"active": True, "size": 32, "stride": 4, "pad_to_multiple": 1}
    r0, r1 = (sequence_layout(512, 2, i, 13, stack) for i in range(2))
    assert r0.tokens == r0.real_tokens == 121 and r0.bounds == (0, 61, 121)
    # frame 60 reads bins 240..271: 28 past the next rank's first frame's bin
    assert r0.computed == (0, 272) and r1.computed == (244, 512)
    # smoothing's 6 + 6 halo bins, clipped at the sequence's ends
    assert r0.slices["spikes"] == (0, 278) and r1.slices["spikes"] == (238, 512)
    # stacked frame l takes bin l's timestamp
    assert r1.slices["spikes_timestamp"] == (61, 121)
    padded = sequence_layout(512, 2, 1, 13, {**stack, "pad_to_multiple": 8})
    assert padded.tokens == 128 and padded.bounds == (0, 64, 128)
    assert padded.slices["spikes_timestamp"] == (64, 121)
    ar = sequence_layout(32, 2, 0, 0, None, next_bin=True)
    assert ar.computed == (0, 16) and ar.slices["spikes"] == (0, 17)
    with pytest.raises(ValueError, match="leaves a rank no frame"):
        sequence_layout(40, 8, 0, 0, {"active": True, "size": 32, "stride": 4})


@pytest.mark.parametrize("sd", [1.0, 2.0, 2.5])
@pytest.mark.parametrize("n_sp", [2, 3])
def test_smoothing_a_shard_with_its_halo_equals_the_slice(sd, n_sp):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 24, 3)).astype(np.float32))
    kernel = torch.from_numpy(gaussian_kernel(sd))
    whole = smooth_spikes(x, kernel)
    pad_lo, pad_hi = smoothing_pads(kernel.shape[0])
    sn = SmoothAndNoise(False, sd, None, None)
    for i in range(n_sp):
        shard = sequence_layout(24, n_sp, i, sn.width)
        lo, hi = shard.slices["spikes"]
        got = sn(x[:, lo:hi], seq_shard=shard)
        a, b = shard.computed
        torch.testing.assert_close(got, whole[:, a:b], rtol=0, atol=1e-6)
    assert pad_lo + pad_hi + 1 == kernel.shape[0]


@pytest.mark.parametrize("T,size,stride,multiple", [(512, 32, 4, 1), (512, 32, 4, 8),
                                                     (40, 4, 2, 1), (43, 5, 3, 4)])
def test_stacked_embedding_of_a_shard_equals_the_slice(T, size, stride, multiple):
    """Smoothing, the per-bin embedding and ``StackProjection``'s strided conv
    on a rank's bins and halo: the rank's frames of the whole sequence's
    result (the flagship's T' = 121 in the first case)."""
    torch.manual_seed(0)
    n_ch = 6
    emb = NeuralEmbeddingLayer(hidden_size=8, n_channels=n_ch, n_blocks=1, n_days=1, max_F=256,
                               input_dim=4, adapt=False, day_token=False, block_token=False,
                               pos=True, act="softsign", use_bias=True, dropout=0.0,
                               stack_active=True, stack_size=size, stack_stride=stride,
                               stack_pad_multiple=multiple).eval()
    sn = SmoothAndNoise(False, 2.0, None, None)
    rng = np.random.default_rng(1)
    spikes = torch.from_numpy(rng.poisson(1.0, size=(3, T, n_ch)).astype(np.float32))
    mask = torch.ones(3, T, dtype=torch.int64)
    mask[0, T - 37:] = 0
    ts = torch.arange(T)[None].expand(3, T)
    x, m, t = emb(sn(spikes), mask, ts)
    stack = {"active": True, "size": size, "stride": stride, "pad_to_multiple": multiple}
    for i in range(2):
        shard = sequence_layout(T, 2, i, sn.width, stack)
        sl = shard.slices
        xs, ms, tss = emb(sn(spikes[:, slice(*sl["spikes"])], seq_shard=shard),
                          mask[:, slice(*sl["spikes_mask"])],
                          ts[:, slice(*sl["spikes_timestamp"])], seq_shard=shard)
        t0, t1 = shard.token_range
        torch.testing.assert_close(xs, x[:, t0:t1], rtol=1e-5, atol=1e-6)
        assert torch.equal(ms, m[:, t0:t1]) and torch.equal(tss, t[:, t0:t1])


@pytest.mark.parametrize("context", [(-2, -2), (3, 5), (0, 4)], ids=["unbanded", "band", "causal"])
def test_query_shard_attention_equals_the_rows_of_full_attention(context):
    rng = np.random.default_rng(2)
    B, T, H, D = 2, 21, 2, 4
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
               for _ in range(3))
    valid = torch.ones(B, T, dtype=torch.int64)
    valid[1, 15:] = 0
    ctx = torch.from_numpy(create_context_mask(*context, T))
    full = dot_product_attention(q, k, v, make_attention_mask(valid, ctx))
    for t0, t1 in (pmesh.split_range(T, 2, i) for i in range(2)):
        mask = make_attention_mask(valid, ctx[t0:t1], n_queries=t1 - t0, query_offset=t0)
        got = dot_product_attention(q[:, t0:t1], k, v, mask)
        torch.testing.assert_close(got, full[:, t0:t1], rtol=1e-5, atol=1e-6)
    # probability dropout drawn whole and sliced: the shard's keep mask is
    # the rows of the whole one
    gen = lambda: torch.Generator().manual_seed(5)
    full = dot_product_attention(q, k, v, dropout_rate=0.5, generator=gen())
    got = dot_product_attention(q[:, 7:14], k, v, dropout_rate=0.5, generator=gen(),
                                time=TimeSlice(T, 7))
    torch.testing.assert_close(got, full[:, 7:14], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["temporal", "random", "neuron", "forward-pred"])
def test_masker_draws_whole_and_slices(mode):
    from llm_bci_tpu_torch.models.masker import MaskerConfig, apply_masker

    cfg = MaskerConfig(mode=mode, ratio=0.3, zero_ratio=1.0, expand_prob=1.0,
                       max_timespan=3, timesteps=(1, 9, 17))
    spikes = torch.arange(2 * 20 * 3, dtype=torch.float32).reshape(2, 20, 3)
    whole, wmask = apply_masker(cfg, spikes, torch.Generator().manual_seed(4), True)
    part, pmask = apply_masker(cfg, spikes[:, 8:15], torch.Generator().manual_seed(4), True,
                               time=TimeSlice(20, 8))
    assert torch.equal(part, whole[:, 8:15]) and torch.equal(pmask, wmask[:, 8:15])


@pytest.mark.parametrize("token", ["day_token", "block_token"])
def test_prefix_tokens_belong_to_shard_zero(tmp_path, token):
    from llm_bci_tpu_torch.training.trainer import build_model

    plain = _plain(trainer_config(tmp_path), tmp_path, "prefix")
    plain["model"]["encoder"]["embedder"][token] = True
    model = build_model(W._config(plain, ONE), torch.device("cpu"))
    # 40 bins stack (4/2) to 19 frames, 10 / 9 a rank; the prefix token
    # comes before shard 0's, and every bound after it counts it
    shards = [model.sequence_layout(40, 2, i) for i in range(2)]
    assert [s.token_range for s in shards] == [(0, 11), (11, 20)]
    assert [s.tokens for s in shards] == [20, 20]
    assert [s.local_prefix for s in shards] == [1, 0]
    assert [s.body().token_range for s in shards] == [(0, 10), (10, 19)]
    # the bins each rank reads are the layout's without the prefix
    assert shards[1].slices == sequence_layout(
        40, 2, 1, model.encoder.smooth_and_noise.width,
        plain["model"]["encoder"]["embedder"]["stack"]).slices


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_axes_match_the_jax_dry_run(n):
    from llm_bci_tpu_torch.entry import dryrun_meshes

    # __graft_entry__.dryrun_multichip's rule
    fsdp = 2 if n % 2 == 0 and n >= 2 else 1
    sp = 2 if n % (2 * fsdp) == 0 and n // (2 * fsdp) >= 2 else 1
    want = {"data": n // (fsdp * sp), "fsdp": fsdp, "sp": sp}
    assert dryrun_meshes(n)[0] == want


# ---------------------------------------------------------- multi-rank runs

def _rows(n, seed, lengths, targets=True):
    """speechbci-shaped rows (``targets``) or spike rows, one of them of the
    longest length, which the trainer pads every batch to."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        T = lengths[1] if i == 0 else int(rng.integers(*lengths))
        row = {"spikes": rng.poisson(1.2, size=(T, C)).astype(np.float32),
               "sentence": f"trial {seed} {i}"}
        if targets:
            S = int(rng.integers(2, 5))
            idx = rng.integers(1, V, size=S)
            row.update(phonemes_idx=idx, phonemes=[f"P{j}" for j in idx],
                       block_idx=np.asarray(i % 2), day_idx=np.asarray(0))
        rows.append(row)
    return rows


def _plain(cfg, tmp, tag, **training):
    plain = to_plain_dict(cfg)
    plain["savestring"] = tag
    plain["dirs"]["checkpoint_dir"] = str(tmp / "ck")
    plain["training"].update(max_steps=STEPS, num_epochs=4, save_every=None, **training)
    return plain


def _noisy(plain):
    """The stochastic parts on: smoothing, white and offset noise, dropout,
    and for mlm a random masker with random replacement."""
    plain = copy.deepcopy(plain)
    enc = plain["model"]["encoder"]
    enc["smooth_and_noise"] = {"noise": True, "smooth_sd": 1.5, "white_noise_sd": 0.5,
                               "constant_offset_sd": 0.2}
    enc["embedder"]["dropout"] = 0.2
    enc["transformer"]["dropout"] = 0.3
    if plain["method"]["model_kwargs"]["method_name"] == "mlm":
        enc["masker"] = {"neuron": {"active": True, "mode": "random", "ratio": 0.3,
                                    "zero_ratio": 0.5, "random_ratio": 0.5}}
    return plain


def _bf16(plain):
    """bf16 autocast: K and V travel as bf16 (as their bytes)."""
    plain = copy.deepcopy(plain)
    plain["precision"] = {"compute_dtype": "bfloat16"}
    return plain


def _mlm(tmp):
    return mlm_trainer_config(tmp, "auto")     # dense below FLASH_AUTO_MIN_T


def _ar(tmp):
    cfg = _mlm(tmp)
    cfg["model"]["encoder"]["context"] = {"forward": 0, "backward": -2}
    cfg["model"]["encoder"]["masker"] = {"neuron": {"active": False}}
    cfg["method"]["model_kwargs"]["method_name"] = "autoregressive"
    # each layer's K / V gathers run again in the backward's recompute; RoPE
    # reads the rank's own timestamps
    cfg["model"]["encoder"]["remat"] = True
    cfg["model"]["encoder"]["transformer"]["use_rope"] = True
    for spec in cfg["method"]["dataloader_kwargs"]["pad_dict"].values():
        spec["side"] = "right"
    return cfg


def _ctc324(tmp):
    cfg = trainer_config(tmp)
    cfg["model"]["encoder"]["embedder"]["stack"] = {"active": True, "size": 32, "stride": 4,
                                                    "pad_to_multiple": 4}
    # the global norm counts the sp ranks' reduced gradients once
    cfg["optimizer"]["grad_clip_norm"] = 0.5
    return cfg


def _weights(tmp, plain, tag):
    from llm_bci_tpu_torch.training.trainer import build_model

    torch.manual_seed(0)
    model = build_model(W._config(plain, ONE), torch.device("cpu"))
    path = os.path.join(str(tmp), f"{tag}.pt")
    torch.save(model.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("sequence_parallel")
    data = {
        "mlm": {"train": _rows(8, 0, (10, 32), False), "val": _rows(4, 1, (10, 32), False)},
        "odd": {"train": _rows(8, 0, (10, 31), False), "val": _rows(4, 1, (10, 31), False)},
        "ctc42": {"train": _rows(8, 2, (30, 40)), "test": _rows(4, 3, (30, 40))},
        "ctc324": {"train": _rows(8, 4, (40, 64)), "test": _rows(4, 5, (40, 64))},
    }
    paths = {k: W.dump(v, tmp / f"{k}.pkl") for k, v in data.items()}

    jax_losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        jax_losses.append(float(np.asarray(outputs["loss"])))
        return 0.0

    jcfg = trainer_config(tmp / "jax")
    jcfg["parallelism"] = {"data": 2, "fsdp": 2, "sp": 2}
    jcfg["training"].update(max_steps=STEPS, num_epochs=4)
    jt = JaxTrainer(jcfg, dataset=data["ctc42"], metric_fns={"rec": record})
    sp_axis = jt.mesh.shape["sp"]
    ctc42_w = os.path.join(str(tmp), "ctc42.pt")
    torch.save(ndt1_state_dict_from_jax(jax.device_get(jt.state.params)), ctc42_w)

    mlm = _plain(_mlm(tmp), tmp, "mlm", eval_every=STEPS)
    configs = {
        "mlm": (mlm, "mlm"),
        "mlm_noisy": (_noisy(mlm), "mlm"),
        "mlm_bf16": (_bf16(mlm), "mlm"),
        "ar": (_plain(_ar(tmp), tmp, "ar"), "mlm"),
        "odd": (mlm, "odd"),
        "ctc42": (_plain(trainer_config(tmp), tmp, "ctc42", eval_every=STEPS), "ctc42"),
        "ctc324_noisy": (_noisy(_plain(_ctc324(tmp), tmp, "ctc324")), "ctc324"),
    }
    weights = {k: (ctc42_w if k == "ctc42" else _weights(tmp, plain, k))
               for k, (plain, _) in configs.items()}

    def case(name, config, parallelism, kind="train", **over):
        plain, data_key = configs[config]
        plain = copy.deepcopy(plain)
        plain["savestring"] = name
        plain["training"].update(over)
        return (name, kind, dict(plain=plain, parallelism=parallelism,
                                 dataset_path=paths[data_key], weights_path=weights[config]))

    cases = [
        case("mlm_sp2", "mlm", SP2), case("mlm_data2_sp2", "mlm", DATA2_SP2),
        case("mlm_noisy_sp2", "mlm_noisy", SP2), case("mlm_bf16_sp2", "mlm_bf16", SP2),
        case("mlm_noisy_data2_sp2", "mlm_noisy", DATA2_SP2),
        case("mlm_noisy_data2", "mlm_noisy", {"data": 2, "fsdp": 2}),
        case("ar_sp2", "ar", SP2), case("odd_sp2", "odd", SP2),
        case("ctc42_data2_sp2", "ctc42", DATA2_SP2),
        case("ctc324_noisy_sp2", "ctc324_noisy", SP2),
        # a checkpoint at step 2, resumed below in one process at sp=1
        case("saved_sp2", "mlm_noisy", SP2, max_steps=2, save_every=2),
        # a one-process checkpoint at step 2 (written below), resumed at sp=2
        case("saved_one", "mlm_noisy", SP2, kind="resume_train"),
    ]
    W.train(**case("saved_one", "mlm_noisy", ONE, max_steps=2, save_every=2)[2])
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(W.run_ranks, tmp, 4, cases)
        single = {k: W.train(**case(f"{k}_single", k, ONE)[2]) for k in configs}
        jt.train()                                  # while the ranks run
        ranks = ranks.result()
    name, kind, kw = case("saved_sp2", "mlm_noisy", ONE, max_steps=STEPS)
    resumed = W.resume_train(**kw)
    return {"ranks": ranks, "single": single, "resumed": resumed, "jax_losses": jax_losses,
            "jax_sp": sp_axis}


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def _close(got, want, what):
    W.assert_states_close(got, want, what, lr=1e-3, steps=STEPS, **PARAMS)


@pytest.mark.parametrize("name,config", [
    ("mlm_sp2", "mlm"), ("mlm_data2_sp2", "mlm"), ("mlm_noisy_sp2", "mlm_noisy"),
    ("ar_sp2", "ar"), ("odd_sp2", "odd"), ("ctc42_data2_sp2", "ctc42"),
    ("ctc324_noisy_sp2", "ctc324_noisy"), ("mlm_bf16_sp2", "mlm_bf16")])
def test_sp_trains_as_the_single_process(runs, name, config):
    single = runs["single"][config]
    bf16 = config.endswith("bf16")
    for rank in runs["ranks"]:
        res = _ok(rank[name])
        assert res["n_micro"] == STEPS
        # bf16: two ranks' rounded K / V gradient partials against one sum
        np.testing.assert_allclose(res["losses"], single["losses"],
                                   **(dict(rtol=BF16_RTOL) if bf16 else LOSS))
        # the last batch's tokens on this rank
        want = {"mlm": (32, 16), "ar": (32, 16), "odd": None, "ctc42": (19, 10),
                "ctc324_noisy": (12, 6)}[config.split("_")[0] if config.startswith(
                    "mlm") else config]
        if want is None:
            assert res["shard"] is None           # 31 bins: kept whole
        else:
            (t0, t1), tokens = res["shard"]
            sp = res["coords"]["sp"]
            assert tokens == want[0] and t0 == sp * want[1] and t1 == min(tokens, t0 + want[1])
    if not bf16:
        _close(runs["ranks"][0][name]["model"], single["model"], name)


def test_noisy_data2_sp2_trains_as_data2_without_sp(runs):
    for rank in runs["ranks"]:
        want = _ok(rank["mlm_noisy_data2"])
        np.testing.assert_allclose(_ok(rank["mlm_noisy_data2_sp2"])["losses"], want["losses"],
                                   **LOSS)
    _close(runs["ranks"][0]["mlm_noisy_data2_sp2"]["model"],
           runs["ranks"][0]["mlm_noisy_data2"]["model"], "noisy data2")


def test_sp_takes_the_dense_path_and_the_metric_fns_see_whole_outputs(runs):
    for rank in runs["ranks"]:
        res = _ok(rank["mlm_sp2"])
        assert "sequence-parallel" in res["flash_fallback"]
        # mlm: the rank's time shard, gathered; ctc: the log-probs gathered
        # for the loss (T = 40 bins stack to 19 frames, 10 and 9 a rank)
        assert set(res["pred_shapes"]) == {(4, 32, C)}
        assert set(_ok(rank["ctc42_data2_sp2"])["pred_shapes"]) == {(4, 19, V)}
        # the eval over the test set matches the single process's
        (ev,) = res["eval"]
        (want,) = runs["single"]["mlm"]["eval"]
        np.testing.assert_allclose(ev["test_avg_loss"], want["test_avg_loss"], **LOSS)
        np.testing.assert_allclose(ev["train_avg_loss"], want["train_avg_loss"], **LOSS)
    (ev,) = runs["ranks"][0]["ctc42_data2_sp2"]["eval"]
    (want,) = runs["single"]["ctc42"]["eval"]
    np.testing.assert_allclose(ev["test_avg_loss"], want["test_avg_loss"], **LOSS)


def test_sp2_checkpoint_resumes_at_sp1_and_back(runs):
    resumed, single = _ok(runs["resumed"]), runs["single"]["mlm_noisy"]
    saved = [_ok(r["saved_sp2"]) for r in runs["ranks"]]
    assert resumed["step"] == 2 and all(s["n_micro"] == 2 for s in saved)
    np.testing.assert_allclose(saved[0]["losses"] + resumed["losses"], single["losses"], **LOSS)
    _close(resumed["model"], single["model"], "resumed at sp=1")
    # a one-process checkpoint at step 2 continued at sp=2
    for rank in runs["ranks"]:
        res = _ok(rank["saved_one"])
        assert res["step"] == 2
        np.testing.assert_allclose(single["losses"][:2] + res["losses"], single["losses"],
                                   **LOSS)
    _close(runs["ranks"][0]["saved_one"]["model"], single["model"], "resumed at sp=2")


def test_sp_ctc_matches_the_jax_trainers_sp_run(runs):
    assert runs["jax_sp"] == 2
    res = _ok(runs["ranks"][0]["ctc42_data2_sp2"])
    # the port's run evaluates after its last step: its metric fn sees the
    # eval batches too
    assert len(runs["jax_losses"]) == STEPS
    np.testing.assert_allclose(res["losses"][:STEPS], runs["jax_losses"], **JAX)
