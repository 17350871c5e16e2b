"""BCI parity (NDT1 trunk -> projector -> LoRA Llama): the port
(``llm_bci_tpu_torch.models.bci``) against the JAX package, on the CPU in
float32 with dropout and noise off, the debug Llama and LoRA ``B`` non-zero.

* ``splice_embeds`` is exact;
* loss and logits atol 1e-5 / rtol 1e-4; gradients of the LoRA, projector
  and encoder leaves rtol 1e-4 (absolute floor 1e-5 of the largest entry);
* the ``requires_grad`` partition equals ``BCI.trainable_mask``;
* ``generate`` (greedy, beam with both ``early_stopping``, diverse beam): the
  same token ids, scores atol 1e-4;
* a 4-step ``Trainer`` loss curve against the JAX ``Trainer``, rtol 1e-4 (the
  tolerance of ``tests/test_torch_port_trainer.py``), bf16-stored and int8
  bases; frozen leaves bit-identical afterwards;
* checkpoint save -> load round trip, ``from_pt`` reload, NDT1 warm start;
* ``llm_bci_tpu_torch.main`` on a pre-tokenized dataset with the A-WER fn.
"""
import gc
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import DictConfig, to_plain_dict
from llm_bci_tpu.models import bci as jbci
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.interop import bci_state_dict_from_jax
from llm_bci_tpu_torch.models import bci as tbci
from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

from tests.test_bci import synth_bci_dataset

FWD = dict(atol=1e-5, rtol=1e-4)
LORA = {"r": 2, "alpha": 16, "dropout": 0.0,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj"],
        "modules_to_save": []}


def model_config():
    return {
        "model_class": "BCI",
        "ndt1": {"encoder": {
            "masker": {"neuron": {"active": False}},
            "smooth_and_noise": {"noise": False},
            "embedder": {"n_channels": 8, "max_F": 16, "input_dim": 12, "n_days": 2,
                         "n_blocks": 2, "dropout": 0.0,
                         "stack": {"active": True, "size": 4, "stride": 2,
                                   "pad_to_multiple": 8}},     # forced back to 1
            "transformer": {"n_layers": 2, "hidden_size": 16, "n_heads": 2, "inter_size": 32,
                            "dropout": 0.0},
        }},
        "projector": {"stacking": 2, "inter_size": 24, "bias": True, "act": "relu"},
    }


def method_kwargs(**extra):
    return {"method_name": "endtoend", "debug": True, "lora": dict(LORA), "freeze_llm": False,
            **extra}


def make_batch(B=3, T=16, N=8, L=10, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 3, T - 6], np.int64)[:B]
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int64)
    spikes = (rng.poisson(1.0, size=(B, T, N)) * mask[:, :, None]).astype(np.float32)
    ids = rng.integers(3, 32000, size=(B, L)).astype(np.int64)
    am = np.ones((B, L), np.int64)
    am[2, L - 2:] = 0
    targets = np.where(np.arange(L)[None, :] >= 6, ids, -100)
    targets[2, L - 2:] = -100
    return {
        "input_ids": ids, "attention_mask": am,
        "input_split": np.array([[3], [0], [5]], np.int64)[:B],
        "spikes": spikes, "spikes_mask": mask,
        "spikes_timestamp": np.broadcast_to(np.arange(T), (B, T)).astype(np.int64),
        "spikes_lengths": lengths,
        "block_idx": np.array([0, 1, 1], np.int64)[:B],
        "day_idx": np.array([1, 0, 1], np.int64)[:B],
        "targets": targets.astype(np.int64),
    }


def build_pair(quantize=None, seed=0):
    """(JAX BCI in float32, its params with non-zero LoRA B, the port's BCI
    loaded with them through ``bci_state_dict_from_jax``)."""
    kwargs = method_kwargs(quantize=quantize)
    jm = jbci.BCI.from_config(DictConfig(model_config()), **kwargs).clone(dtype=jnp.float32)
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), **jb)["params"])
    rng = np.random.default_rng(seed + 1)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", "")) == "lora_B":
            return rng.normal(0, 0.05, size=leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(fill, params)
    tm = tbci.BCI.from_config(PortDictConfig(model_config()), compute_dtype="float32", **kwargs)
    sd = bci_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm, batch


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_splice_embeds_is_exact():
    rng = np.random.default_rng(0)
    B, L, S, H = 3, 7, 4, 5
    text = rng.normal(size=(B, L, H)).astype(np.float32)
    spikes = rng.normal(size=(B, S, H)).astype(np.float32)
    d = np.asarray([0, 3, 7])
    ref = jbci.splice_embeds(jnp.asarray(text), jnp.asarray(spikes), jnp.asarray(d))
    got = tbci.splice_embeds(torch.from_numpy(text), torch.from_numpy(spikes),
                             torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for b in range(B):
        loop = np.concatenate([text[b, :d[b]], spikes[b], text[b, d[b]:]], axis=0)
        np.testing.assert_array_equal(got[b].numpy(), loop)
    ids = rng.integers(0, 9, size=(B, L))
    fill = np.full((B, S), -100)
    ref2 = jbci.splice_embeds(jnp.asarray(ids), jnp.asarray(fill), jnp.asarray(d[:, None]))
    got2 = tbci.splice_embeds(torch.from_numpy(ids), torch.from_numpy(fill),
                              torch.from_numpy(d[:, None]))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(ref2))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_loss_logits_and_gradients_match_jax(quantize):
    jm, params, tm, batch = build_pair(quantize)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jm.apply({"params": params}, **jb)
    tm.train()                                 # dropout and noise are configured off
    out = tm(**tensors(batch))
    assert tm.ndt1_encoder.embedder.stack_pad_multiple == 1
    assert out.preds.shape == (3, 10 + 4, 32000) and out.preds.dtype == torch.float32
    np.testing.assert_allclose(out.preds.detach().numpy(), np.asarray(ref.preds), **FWD)
    np.testing.assert_array_equal(out.targets.numpy(), np.asarray(ref.targets))
    np.testing.assert_allclose(float(out.loss), float(ref.loss), rtol=1e-5)
    assert int(out.n_examples) == int(ref.n_examples) > 0

    is_float = lambda x: np.issubdtype(np.asarray(x).dtype, np.floating)
    floats = jax.tree_util.tree_map(lambda x: x if is_float(x) else None, params)
    ints = jax.tree_util.tree_map(lambda x: None if is_float(x) else x, params)
    merge = lambda f: jax.tree_util.tree_map(
        lambda a, b: a if a is not None else b, f, ints, is_leaf=lambda x: x is None)
    grads = jax.device_get(jax.grad(
        lambda f: jm.apply({"params": merge(f)}, **jb).loss)(floats))
    ref_grads = bci_state_dict_from_jax(jax.tree_util.tree_map(
        lambda g, p: (np.zeros(np.shape(p), np.float32) if g is None else g)
        if is_float(p) else np.asarray(p), grads, params, is_leaf=lambda x: x is None))
    out.loss.backward()
    named = dict(tm.named_parameters())
    top = max(float(p.grad.abs().max()) for p in named.values() if p.grad is not None)
    checked = set()
    for key, p in named.items():
        if not p.requires_grad:
            assert p.grad is None, key
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key].numpy(), rtol=1e-4,
                                   atol=1e-5 * top, err_msg=key)
        checked.add(key.split(".")[0])
    assert checked == {"llm", "ndt1_encoder", "projector_in", "projector_out"}


@pytest.mark.parametrize("freeze_llm,lora", [(False, True), (True, False), (False, False)])
def test_requires_grad_partition_equals_trainable_mask(freeze_llm, lora):
    kwargs = method_kwargs(freeze_llm=freeze_llm)
    if not lora:
        kwargs["lora"] = None
    jm = jbci.BCI.from_config(DictConfig(model_config()), **kwargs)
    jb = {k: jnp.asarray(v) for k, v in make_batch().items()}
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), **jb)["params"])
    mask = jm.trainable_mask(params)
    as_arrays = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    want = {k: bool(v.all()) for k, v in bci_state_dict_from_jax(as_arrays).items()}
    tm = tbci.BCI.from_config(PortDictConfig(model_config()), **kwargs)
    got = {k: p.requires_grad for k, p in tm.named_parameters()}
    assert got == want
    assert any(got.values()) and (all(got.values()) == (not freeze_llm and not lora))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_generate_matches_jax(quantize):
    jm, params, tm, batch = build_pair(quantize)
    gen_keys = ("input_ids", "attention_mask", "input_split", "spikes", "spikes_mask",
                "spikes_timestamp", "spikes_lengths", "block_idx", "day_idx")
    jb = {k: jnp.asarray(batch[k]) for k in gen_keys}
    tb = {k: torch.from_numpy(batch[k]) for k in gen_keys}
    jgen = lambda **kw: jm.apply({"params": params}, **jb, method=jm.generate, **kw)

    free = np.asarray(jgen(max_new_tokens=5, eos_token_id=-1))
    eos = int(free[0, 1])
    ref = np.asarray(jgen(max_new_tokens=5, eos_token_id=eos))
    tm.train()
    got = tm.generate(**tb, max_new_tokens=5, eos_token_id=eos)
    assert tm.training                          # generate restores the mode
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0, 1] == eos and (got[0, 2:] == 0).all()

    for early in (False, True):
        kw = dict(max_new_tokens=5, num_beams=3, eos_token_id=eos, early_stopping=early,
                  num_return_sequences=3, length_penalty=0.8)
        ref = jgen(**kw)
        got = tm.generate(**tb, **kw)
        np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(ref.sequences))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-4)
    # num_return_sequences=1: the best hypothesis alone, as (B, max_new_tokens)
    best = tm.generate(**tb, max_new_tokens=5, num_beams=3, eos_token_id=eos, length_penalty=0.8,
                       early_stopping=True)
    np.testing.assert_array_equal(best.numpy(), got.sequences[:, 0].numpy())

    kw = dict(max_new_tokens=5, num_beams=4, num_beam_groups=4, diversity_penalty=1.2,
              eos_token_id=eos, num_return_sequences=4)
    ref = jgen(**kw)
    got = tm.generate(**tb, **kw)
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-4)
    with pytest.raises(ValueError, match="num_return_sequences"):
        tm.generate(**tb, num_beams=2, num_return_sequences=3)
    with pytest.raises(ValueError, match="group size 1"):
        tm.generate(**tb, num_beams=4, num_beam_groups=2)
    # a decode leaves nothing that keeps its model alive: no reference cycle
    gc.disable()
    try:
        model = weakref.ref(tm)
        del tm
        assert model() is None
    finally:
        gc.enable()


# ------------------------------------------------------------------ trainer


def trainer_config(tmp_path, quantize=None):
    pad = lambda value=0: {"dim": 0, "side": "right", "value": value, "truncate": None,
                           "min_length": None}
    return DictConfig({
        "seed": 5, "savestring": "bci_parity", "verbosity": 3,
        "dirs": {"checkpoint_dir": str(tmp_path / "ckpt"), "log_dir": None},
        "training": {"num_epochs": 2, "train_batch_size": 4, "test_batch_size": 4,
                     "max_steps": 4, "save_on_preemption": False},
        "parallelism": {"data": 1, "fsdp": -1},
        "precision": {"compute_dtype": "float32"},
        "model": model_config(),
        "data": {"dataset_class": "decoding"},
        "method": {
            "model_kwargs": method_kwargs(quantize=quantize),
            "dataset_kwargs": {"targets_name": "labels"},
            "dataloader_kwargs": {"pad_dict": {
                "spikes": pad(), "spikes_mask": pad(), "spikes_timestamp": pad(),
                "input_ids": pad(0), "attention_mask": pad(0), "targets": pad(-100),
                "targets_mask": pad(0)}},
            "metric_kwargs": {},
        },
        "optimizer": {"lr": 1e-3, "wd": 0.01, "scheduler": "cosine", "warmup_pct": 0.3},
    })


def port_cfg(cfg):
    return PortDictConfig(to_plain_dict(cfg))


def recorder(log):
    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        log.append(float(np.asarray(outputs["loss"])))
        return 0.0

    return record


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_trainer_loss_curve_matches_jax_trainer(tmp_path, quantize):
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer

    dataset = synth_bci_dataset(n_train=10, n_test=4)
    jax_log, port_log = [], []
    cfg = trainer_config(tmp_path / "jax", quantize)
    jmodel = jbci.BCI.from_config(cfg["model"], **cfg["method"]["model_kwargs"]).clone(
        dtype=jnp.float32)
    jt = JaxTrainer(cfg, model=jmodel, dataset=dataset, metric_fns={"rec": recorder(jax_log)})
    params = jax.device_get(jt.state.params)
    pt = PortTrainer(port_cfg(trainer_config(tmp_path / "port", quantize)), dataset=dataset,
                     metric_fns={"rec": recorder(port_log)}, device="cpu")
    assert pt.model.dtype == torch.float32 and pt.model.quant == quantize
    pt.model.load_state_dict(bci_state_dict_from_jax(params), strict=True)
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    # the optimizer holds the leaves that train, and nothing else
    held = {id(p) for g in pt.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in pt.model.parameters() if p.requires_grad}

    jt.train()
    pt.train()
    assert len(jax_log) == len(port_log) == 4
    np.testing.assert_allclose(port_log, jax_log, rtol=1e-4)

    trains = {k for k, p in pt.model.named_parameters() if p.requires_grad}
    moved = 0
    for key, now in pt.model.state_dict().items():
        if key in trains:
            moved += not torch.equal(now, before[key])
        else:
            assert torch.equal(now, before[key]), f"frozen leaf moved: {key}"
    assert moved > 0.9 * len(trains)
    if quantize:
        assert pt.model.llm.lm_head.kernel.dtype == torch.int8
    loss, _ = pt.evaluate()
    jloss, _ = jt.evaluate()
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)


def test_checkpoint_round_trip_and_from_pt_reload(tmp_path):
    dataset = synth_bci_dataset(n_train=8, n_test=4)
    cfg = port_cfg(trainer_config(tmp_path, "int8"))
    cfg["training"]["max_steps"] = 2
    cfg["training"]["save_every"] = 2
    pt = PortTrainer(cfg, dataset=dataset, device="cpu")
    pt.train()
    step_dir = str(tmp_path / "ckpt" / "bci_parity" / "STEP2")
    assert sorted(os.listdir(step_dir)) == [
        "encoder.pt", "encoder_config.yaml", "llama_config.yaml", "llm.pt", "optimizer.pt",
        "projector.pt", "projector_config.yaml", "trainer_config.yaml"]

    # reload with no debug / llm_path kwargs: the structure comes from the
    # saved configs, the weights from the blobs
    reloaded = tbci.BCI.from_config(PortDictConfig({"from_pt": step_dir}), lora=dict(LORA),
                                    quantize="int8", compute_dtype="float32")
    assert reloaded.llama_config == pt.model.llama_config
    assert reloaded.config["ndt1"]["encoder"]["transformer"]["n_layers"] == 2
    assert reloaded.config["projector"]["inter_size"] == 24
    reloaded.warm_start()
    want = pt.model.state_dict()
    got = reloaded.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    batch = tensors(make_batch())
    pt.model.eval()
    reloaded.eval()
    with torch.no_grad():
        assert torch.equal(reloaded(**batch).preds, pt.model(**batch).preds)

    # without the frozen leaves: LoRA only in llm.pt, the base from elsewhere
    slim = tmp_path / "slim"
    slim.mkdir()
    pt.model.save_checkpoint(str(slim), include_frozen=False)
    saved = torch.load(slim / "llm.pt", weights_only=True)
    assert saved and all(".lora_" in k for k in saved)
    fresh = tbci.BCI.from_config(port_cfg(trainer_config(tmp_path))["model"],
                                 compute_dtype="float32", **method_kwargs(quantize="int8"))
    fresh.load_checkpoint_params(str(slim))
    for key in saved:
        assert torch.equal(fresh.llm.state_dict()[key], saved[key])
    assert torch.equal(fresh.projector_out.weight, pt.model.projector_out.weight)
    # a blob that does not fit raises
    torch.save({"nope.weight": torch.zeros(1)}, slim / "llm.pt")
    with pytest.raises(RuntimeError, match="does not fit"):
        fresh.load_checkpoint_params(str(slim))
    # a reference-format torch checkpoint names its ROADMAP item
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    (ref_dir / "encoder.bin").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbci.BCI.from_config(PortDictConfig({"from_pt": str(ref_dir)}), debug=True)


def test_ndt1_warm_start_from_a_trainer_checkpoint(tmp_path):
    from llm_bci_tpu_torch.models.ndt1 import NDT1

    enc_cfg = model_config()["ndt1"]
    enc_cfg["encoder"]["embedder"]["stack"]["pad_to_multiple"] = 1
    ndt1 = NDT1.from_config(PortDictConfig(enc_cfg), method_name="ctc", vocab_size=5)
    torch.save(ndt1.state_dict(), tmp_path / "model.pt")
    model = tbci.BCI.from_config(PortDictConfig(model_config()), compute_dtype="float32",
                                 **method_kwargs(load_ndt1_from_pt=str(tmp_path)))
    assert model.config["ndt1"]["encoder"]["from_pt"] == str(tmp_path)
    model.warm_start()
    for key, value in ndt1.encoder.state_dict().items():
        assert torch.equal(model.ndt1_encoder.state_dict()[key], value), key


class WordTokenizer:
    """Token id -> a word, for the A-WER fn."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i) % 7}" for i in ids)


def test_port_main_trains_bci_with_the_assisted_wer_fn(tmp_path):
    from llm_bci_tpu_torch import main as port_main

    dataset = synth_bci_dataset(n_train=6, n_test=4)
    overrides = [
        f"dirs.checkpoint_dir={tmp_path / 'ck'}", "dirs.log_dir=null", "verbosity=3",
        "training.max_steps=2", "training.eval_every=2", "training.save_every=null",
        "training.train_batch_size=4", "training.test_batch_size=4",
        "precision.compute_dtype=float32", "method.model_kwargs.debug=true",
        "method.model_kwargs.quantize=int8", "method.model_kwargs.lora.dropout=0.0",
        "model.ndt1.encoder.transformer.n_layers=1",
        "model.ndt1.encoder.transformer.hidden_size=16",
        "model.ndt1.encoder.transformer.n_heads=2", "model.ndt1.encoder.transformer.inter_size=16",
        "model.ndt1.encoder.embedder.input_dim=8", "model.ndt1.encoder.embedder.max_F=16",
        "model.ndt1.encoder.embedder.stack.active=true",
        "model.ndt1.encoder.embedder.stack.size=4", "model.ndt1.encoder.embedder.stack.stride=2",
        "model.projector.inter_size=16",
    ]
    args = port_main.parse_args(["-c", "configs/trainer_bci.yaml", "-k", *overrides,
                                 "--device", "cpu"])
    trainer = port_main.main(args, dataset=dataset, tokenizer=WordTokenizer())
    model = trainer.model
    assert type(model).__name__ == "BCI" and model.quant == "int8" and model.lora_r == 8
    assert model.ndt1_encoder.embedder.embed_spikes.in_features == 8     # inferred
    (h,) = trainer.eval_history
    assert np.isfinite(h["train_avg_loss"]) and np.isfinite(h["test_avg_loss"])
    assert 0.0 <= h["train_avg_metrics"]["A-WER"] <= 3.0
    assert 0.0 <= h["test_avg_metrics"]["A-WER"] <= 3.0
    # without a tokenizer the metric is left out, and training still runs
    trainer = port_main.main(args, dataset=dataset)
    assert trainer.eval_history[0]["train_avg_metrics"] == {}
