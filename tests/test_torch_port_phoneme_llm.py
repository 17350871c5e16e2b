"""PhonemeLLM parity: the port (``llm_bci_tpu_torch.models.phoneme_llm``)
against the JAX package, on the CPU in float32 with the debug Llama, LoRA on
all seven projections and LoRA ``B`` non-zero, the weights carried by
``phoneme_llm_state_dict_from_jax``.

* loss, logits and ``n_examples`` under both loss reductions (atol 1e-4);
* greedy and beam ids equal, beam scores atol 1e-4;
* the ``requires_grad`` partition equals ``PhonemeLLM.trainable_mask`` (only
  LoRA and the coupler train);
* a save / load round trip of ``llm.pt`` + ``coupler.pt``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import phoneme_llm as jphon
from llm_bci_tpu_torch.interop import phoneme_llm_state_dict_from_jax
from llm_bci_tpu_torch.models import phoneme_llm as tphon

TOL = dict(atol=1e-4, rtol=1e-4)
LORA = {"r": 2, "alpha": 16, "dropout": 0.0,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj"]}
B, L, P, V = 3, 10, 6, 41


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, P, V)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rng.integers(3, 32000, size=(B, L)).astype(np.int64)
    am = np.ones((B, L), np.int64)
    am[2, L - 2:] = 0
    ph_mask = np.ones((B, P), np.int64)
    ph_mask[1, P - 2:] = 0
    targets = np.where(np.arange(L)[None, :] >= 6, ids, -100)
    targets[2, L - 2:] = -100
    return {"input_ids": ids, "attention_mask": am,
            "input_split": np.array([4, 0, 7], np.int64), "phoneme_probs": probs,
            "phonemes_mask": ph_mask, "targets": targets.astype(np.int64)}


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX PhonemeLLM in float32, its params with non-zero LoRA B, a batch):
    one init for the whole file."""
    jm = dataclasses.replace(jphon.PhonemeLLM.from_config({}, debug=True, lora=dict(LORA)),
                             dtype=jnp.float32)
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.device_get(jax.jit(lambda key: jm.init(key, **jb))(jax.random.PRNGKey(0))["params"])
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", "")) == "lora_B":
            return rng.normal(0, 0.05, size=leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jm, jax.tree_util.tree_map_with_path(fill, params), batch


def port_model(params, reduction="sum"):
    tm = tphon.PhonemeLLM.from_config({"loss_reduction": reduction}, debug=True,
                                      lora=dict(LORA), compute_dtype="float32")
    sd = phoneme_llm_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    return tm.eval()


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_logits_match_jax(jax_pair, reduction):
    jm, params, batch = jax_pair
    jm = dataclasses.replace(jm, config={**jm.config, "loss_reduction": reduction})
    tm = port_model(params, reduction)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax.jit(lambda p: jm.apply({"params": p}, **jb))(params)
    with torch.no_grad():
        out = tm(**tensors(batch))
    np.testing.assert_allclose(out.preds.numpy(), np.asarray(ref.preds), **TOL)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **TOL)
    assert int(out.n_examples) == int(ref.n_examples) == 4 + 4 + 2
    np.testing.assert_array_equal(out.targets.numpy(), np.asarray(ref.targets))


def test_greedy_and_beam_ids_match_jax(jax_pair):
    jm, params, batch = jax_pair
    tm = port_model(params)
    gen = {k: v for k, v in batch.items() if k != "targets"}
    jgen = {k: jnp.asarray(v) for k, v in gen.items()}
    generate = lambda **kw: jax.jit(lambda p: jm.apply({"params": p}, **jgen, **kw,
                                                       method="generate"))(params)
    ref = generate(max_new_tokens=5)
    got = tm.generate(**tensors(gen), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = generate(max_new_tokens=4, num_beams=3, num_return_sequences=3)
    got = tm.generate(**tensors(gen), max_new_tokens=4, num_beams=3, num_return_sequences=3)
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-4)
    best = tm.generate(**tensors(gen), max_new_tokens=4, num_beams=3)
    np.testing.assert_array_equal(best.numpy(), got.sequences[:, 0].numpy())


def test_the_coupler_computes_in_float32_under_autocast(jax_pair):
    """The JAX coupler's Dense has no dtype: it computes in float32. The
    port's coupler keeps float32 under the trainer's bf16 autocast."""
    jm, params, batch = jax_pair
    tm = port_model(params)
    probs = torch.from_numpy(batch["phoneme_probs"])
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="_couple"))(
        params, jnp.asarray(batch["phoneme_probs"]))
    with torch.no_grad():
        plain = tm._couple(probs)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            cast = tm._couple(probs)
    assert cast.dtype == torch.float32
    assert torch.equal(cast, plain)
    np.testing.assert_allclose(cast.numpy(), np.asarray(ref), **TOL)


def test_trainable_leaves_are_lora_and_coupler(jax_pair):
    jm, params, _ = jax_pair
    tm = port_model(params)
    mask = phoneme_llm_state_dict_from_jax(jax.tree_util.tree_map(
        lambda m: np.asarray(1.0 if m else 0.0, np.float32), jm.trainable_mask(params)))
    trains = {k: p.requires_grad for k, p in tm.named_parameters()}
    assert set(trains) == set(mask)
    assert {k for k, v in trains.items() if v} == {k for k, m in mask.items() if m.all()}
    assert all(".lora_" in k or k.startswith("coupler") for k, v in trains.items() if v)
    assert any(k.startswith("coupler") for k, v in trains.items() if v)


def test_save_load_round_trip(jax_pair, tmp_path):
    _, params, batch = jax_pair
    tm = port_model(params)
    tm.save_checkpoint(str(tmp_path))
    tm.save_config(str(tmp_path))
    torch.manual_seed(3)
    fresh = tphon.PhonemeLLM.from_config({}, debug=True, lora=dict(LORA),
                                         compute_dtype="float32").eval()
    fresh.load_checkpoint_params(str(tmp_path))
    for (k, a), (_, b) in zip(tm.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), k
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(**tensors(batch)).preds.numpy(),
                                      tm(**tensors(batch)).preds.numpy())
    # only the leaves that train: a frozen base is rebuilt, not saved
    small = tmp_path / "small"
    small.mkdir()
    tm.save_checkpoint(str(small), include_frozen=False)
    saved = torch.load(small / "llm.pt", weights_only=True)
    assert saved and all(".lora_" in k for k in saved)
    fresh.load_checkpoint_params(str(small))
    torch.save({"coupler_in.weight": torch.zeros(1)}, small / "coupler.pt")
    with pytest.raises(RuntimeError, match="coupler.pt does not fit"):
        fresh.load_checkpoint_params(str(small))
