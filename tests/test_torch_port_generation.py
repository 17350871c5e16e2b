"""Decoding parity: the port's greedy, beam and diverse beam search
(``llm_bci_tpu_torch.models.generation``) against the JAX package's, on the
CPU in float32 with the same Llama weights (LoRA ``B`` non-zero), the same
prompt embeddings and a padded prompt key.

Token ids must be equal and scores agree to atol 1e-4. The EOS id of each
case is a token the decoder does emit (found by a first run without EOS), so
the finished-hypothesis paths run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import generation as jgen
from llm_bci_tpu_torch.models import generation as tgen

from tests.test_torch_port_llama import CONFIGS, build_pair

PAD, NEW = 0, 6


def hooks(config, variant):
    jm, params, tm = build_pair(config, variant)

    def jdecode(embeds, mask, cache, idx):
        return jm.apply({"params": params}, inputs_embeds=embeds, attention_mask=mask,
                        cache=cache, cache_index=idx)

    def tdecode(embeds, mask, cache, idx):
        # the prefill's int, then each token step's 0-dim position tensor
        assert idx == 0 if isinstance(idx, int) else (torch.is_tensor(idx) and idx.dim() == 0)
        return tm(inputs_embeds=embeds, attention_mask=mask, cache=cache, cache_index=idx)

    jembed = lambda ids: jm.apply({"params": params}, ids, method=jm.embed)
    return jm, tm, jdecode, tdecode, jembed, tm.embed


def prompt(config, B=3, P=5, seed=0):
    rng = np.random.default_rng(seed)
    H = CONFIGS[config]["hidden_size"]
    embeds = rng.normal(0, 0.5, size=(B, P, H)).astype(np.float32)
    mask = np.ones((B, P), np.int64)
    mask[1, 1] = 0                       # a padded key inside the prompt
    return embeds, mask


@pytest.mark.parametrize("config,variant", [("debug", "lora"), ("gqa", "int8")])
def test_greedy_tokens_equal_jax(config, variant):
    jm, tm, jdecode, tdecode, jembed, tembed = hooks(config, variant)
    embeds, mask = prompt(config)
    B, P, _ = embeds.shape

    def run_j(eos):
        return np.asarray(jgen.greedy_decode(
            jdecode, jembed, jnp.asarray(embeds), jnp.asarray(mask),
            jm.init_cache(B, P + NEW), NEW, eos, PAD))

    def run_t(eos):
        return tgen.greedy_decode(
            tdecode, tembed, torch.from_numpy(embeds), torch.from_numpy(mask),
            tm.init_cache(B, P + NEW), NEW, eos, PAD).numpy()

    free = run_j(-1)
    np.testing.assert_array_equal(run_t(-1), free)
    eos = int(free[0, 2])                # row 0 finishes at its third token
    ref, got = run_j(eos), run_t(eos)
    assert got.shape == (B, NEW) and got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 3:] == PAD).all() and got[0, 2] == eos


def _assert_beams_equal(got, ref):
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-4)


@pytest.mark.parametrize("early_stopping", [False, True])
@pytest.mark.parametrize("config,variant,length_penalty", [("debug", "lora", 1.0),
                                                           ("gqa", "int8", 0.6)])
def test_beam_search_equals_jax(config, variant, length_penalty, early_stopping):
    jm, tm, jdecode, tdecode, jembed, tembed = hooks(config, variant)
    embeds, mask = prompt(config, seed=1)
    B, P, _ = embeds.shape
    K = 3

    def run_j(eos):
        return jgen.beam_search(
            jdecode, jembed, jnp.asarray(embeds), jnp.asarray(mask),
            jm.init_cache(B * K, P + NEW), NEW, K, eos, PAD, length_penalty, early_stopping)

    def run_t(eos):
        return tgen.beam_search(
            tdecode, tembed, torch.from_numpy(embeds), torch.from_numpy(mask),
            tm.init_cache(B * K, P + NEW), NEW, K, eos, PAD, length_penalty, early_stopping)

    free = run_j(-1)
    _assert_beams_equal(run_t(-1), free)
    eos = int(np.asarray(free.sequences)[0, 0, 1])   # the best beam's second token
    ref, got = run_j(eos), run_t(eos)
    assert got.sequences.shape == (B, K, NEW) and got.scores.shape == (B, K)
    _assert_beams_equal(got, ref)
    seqs = got.sequences.numpy()
    assert (seqs == eos).any()                        # a hypothesis did finish
    assert (np.diff(got.scores.numpy(), axis=1) <= 0).all()   # sorted best-first


@pytest.mark.parametrize("config,variant,penalty", [("debug", "lora", 1.2), ("gqa", "int8", 0.5)])
def test_diverse_beam_search_equals_jax(config, variant, penalty):
    jm, tm, jdecode, tdecode, jembed, tembed = hooks(config, variant)
    embeds, mask = prompt(config, seed=2)
    B, P, _ = embeds.shape
    G = 4

    def run_j(eos):
        return jgen.diverse_beam_search(
            jdecode, jembed, jnp.asarray(embeds), jnp.asarray(mask),
            jm.init_cache(B * G, P + NEW), NEW, G, eos, PAD, 1.0, penalty)

    def run_t(eos):
        return tgen.diverse_beam_search(
            tdecode, tembed, torch.from_numpy(embeds), torch.from_numpy(mask),
            tm.init_cache(B * G, P + NEW), NEW, G, eos, PAD, 1.0, penalty)

    free = run_j(-1)
    _assert_beams_equal(run_t(-1), free)
    first = np.asarray(free.sequences)[:, :, 0]
    assert all(len(set(row)) == G for row in first)   # the penalty spreads the groups
    eos = int(np.asarray(free.sequences)[0, 0, 1])
    ref, got = run_j(eos), run_t(eos)
    _assert_beams_equal(got, ref)
    assert (got.sequences.numpy() == eos).any()


def test_top_k_stable_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, -1e9, 3.0, -1e9, 3.0, -1e9]])
    values, idx = tgen._top_k_stable(x, 4)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_v))


def test_gather_beams_reorders_rows():
    x = torch.arange(2 * 3 * 2).reshape(6, 2)
    idx = torch.tensor([[2, 0, 0], [1, 1, 2]])
    got = tgen._gather_beams(x, idx, 2, 3)
    ref = jgen._gather_beams(jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()), 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
