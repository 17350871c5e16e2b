"""Llama parity: the port (``llm_bci_tpu_torch.models.llama``) against the JAX
package, on the CPU in float32.

Weights come from the JAX ``init`` (LoRA ``B`` overwritten with non-zero numpy
values) through ``llama_state_dict_from_jax`` and load with ``strict=True``.
Logits atol 1e-5 / rtol 1e-4 (as ``tests/test_torch_port_ndt1.py``), with and
without the KV cache (prefill + 3 single-token steps), for a trainable float
base, a frozen base stored in the compute dtype under LoRA and an int8 base,
at ``LlamaConfig.debug()`` and at a grouped-query config
(``num_key_value_heads=2``). Gradients of the LoRA leaves rtol 1e-4 with an
absolute floor of 1e-5 of the largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import llama as jllama
from llm_bci_tpu_torch.interop import llama_state_dict_from_jax
from llm_bci_tpu_torch.models import llama as tllama

FWD = dict(atol=1e-5, rtol=1e-4)
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
CONFIGS = {
    "debug": dict(dataclasses.asdict(jllama.LlamaConfig.debug()), vocab_size=320),
    "gqa": dict(vocab_size=128, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64),
    "tied": dict(vocab_size=96, hidden_size=32, intermediate_size=32, num_hidden_layers=1,
                 num_attention_heads=4, max_position_embeddings=64, tie_word_embeddings=True),
}
VARIANTS = {
    "float_base": dict(),
    # BCI builds its LLM with freeze_base = freeze_llm or lora_r > 0
    "lora": dict(lora_r=2, lora_alpha=16.0, lora_targets=TARGETS, freeze_base=True),
    "lora_qv_frozen": dict(lora_r=2, lora_alpha=16.0, lora_targets=("q_proj", "v_proj"),
                           freeze_base=True),
    "int8": dict(lora_r=2, lora_alpha=16.0, lora_targets=TARGETS, freeze_base=True,
                 quant="int8"),
    "int8_xla_frozen": dict(freeze_base=True, quant="int8_xla"),
}


def build_pair(config="debug", variant="lora", seed=0):
    """(JAX module, its params as numpy with non-zero LoRA B, the port's
    module loaded with them)."""
    kwargs = VARIANTS[variant]
    jcfg = jllama.LlamaConfig(**CONFIGS[config])
    jm = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32, **kwargs)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), input_ids=ids)["params"])
    rng = np.random.default_rng(seed + 1)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name == "lora_B":
            return rng.normal(0, 0.05, size=leaf.shape).astype(np.float32)
        if name == "kernel_scale":
            return (leaf * (0.5 + rng.random(leaf.shape))).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(fill, params)
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**CONFIGS[config]), dtype=torch.float32,
                                 **kwargs)
    sd = llama_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval()


def batch(config, B=2, T=9, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CONFIGS[config]["vocab_size"], size=(B, T)).astype(np.int64)
    mask = np.ones((B, T), np.int64)
    mask[1, T - 2:] = 0
    return ids, mask


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("config", ["debug", "gqa"])
def test_logits_match_jax(config, variant):
    jm, params, tm = build_pair(config, variant)
    ids, mask = batch(config)
    ref, _ = jm.apply({"params": params}, input_ids=jnp.asarray(ids),
                      attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, cache = tm(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


def test_tied_embeddings_and_inputs_embeds_and_positions():
    jm, params, tm = build_pair("tied", "float_base")
    assert not hasattr(tm, "lm_head")
    ids, mask = batch("tied")
    rng = np.random.default_rng(0)
    embeds = rng.normal(size=(2, 9, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 5, (2, 9)).astype(np.int64)
    ref, _ = jm.apply({"params": params}, inputs_embeds=jnp.asarray(embeds),
                      attention_mask=jnp.asarray(mask), positions=jnp.asarray(pos))
    with torch.no_grad():
        got, _ = tm(inputs_embeds=torch.from_numpy(embeds),
                    attention_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    emb = tm.embed(torch.from_numpy(ids))
    ref_emb = jm.apply({"params": params}, jnp.asarray(ids), method=jm.embed)
    np.testing.assert_array_equal(emb.detach().numpy(), np.asarray(ref_emb))


@pytest.mark.parametrize("variant", ["lora", "int8", "float_base"])
@pytest.mark.parametrize("config", ["debug", "gqa"])
def test_cached_decode_matches_full_forward_and_jax(config, variant):
    """Prefill of P tokens, then 3 single-token steps through the KV cache
    (updated in place) give the logits of one full forward, and the JAX
    package's cached logits."""
    jm, params, tm = build_pair(config, variant)
    ids, _ = batch(config, T=9)
    P, total = 6, 9
    key_mask = np.zeros((2, total), np.int64)
    key_mask[:, :P] = 1
    key_mask[1, 0] = 0                                   # a padded prompt key
    full_mask = np.ones((2, total), np.int64)
    full_mask[1, 0] = 0
    with torch.no_grad():
        full, _ = tm(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(full_mask))
        cache = tm.init_cache(2, total)
        km = torch.from_numpy(key_mask.copy())
        got, cache = tm(input_ids=torch.from_numpy(ids[:, :P]), attention_mask=km, cache=cache,
                        cache_index=0)
        steps = [got]
        for t in range(P, total):
            km[:, t] = 1
            got, cache = tm(input_ids=torch.from_numpy(ids[:, t:t + 1]), attention_mask=km,
                            cache=cache, cache_index=t)
            steps.append(got)
    # the padded position's own query sees no key: its row is a don't-care
    valid = full_mask.astype(bool)
    got = torch.cat(steps, dim=1).numpy()
    np.testing.assert_allclose(got[valid], full.numpy()[valid], **FWD)

    jcache = jm.init_cache(2, total)
    jkm = key_mask.copy()
    ref, jcache = jm.apply({"params": params}, input_ids=jnp.asarray(ids[:, :P]),
                           attention_mask=jnp.asarray(jkm), cache=jcache,
                           cache_index=jnp.int32(0))
    refs = [np.asarray(ref)]
    for t in range(P, total):
        jkm[:, t] = 1
        ref, jcache = jm.apply({"params": params}, input_ids=jnp.asarray(ids[:, t:t + 1]),
                               attention_mask=jnp.asarray(jkm), cache=jcache,
                               cache_index=jnp.int32(t))
        refs.append(np.asarray(ref))
    np.testing.assert_allclose(got[valid], np.concatenate(refs, axis=1)[valid], **FWD)
    np.testing.assert_allclose(cache[0]["k"].numpy(), np.asarray(jcache[0]["k"]), **FWD)


@pytest.mark.parametrize("variant", ["lora", "int8", "lora_qv_frozen"])
def test_lora_gradients_match_jax(variant):
    jm, params, tm = build_pair("gqa", variant)
    ids, mask = batch("gqa")
    w = np.random.default_rng(9).normal(size=(2, 9, CONFIGS["gqa"]["vocab_size"])).astype(
        np.float32)

    def loss(p):
        logits, _ = jm.apply({"params": p}, input_ids=jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask))
        return (logits * jnp.asarray(w)).sum()

    # integer leaves take no gradient: differentiate the float leaves only
    is_float = lambda x: np.issubdtype(np.asarray(x).dtype, np.floating)
    floats = jax.tree_util.tree_map(lambda x: x if is_float(x) else None, params)
    ints = jax.tree_util.tree_map(lambda x: None if is_float(x) else x, params)
    merge = lambda f: jax.tree_util.tree_map(
        lambda a, b: a if a is not None else b, f, ints, is_leaf=lambda x: x is None)
    grads = jax.device_get(jax.grad(lambda f: loss(merge(f)))(floats))
    mask_tree = jllama.lora_trainable_mask(params, freeze_all_base=True)
    ref = llama_state_dict_from_jax(jax.tree_util.tree_map(
        lambda g, p: np.zeros(np.shape(p), np.float32) if g is None else g, grads, params,
        is_leaf=lambda x: x is None))
    trainable = llama_state_dict_from_jax(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask_tree, params))

    tm.train()
    logits, _ = tm(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    (logits * torch.from_numpy(w)).sum().backward()
    named = dict(tm.named_parameters())
    top = max(float(p.grad.abs().max()) for p in named.values() if p.grad is not None)
    n_trainable = 0
    for key, p in named.items():
        # the requires_grad partition is lora_trainable_mask (all bases frozen here)
        kernel_key = key.replace(".weight", ".kernel") if key not in trainable else key
        assert p.requires_grad == bool(trainable[kernel_key].all()), key
        if not p.requires_grad:
            assert p.grad is None
            continue
        n_trainable += 1
        np.testing.assert_allclose(p.grad.numpy(), ref[key].numpy(), rtol=1e-4, atol=1e-5 * top,
                                   err_msg=key)
    assert n_trainable == 2 * 2 * (len(TARGETS) if variant != "lora_qv_frozen" else 2)
    for name, buf in tm.named_buffers():
        assert not buf.requires_grad


def test_float_base_trains_and_frozen_base_is_stored_in_compute_dtype():
    _, _, tm = build_pair("gqa", "float_base")
    assert all(p.requires_grad and p.dtype == torch.float32 for p in tm.parameters())
    cfg = tllama.LlamaConfig(**CONFIGS["gqa"])
    frozen = tllama.LlamaForCausalLM(cfg, lora_r=2, lora_targets=("q_proj",), freeze_base=True)
    for name, p in frozen.named_parameters():
        if ".lora_" in name:
            assert p.requires_grad and p.dtype == torch.float32
        else:
            # projections and embeddings in the compute dtype; norm weights float32
            want = torch.float32 if "norm" in name else torch.bfloat16
            assert not p.requires_grad and p.dtype == want, name
    q = tllama.LlamaForCausalLM(cfg, lora_r=2, lora_targets=("q_proj",), freeze_base=True,
                                quant="int8")
    attn = q.model.layers[0].self_attn
    assert attn.q_proj.kernel.dtype == torch.int8 and attn.q_proj.kernel.shape == (32, 32)
    assert attn.k_proj.kernel_scale.dtype == torch.float32
    assert q.lm_head.kernel.shape == (32, 128)       # lm_head is quantized with a frozen base
    assert float(attn.q_proj.kernel.float().std()) > 10.0   # +-4 sigma over the int8 range
    with pytest.raises(ValueError, match="frozen base"):
        tllama.LoRADense(8, 8, quant="int8")
    with pytest.raises(ValueError, match="unknown quant"):
        tllama.LlamaForCausalLM(cfg, quant="int4")
    # remat is ported (tests/test_torch_port_remat.py holds it to the plain stack)
    assert tllama.LlamaForCausalLM(cfg, remat=True).remat


def test_quantize_llama_params_equals_jax_package():
    jm, params, tm = build_pair("gqa", "lora")
    ref = llama_state_dict_from_jax(jllama.quantize_llama_params(params))
    got = tllama.quantize_llama_params(tm.state_dict())
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), ref[key].numpy(), err_msg=key)
    no_head = tllama.quantize_llama_params(tm.state_dict(), quant_lm_head=False)
    assert "lm_head.weight" in no_head and "lm_head.kernel" not in no_head
    # the quantized dict loads into an int8 model, LoRA factors included
    qm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**CONFIGS["gqa"]), dtype=torch.float32,
                                 **VARIANTS["int8"])
    tllama.load_base_state_dict(qm, got)
    ids, mask = batch("gqa")
    with torch.no_grad():
        a, _ = qm(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
        b, _ = tm(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    # int8 rounding of the base: close to, not equal to, the float model
    assert float((a - b).abs().max()) < 0.05 * float(b.abs().max())
    with pytest.raises(RuntimeError, match="do not fit"):
        tllama.load_base_state_dict(qm, {"model.norm.weight": torch.ones(32)})


def test_make_causal_padding_mask_matches_jax():
    am = np.array([[1, 1, 0, 1, 1, 0], [0, 1, 1, 1, 1, 1]], np.int64)
    for q_len, off in ((6, 0), (1, 4), (2, 3)):
        ref = jllama.make_causal_padding_mask(jnp.asarray(am), q_len, off)
        got = tllama.make_causal_padding_mask(torch.from_numpy(am), q_len, off)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_grouped_lora_dropout_shares_one_mask_and_keeps_its_share():
    """Under ``lora_dropout`` in training the q / k / v deltas share one keep
    mask of the input (drawn from the explicit generator), and the kept
    share is 1 - p."""
    rate, H = 0.25, 64
    g = torch.Generator().manual_seed(0)
    x = torch.ones(4, 50, H)
    layers = [tllama.LoRADense(H, 8, r=H, alpha=float(H), lora_dropout=rate, dtype=torch.float32,
                               generator=g) for _ in range(3)]
    with torch.no_grad():
        for layer in layers:
            layer.weight.zero_()
            layer.lora_A.copy_(torch.eye(H))           # h @ A = the dropped input
            layer.lora_B.zero_()
            layer.lora_B[:8, :8] = torch.eye(8)        # delta = the first 8 inputs
    seen = []

    def drop(t):
        out = tllama.dropout(t, rate, True, g)
        seen.append(out)
        return out

    outs = tllama.apply_lora_group(x, [layer(x, defer_lora=True) for layer in layers],
                                   alpha=float(H), r=H, dropout_fn=drop)
    assert len(seen) == 1                                    # one draw for the group
    kept = seen[0] != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.02
    torch.testing.assert_close(seen[0][kept], torch.full_like(seen[0][kept], 1 / (1 - rate)))
    for out in outs:                                         # every projection saw that mask
        torch.testing.assert_close(out, seen[0][..., :8])
    # eval: no dropout, the grouped delta equals the per-adapter one
    for layer in layers:
        layer.eval()
    grouped = tllama.apply_lora_group(x, [layer(x, defer_lora=True) for layer in layers],
                                      alpha=float(H), r=H)
    for out, layer in zip(grouped, layers):
        torch.testing.assert_close(out, layer(x))


def test_load_hf_llama_params_is_a_strict_load(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, attn_implementation="eager",
    )).to(torch.float32).eval()
    hf.save_pretrained(str(tmp_path / "hf"))
    cfg = tllama.LlamaConfig(**CONFIGS["gqa"])
    ids, mask = batch("gqa")
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).logits
    tm = tllama.LlamaForCausalLM(cfg, dtype=torch.float32).eval()
    sd = tllama.load_hf_llama_params(str(tmp_path / "hf"), cfg)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, _ = tm(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], ref.numpy()[valid], **FWD)
    # quantized on the way in, under LoRA: everything but the LoRA factors loads
    qm = tllama.LlamaForCausalLM(cfg, dtype=torch.float32, **VARIANTS["int8"]).eval()
    tllama.load_base_state_dict(qm, tllama.load_hf_llama_params(str(tmp_path / "hf"), cfg, "int8"))
    with torch.no_grad():
        qgot, _ = qm(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert float((qgot - got).abs().max()) < 0.05 * float(got.abs().max())
