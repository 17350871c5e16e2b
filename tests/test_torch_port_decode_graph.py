"""The decode's token step over static buffers, on the CPU, in float32.

* ``LlamaForCausalLM.forward`` with ``cache_index`` a 0-dim tensor gives
  logits and KV cache bit-identical to the int form (one and two tokens a
  step), at the debug config and at a grouped-query config;
* :class:`TokenStep` on a CPU tensor calls the step function every time (no
  capture, no replay) and returns its logits unchanged;
* greedy through the token step gives the ids of an eager loop that feeds
  int positions, as generation did before the step was graphed;
* beam search writes its reordered cache and key mask into the token step's
  buffers: every step sees the same tensors;
* every decode builds its own token step over the cache it was given, so
  that nothing of one decode (its cache, its graph) is replayed by the next;
  two decodes in a row give the ids and scores of each run alone.

The JAX parity of greedy, beam and diverse beam through the token step is in
``tests/test_torch_port_generation.py`` and ``tests/test_torch_port_bci.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from llm_bci_tpu_torch.models import decode_graph
from llm_bci_tpu_torch.models import generation as tgen
from llm_bci_tpu_torch.models import llama as tllama

CONFIGS = {
    "debug": dataclasses.replace(tllama.LlamaConfig.debug(), vocab_size=320),
    "gqa": tllama.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=48,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                              max_position_embeddings=64),
}
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def model(config, quant=None, seed=0):
    torch.manual_seed(seed)
    m = tllama.LlamaForCausalLM(CONFIGS[config], lora_r=2, lora_alpha=16.0, lora_targets=TARGETS,
                                freeze_base=True, dtype=torch.float32, quant=quant).eval()
    with torch.no_grad():                     # LoRA B non-zero, so the adapters act
        for name, p in m.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.05)
    return m


def prompt(config, B=3, P=5, seed=0):
    rng = np.random.default_rng(seed)
    embeds = torch.from_numpy(rng.normal(0, 0.5, (B, P, CONFIGS[config].hidden_size))
                              .astype(np.float32))
    mask = torch.ones((B, P), dtype=torch.int64)
    mask[1, 1] = 0                           # a padded key inside the prompt
    return embeds, mask


@pytest.mark.parametrize("config,quant", [("debug", None), ("gqa", "int8")])
@pytest.mark.parametrize("T", [1, 2])
@torch.no_grad()
def test_tensor_cache_index_is_bit_identical_to_the_int(config, quant, T):
    m = model(config, quant)
    embeds, mask = prompt(config)
    B, P, H = embeds.shape
    S = P + 3 * T
    key_mask = torch.zeros((B, S), dtype=torch.int64)
    key_mask[:, :P] = mask
    caches = [m.init_cache(B, S), m.init_cache(B, S)]
    for cache in caches:
        m(inputs_embeds=embeds, attention_mask=key_mask, cache=cache, cache_index=0)
    rng = np.random.default_rng(1)
    for step in range(3):
        at = P + step * T
        key_mask[:, at:at + T] = 1
        x = torch.from_numpy(rng.normal(0, 0.5, (B, T, H)).astype(np.float32))
        by_int, _ = m(inputs_embeds=x, attention_mask=key_mask, cache=caches[0], cache_index=at)
        by_tensor, _ = m(inputs_embeds=x, attention_mask=key_mask, cache=caches[1],
                         cache_index=torch.tensor(at))
        assert torch.equal(by_int, by_tensor)
        for a, b in zip(caches[0], caches[1]):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert caches[1][0]["k"][:, P:].abs().sum() > 0          # the steps did write


@torch.no_grad()
def test_token_step_on_the_cpu_calls_the_step_every_time():
    m = model("debug")
    embeds, mask = prompt("debug")
    B, P, _ = embeds.shape
    key_mask = torch.zeros((B, P + 2), dtype=torch.int64)
    key_mask[:, :P] = mask
    cache = m.init_cache(B, P + 2)
    calls = []

    def decode_step(e, km, c, idx):
        calls.append((idx.clone(), c is cache, km is key_mask))
        return m(inputs_embeds=e, attention_mask=km, cache=c, cache_index=idx)

    m(inputs_embeds=embeds, attention_mask=key_mask, cache=cache, cache_index=0)
    decode_graph.reset_counters()
    step = decode_graph.TokenStep(decode_step, cache, key_mask)
    x = m.embed(torch.tensor([[5], [6], [7]]))
    key_mask[:, P] = 1
    got = step(x, P).clone()
    assert got.shape == (B, CONFIGS["debug"].vocab_size)
    key_mask[:, P + 1] = 1
    step(x, P + 1)
    assert [(int(i), c, k) for i, c, k in calls] == [(P, True, True), (P + 1, True, True)]
    assert (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS) == (2, 0, 0)
    # the first step's logits are those of a direct call on a cache of the prompt
    cache2 = m.init_cache(B, P + 2)
    km = key_mask.clone()
    km[:, P + 1] = 0
    m(inputs_embeds=embeds, attention_mask=km, cache=cache2, cache_index=0)
    ref, _ = m(inputs_embeds=x, attention_mask=km, cache=cache2, cache_index=P)
    assert torch.equal(got, ref[:, -1, :])


@pytest.mark.parametrize("config,quant", [("debug", None), ("gqa", "int8")])
def test_greedy_through_the_token_step_equals_an_eager_loop(config, quant):
    m = model(config, quant)
    embeds, mask = prompt(config)
    B, P, _ = embeds.shape
    new = 6
    decode = lambda e, km, c, idx: m(inputs_embeds=e, attention_mask=km, cache=c, cache_index=idx)
    got = tgen.greedy_decode(decode, m.embed, embeds, mask, m.init_cache(B, P + new), new, -1, 0)
    # the loop as it ran before the step had static buffers: int positions
    with torch.no_grad():
        key_mask = torch.zeros((B, P + new), dtype=torch.int64)
        key_mask[:, :P] = mask
        cache = m.init_cache(B, P + new)
        logits, _ = m(inputs_embeds=embeds, attention_mask=key_mask, cache=cache, cache_index=0)
        ids = []
        for t in range(new):
            token = logits[:, -1, :].argmax(-1)
            ids.append(token)
            key_mask[:, P + t] = 1
            logits, _ = m(inputs_embeds=m.embed(token[:, None]), attention_mask=key_mask,
                          cache=cache, cache_index=P + t)
    assert torch.equal(got, torch.stack(ids, 1))


def test_beam_search_reorders_into_the_static_buffers():
    m = model("debug")
    embeds, mask = prompt("debug", seed=1)
    B, P, _ = embeds.shape
    K, new = 3, 5
    seen = []

    def decode(e, km, c, idx):
        seen.append((km.data_ptr(), tuple(x.data_ptr() for layer in c for x in layer.values())))
        return m(inputs_embeds=e, attention_mask=km, cache=c, cache_index=idx)

    result = tgen.beam_search(decode, m.embed, embeds, mask, m.init_cache(B * K, P + new), new,
                              K, -1, 0)
    assert result.sequences.shape == (B, K, new)
    assert len(seen) == new and len(set(seen)) == 1        # prefill and every step: one set


@pytest.mark.parametrize("search", ["greedy", "beam", "diverse"])
def test_every_decode_builds_its_own_token_step(search, monkeypatch):
    m = model("debug")
    decode = lambda e, km, c, idx: m(inputs_embeds=e, attention_mask=km, cache=c, cache_index=idx)
    new, K = 5, 3
    rows = 3 if search == "greedy" else 3 * K
    built = []

    class Recorded(decode_graph.TokenStep):
        def __init__(self, *args):
            super().__init__(*args)
            built.append(self)

    def run(seed):
        embeds, mask = prompt("debug", seed=seed)
        cache = m.init_cache(rows, 5 + new)
        if search == "greedy":
            out = (tgen.greedy_decode(decode, m.embed, embeds, mask, cache, new, -1, 0),)
        elif search == "beam":
            r = tgen.beam_search(decode, m.embed, embeds, mask, cache, new, K, 7, 0)
            out = (r.sequences, r.scores)
        else:
            r = tgen.diverse_beam_search(decode, m.embed, embeds, mask, cache, new, K, 7, 0,
                                         1.0, 1.2)
            out = (r.sequences, r.scores)
        return out, cache

    alone = [run(seed)[0] for seed in (1, 2)]
    monkeypatch.setattr(tgen, "TokenStep", Recorded)
    in_turn = [run(seed) for seed in (1, 2)]
    assert len(built) == 2 and built[0] is not built[1]
    for step, (out, cache), want in zip(built, in_turn, alone):
        assert step.cache is cache                        # over the decode's own cache
        assert tuple(step.key_mask.shape) == (rows, 5 + new)
        assert all(torch.equal(g, w) for g, w in zip(out, want))
