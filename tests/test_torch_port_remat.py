"""Remat (``models/remat.py``): each layer recomputed in the backward.

* The port's NDT1 (dense path, and the flash path through the plain version
  of its kernels) with ``remat`` on and off, training with dropout 0.3, white
  and offset noise and a ``random`` masker, all drawn from one generator:
  the same loss, the same gradients and the generator left in the same state,
  bit for bit (the recompute replays the generator's draws).
* The port's NDT1 with ``remat`` against the JAX package's ``nn.remat`` at
  the same weights (eval mode, a ``force_active`` co-smooth masker, no
  dropout; the JAX flash kernel in interpret mode): loss atol 1e-5 / rtol
  1e-5, parameter gradients atol 1e-4 (float32 sums in another order).
* Llama with ``remat=True`` against ``False``, LoRA dropout 0.2 on every
  projection, a float and an int8 base: identical loss and LoRA gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import ndt1 as jndt1
from llm_bci_tpu.ops import flash_attention as jfa
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.models import llama as tllama
from llm_bci_tpu_torch.models import ndt1 as tndt1

from tests.test_torch_port_ndt1_mlm import make_batch, model_config


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa.set_interpret_mode(True)
    yield
    jfa.set_interpret_mode(False)


def tt(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def run(model, batch, seed=None):
    """Loss, parameter gradients and the generator's final state of one
    forward / backward."""
    model.zero_grad(set_to_none=True)
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    out = model(**tt(batch), generator=generator)
    out.loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return out.loss.detach(), grads, None if generator is None else generator.get_state()


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_ndt1_remat_replays_dropout_noise_and_masks(flash):
    cfg = model_config(flash=flash, context=(4, 6))
    enc = cfg["encoder"]
    enc["masker"] = {"neuron": {"active": True, "mode": "random", "ratio": 0.3}}
    enc["smooth_and_noise"] = {"noise": True, "white_noise_sd": 0.5, "constant_offset_sd": 0.2}
    enc["embedder"]["dropout"] = 0.3
    enc["transformer"]["dropout"] = 0.3
    torch.manual_seed(0)
    model = tndt1.NDT1.from_config(cfg, method_name="mlm").train()
    assert model.encoder._use_flash_now(make_batch()["spikes"].shape[1]) == flash
    plain = run(model, make_batch(), seed=5)
    model.encoder.remat = True
    remat = run(model, make_batch(), seed=5)
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys() and len(plain[1]) > 10
    for name, g in plain[1].items():
        assert torch.equal(g, remat[1][name]), name
    assert torch.equal(plain[2], remat[2])
    # another generator state: another loss (the draws do matter)
    assert not torch.equal(run(model, make_batch(), seed=6)[0], plain[0])


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_ndt1_remat_matches_jax_remat(flash):
    cfg = model_config(flash=flash, context=(4, 6))
    cfg["encoder"]["remat"] = True
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jndt1.NDT1.from_config(cfg, compute_dtype="float32", method_name="mlm")
    rngs = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}
    init = jax.jit(lambda r, b: jmodel.init(r, **b, training=False)["params"])
    params = jax.device_get(init(rngs, jb))
    loss_fn = lambda p: jmodel.apply({"params": p}, **jb, training=False,
                                     rngs={"mask": jax.random.PRNGKey(1)}).loss
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = ndt1_state_dict_from_jax(jax.device_get(jgrads))

    tmodel = tndt1.NDT1.from_config(cfg, method_name="mlm")
    tmodel.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)
    assert tmodel.encoder.remat and tmodel.encoder._use_flash_now(batch["spikes"].shape[1]) == flash
    loss, grads, _ = run(tmodel.eval(), batch)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_llama_remat_replays_lora_dropout(quant):
    cfg = tllama.LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=48,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=64)
    targets = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    torch.manual_seed(0)
    model = tllama.LlamaForCausalLM(cfg, lora_r=2, lora_alpha=16.0, lora_dropout=0.2,
                                    lora_targets=targets, freeze_base=True, dtype=torch.float32,
                                    quant=quant, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0, 0.05)
    model.train()
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 96, size=(2, 9)))
    w = torch.from_numpy(rng.normal(size=(2, 9, 96)).astype(np.float32))
    results = []
    for remat in (False, True):
        model.remat = remat
        model.zero_grad(set_to_none=True)
        generator = torch.Generator().manual_seed(7)
        logits, _ = model(input_ids=ids, generator=generator)
        loss = (logits * w).sum()
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                        if p.grad is not None}, generator.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert g0.keys() == g1.keys() and len(g0) == 2 * 2 * len(targets)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
