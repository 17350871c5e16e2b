"""NDT1 mlm / autoregressive parity: the port against the JAX package.

The same weights (carried by ``ndt1_state_dict_from_jax``) and the same numpy
inputs go through both in float32, in eval mode with a ``force_active``
``co-smooth`` masker (deterministic), padding on the left. On the flash path
the JAX package runs its Pallas kernels in interpret mode
(``flash_attention: true``) and the port the plain version of its CUDA
kernels. Forward tolerance atol 1e-5 / rtol 1e-4 (float32 sums in another
order), loss rtol 1e-4; parameter gradients rtol 1e-3 with an absolute floor
of 1e-5 of the largest gradient entry (entries that cancel to near zero; the
Poisson loss's exp amplifies rounding more than CTC does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import ndt1 as jndt1
from llm_bci_tpu.ops import flash_attention as jfa
from llm_bci_tpu.ops import losses as jlosses
from llm_bci_tpu.ops import rotary as jrotary
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.models import ndt1 as tndt1
from llm_bci_tpu_torch.ops import losses as tlosses
from llm_bci_tpu_torch.ops import rotary as trotary

B, T, C = 3, 24, 8
FWD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa.set_interpret_mode(True)
    yield
    jfa.set_interpret_mode(False)


def model_config(flash=False, context=(-2, -2), use_rope=False, **embedder):
    emb = {"n_channels": C, "input_dim": 8, "max_F": 64, "n_days": 3, "n_blocks": 4,
           "dropout": 0.0, "stack": {"active": False}}
    emb.update(embedder)
    return {"encoder": {
        "masker": {"neuron": {"active": True, "force_active": True, "mode": "co-smooth",
                              "channels": [1, 4], "zero_ratio": 1.0}},
        "context": {"forward": context[0], "backward": context[1]},
        "smooth_and_noise": {"noise": False},
        "embedder": emb,
        "transformer": {"n_layers": 2, "hidden_size": 32, "n_heads": 4, "inter_size": 32,
                        "dropout": 0.0, "use_rope": use_rope, "flash_attention": flash},
    }}


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 7, T - 11], np.int64)
    mask = (np.arange(T)[None, :] >= (T - lengths)[:, None]).astype(np.int64)   # left padding
    spikes = (rng.poisson(1.5, size=(B, T, C)) * mask[:, :, None]).astype(np.float32)
    return {
        "spikes": spikes,
        "spikes_mask": mask,
        "spikes_timestamp": np.broadcast_to(np.arange(T), (B, T)).astype(np.int64),
        "spikes_lengths": lengths,
        "block_idx": np.array([0, 3, 1], np.int64),
        "day_idx": np.array([2, 0, 1], np.int64),
    }


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tt(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


RNGS = {"mask": jax.random.PRNGKey(1), "sample": jax.random.PRNGKey(2)}


def build_pair(cfg, method="mlm", seed=0, **kw):
    kw = dict(method_name=method, **kw)
    jmodel = jndt1.NDT1.from_config(cfg, compute_dtype="float32", **kw)
    batch = make_batch(seed)
    params = jmodel.init({"params": jax.random.PRNGKey(seed), **RNGS}, **jx(batch),
                         training=False)["params"]
    params = jax.device_get(params)
    tmodel = tndt1.NDT1.from_config(cfg, **kw)
    tmodel.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)
    tmodel.eval()
    return jmodel, params, tmodel, batch


def assert_forward_and_grads(cfg, method, **kw):
    jmodel, params, tmodel, batch = build_pair(cfg, method, **kw)

    def run(p):
        return jmodel.apply({"params": p}, **jx(batch), training=False, rngs=RNGS)

    ref = run(params)
    out = tmodel(**tt(batch))
    np.testing.assert_allclose(out.preds.detach().numpy(), np.asarray(ref.preds), **FWD)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), rtol=1e-4)
    assert int(out.n_examples) == int(ref.n_examples) > 0
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.targets.numpy(), np.asarray(ref.targets))

    jgrads = ndt1_state_dict_from_jax(jax.device_get(jax.grad(lambda p: run(p).loss)(params)))
    out.loss.backward()
    tgrads = dict(tmodel.named_parameters())
    assert set(jgrads) == set(tgrads)
    floor = 1e-5 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name].grad.numpy(), g.numpy(), rtol=1e-3, atol=floor,
                                   err_msg=name)
    return out


VARIANTS = {
    "plain": {},
    "rope_banded": dict(context=(3, 5), use_rope=True, pos=False),
    "log_input_false": {},
}


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mlm_forward_and_grads(variant, flash):
    kw = dict(log_input=False) if variant == "log_input_false" else {}
    out = assert_forward_and_grads(model_config(flash=flash, **VARIANTS[variant]), "mlm", **kw)
    # the targets are the masked channels of the valid bins only
    batch = make_batch()
    want = np.zeros((B, T, C), bool)
    want[:, :, [1, 4]] = True
    want &= batch["spikes_mask"][:, :, None].astype(bool)
    np.testing.assert_array_equal(out.mask.numpy().astype(bool), want)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("loss", ["poisson_nll", "mse"])
def test_autoregressive_forward_and_grads(loss, flash):
    cfg = model_config(flash=flash, context=(0, -2))
    cfg["encoder"]["masker"]["neuron"]["active"] = False
    out = assert_forward_and_grads(cfg, "autoregressive", loss=loss)
    batch = make_batch()
    assert int(out.n_examples) == int(batch["spikes_mask"][:, :-1].sum()) * C


def test_flash_path_is_taken_and_differs_on_padded_rows():
    # the dense path lets a padded query attend to itself, the flash path
    # gives it 0: the two paths differ there and only there
    _, _, dense, batch = build_pair(model_config(flash=False, context=(0, 2)))
    flash = tndt1.NDT1.from_config(model_config(flash=True, context=(0, 2)), method_name="mlm")
    flash.load_state_dict(dense.state_dict())
    flash.eval()
    assert flash.encoder._use_flash_now(T) and not dense.encoder._use_flash_now(T)
    a, b = dense(**tt(batch)).preds, flash(**tt(batch)).preds
    pad = torch.from_numpy(batch["spikes_mask"] == 0)
    assert (a[pad] - b[pad]).abs().max() > 1e-3
    # a valid query whose band holds padded keys still sees itself on both paths
    torch.testing.assert_close(a[~pad], b[~pad], atol=1e-5, rtol=1e-4)


def test_flash_dispatch():
    enc = lambda **kw: tndt1.NDT1.from_config(model_config(**kw), method_name="mlm").encoder
    auto = enc(flash="auto")
    assert not auto._use_flash_now(tndt1.FLASH_AUTO_MIN_T - 1)
    assert auto._use_flash_now(tndt1.FLASH_AUTO_MIN_T)
    assert enc(flash=True)._use_flash_now(8) and not enc(flash=False)._use_flash_now(4096)
    assert not enc(flash=True, context=(-1, -2))._use_flash_now(4096)    # -1: dense only
    assert not enc(flash=True, context=(2, -1))._use_flash_now(4096)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_day_and_block_tokens_are_trimmed(flash):
    out = assert_forward_and_grads(
        model_config(flash=flash, day_token=True, block_token=True), "mlm")
    assert tuple(out.preds.shape) == (B, T, C) and tuple(out.mask.shape) == (B, T, C)


@pytest.mark.parametrize("method,context", [("mlm", (-2, -2)), ("autoregressive", (0, -2))])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_generate_mse_equals_jax(method, context, flash):
    cfg = model_config(flash=flash, context=context)
    # the JAX generate scans without a "mask" stream: the masker stays
    # active (mlm needs one) but is not forced in eval
    cfg["encoder"]["masker"]["neuron"]["force_active"] = False
    jmodel, params, tmodel, batch = build_pair(cfg, method, loss="mse")
    args = ("spikes", "spikes_mask", "spikes_timestamp", "spikes_lengths")
    jb, tb = jx(batch), tt(batch)
    ref_p, ref_b = jmodel.apply({"params": params}, *[jb[a] for a in args],
                                method=jmodel.generate, max_new_bins=3, rngs=RNGS)
    was = tmodel.training
    preds, bins = tmodel.generate(*[tb[a] for a in args], max_new_bins=3)
    assert tmodel.training == was
    assert tuple(preds.shape) == (B, 3, C)
    np.testing.assert_allclose(preds.numpy(), np.asarray(ref_p), **FWD)
    np.testing.assert_allclose(bins.numpy(), np.asarray(ref_b), **FWD)


@pytest.mark.parametrize("method,context", [("mlm", (-2, -2)), ("autoregressive", (0, -2))])
def test_generate_poisson_samples_from_the_generator(method, context):
    _, _, tmodel, batch = build_pair(model_config(context=context), method)
    tb = tt(batch)
    args = [tb[a] for a in ("spikes", "spikes_mask", "spikes_timestamp")]
    run = lambda s: tmodel.generate(*args, max_new_bins=4,
                                    generator=torch.Generator().manual_seed(s))
    preds, bins = run(0)
    assert tuple(preds.shape) == tuple(bins.shape) == (B, 4, C)
    assert torch.isfinite(preds).all() and (preds > 0).all()         # rates: exp of the logs
    assert (bins >= 0).all() and torch.equal(bins, bins.round())
    assert torch.equal(run(0)[1], bins) and not torch.equal(run(1)[1], bins)
    with pytest.raises(ValueError, match="generate not supported"):
        stack = {"active": True, "size": 4, "stride": 2}
        cfg = model_config(stack=stack)
        tndt1.NDT1.from_config(cfg, method_name="ctc", vocab_size=5).generate(*args)


def test_config_errors_match_jax():
    def both(cfg, method, match):
        with pytest.raises(ValueError, match=match):
            tndt1.NDT1.from_config(cfg, method_name=method)
        with pytest.raises(ValueError, match=match):
            jm = jndt1.NDT1.from_config(cfg, method_name=method)
            jm.init({"params": jax.random.PRNGKey(0), **RNGS}, **jx(make_batch()))

    inactive = model_config()
    inactive["encoder"]["masker"]["neuron"]["active"] = False
    both(inactive, "mlm", "inactive masking")
    stacked = model_config(stack={"active": True, "size": 4, "stride": 2})
    both(stacked, "mlm", "stacked inputs")
    both(model_config(), "autoregressive", "context.forward == 0")
    both(model_config(context=(0, -2), stack={"active": True, "size": 4, "stride": 2}),
         "autoregressive", "stacked inputs")
    both(model_config(), "no_such_method", "not implemented")
    with pytest.raises(ValueError, match="Loss"):
        m = tndt1.NDT1.from_config(model_config(), method_name="mlm", loss="huber")
        m.eval()(**tt(make_batch()))


def test_bridge_covers_the_mlm_tree():
    # decoder width n_channels; RoPE model without a position table
    _, params, tmodel, _ = build_pair(model_config(use_rope=True, pos=False))
    sd = ndt1_state_dict_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    assert tuple(sd["decoder.weight"].shape) == (C, 32)
    assert "encoder.embedder.embed_pos.weight" not in sd
    _, params, tmodel, _ = build_pair(model_config())
    sd = ndt1_state_dict_from_jax(params)
    assert set(sd) == set(tmodel.state_dict()) and "encoder.embedder.embed_pos.weight" in sd


@pytest.mark.parametrize("log_input", [True, False])
def test_losses_match_jax(log_input):
    rng = np.random.default_rng(0)
    preds = rng.normal(size=(4, 7, 5)).astype(np.float32)
    if not log_input:
        preds = np.abs(preds)
    targets = rng.poisson(2.0, size=(4, 7, 5)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        tlosses.poisson_nll_loss(t(preds), t(targets), log_input).numpy(),
        np.asarray(jlosses.poisson_nll_loss(jnp.asarray(preds), jnp.asarray(targets), log_input)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlosses.mse_loss(t(preds), t(targets)).numpy(),
        np.asarray(jlosses.mse_loss(jnp.asarray(preds), jnp.asarray(targets))), rtol=1e-6)
    labels = rng.integers(0, 5, size=(4, 7))
    labels[0, :3] = -100
    np.testing.assert_allclose(
        tlosses.cross_entropy_loss(t(preds), t(labels)).numpy(),
        np.asarray(jlosses.cross_entropy_loss(jnp.asarray(preds), jnp.asarray(labels))),
        rtol=1e-5, atol=1e-6)
    ref = torch.nn.functional.cross_entropy(t(preds).reshape(-1, 5), t(labels).reshape(-1),
                                            reduction="none", ignore_index=-100)
    np.testing.assert_allclose(tlosses.cross_entropy_loss(t(preds), t(labels)).reshape(-1).numpy(),
                               ref.numpy(), rtol=1e-5, atol=1e-6)


def test_rotary_matches_jax():
    cos, sin = trotary.rope_cos_sin(8, 32, 10000.0)
    jcos, jsin = jrotary.rope_cos_sin(8, 32, 10000.0)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 3, 10, 8)).astype(np.float32)
    k = rng.normal(size=(2, 3, 10, 8)).astype(np.float32)
    pos = rng.integers(0, 32, size=(2, 10))
    rq, rk = jrotary.apply_rotary_pos_emb(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                                          jnp.asarray(cos), jnp.asarray(sin))
    t = torch.from_numpy
    oq, ok = trotary.apply_rotary_pos_emb(t(q), t(k), t(pos), t(cos), t(sin))
    np.testing.assert_allclose(oq.numpy(), np.asarray(rq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ok.numpy(), np.asarray(rk), rtol=1e-6, atol=1e-6)
