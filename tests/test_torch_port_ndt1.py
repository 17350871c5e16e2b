"""NDT1 parity: the port (llm_bci_tpu_torch) against the JAX package.

The same weights (carried by ``ndt1_state_dict_from_jax``) and the same
numpy inputs go through both, in float32 with noise and dropout off.
Forward tolerance atol 1e-5 / rtol 1e-4; parameter gradients rtol 1e-4,
plus an absolute floor of 1e-5 of the largest gradient entry of the model
for entries that cancel to near zero (the key bias's gradient is zero in
exact arithmetic: softmax ignores a shift shared by all keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.interop.torch_export import _emit_ndt1_encoder
from llm_bci_tpu.models import ndt1 as jndt1
from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
from llm_bci_tpu_torch.models import ndt1 as tndt1

B, T, C, V, S = 3, 40, 8, 11, 6
FWD = dict(atol=1e-5, rtol=1e-4)


def model_config(**embedder):
    emb = {
        "n_channels": C, "input_dim": 8, "max_F": 64, "n_days": 3, "n_blocks": 4,
        "dropout": 0.0, "stack": {"active": True, "size": 4, "stride": 2},
    }
    emb.update(embedder)
    return {
        "encoder": {
            "masker": {"neuron": {"active": False}},
            "smooth_and_noise": {"noise": False},
            "embedder": emb,
            "transformer": {
                "n_layers": 2, "hidden_size": 32, "n_heads": 4, "inter_size": 32,
                "dropout": 0.0,
            },
        },
    }


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 9, T - 15], np.int64)
    spikes = rng.normal(size=(B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int64)
    spikes *= mask[:, :, None]
    tl = np.array([S, 3, 0], np.int64)
    targets = rng.integers(1, V, size=(B, S)).astype(np.int64)
    return {
        "spikes": spikes,
        "spikes_mask": mask,
        "spikes_timestamp": np.broadcast_to(np.arange(T), (B, T)).astype(np.int64),
        "spikes_lengths": lengths,
        "targets": targets,
        "targets_lengths": tl,
        "block_idx": np.array([0, 3, 1], np.int64),
        "day_idx": np.array([2, 0, 1], np.int64),
    }


def build_pair(cfg, seed=0):
    """JAX NDT1 + params, and the port NDT1 with the same weights."""
    kw = dict(method_name="ctc", vocab_size=V, blank_id=0, zero_infinity=True)
    jmodel = jndt1.NDT1.from_config(cfg, compute_dtype="float32", **kw)
    batch = make_batch(seed)
    params = jmodel.init(
        {"params": jax.random.PRNGKey(seed)}, **{k: jnp.asarray(v) for k, v in batch.items()},
        training=False,
    )["params"]
    params = jax.device_get(params)
    tmodel = tndt1.NDT1.from_config(cfg, **kw)
    tmodel.load_state_dict(ndt1_state_dict_from_jax(params), strict=True)
    tmodel.eval()
    return jmodel, params, tmodel, batch


def tt(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("smooth_sd", [2, 1.5])
def test_smooth_and_noise_parity(smooth_sd):
    # sd 1.5 gives an even window (10 taps): asymmetric 'same' padding.
    x = np.random.default_rng(1).normal(size=(B, T, C)).astype(np.float32)
    kw = dict(noise=False, smooth_sd=smooth_sd, white_noise_sd=1.0, constant_offset_sd=0.2)
    ref = jndt1.SmoothAndNoise(**kw).apply({}, jnp.asarray(x), training=False)
    port = tndt1.SmoothAndNoise(**kw).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **FWD)


def test_stack_projection_parity():
    x = np.random.default_rng(2).normal(size=(B, T, 8)).astype(np.float32)
    jmod = jndt1.StackProjection(hidden_size=32, size=4, stride=2)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tndt1.StackProjection(8, 32, 4, 2)
    tmod.load_state_dict({
        "weight": torch.from_numpy(np.asarray(params["kernel"]).T.copy()),
        "bias": torch.from_numpy(np.array(params["bias"])),
    })
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), **FWD)


EMBEDDERS = {
    "flagship": {},
    "adapt_day_block": {"adapt": True, "day_token": True, "block_token": True},
    "unstacked": {"stack": {"active": False}},
}


@pytest.mark.parametrize("variant", sorted(EMBEDDERS))
def test_embedder_parity(variant):
    jmodel, params, tmodel, batch = build_pair(model_config(**EMBEDDERS[variant]))
    args = ("spikes", "spikes_mask", "spikes_timestamp", "block_idx", "day_idx")
    ref = jmodel.apply(
        {"params": params}, *[jnp.asarray(batch[a]) for a in args],
        method=lambda m, *a: m.encoder.embedder(*a, training=False),
    )
    tb = tt(batch)
    port = tmodel.encoder.embedder(*[tb[a] for a in args])
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), **FWD)


def test_encoder_layer_parity_with_padded_rows():
    jmodel, params, tmodel, batch = build_pair(model_config())
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 19, 32)).astype(np.float32)
    valid = np.ones((B, 19), np.int64)
    valid[1, 12:] = 0
    valid[2, 5:] = 0
    context = np.ones((19, 19), np.int64)
    from llm_bci_tpu.ops.attention import make_attention_mask as jmask

    ref = jmodel.apply(
        {"params": params}, jnp.asarray(x), jmask(jnp.asarray(valid), jnp.asarray(context)),
        method=lambda m, x, mask: m.encoder.layers[0](x, mask, None, None, False),
    )
    tmask = tndt1.make_attention_mask(torch.from_numpy(valid), torch.from_numpy(context))
    port = tmodel.encoder.layers[0](torch.from_numpy(x), tmask)
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("variant", ["flagship", "pad_to_multiple"])
def test_ndt1_ctc_forward_parity(variant):
    # pad_to_multiple=8 pads the 19 stacked frames to 24; the pad frames'
    # log-probs are pinned to blank
    embedder = {"stack": {"active": True, "size": 4, "stride": 2, "pad_to_multiple": 8}}
    cfg = model_config(**(embedder if variant == "pad_to_multiple" else {}))
    jmodel, params, tmodel, batch = build_pair(cfg)
    ref = jmodel.apply(
        {"params": params}, **{k: jnp.asarray(v) for k, v in batch.items()}, training=False
    )
    out = tmodel(**tt(batch))
    np.testing.assert_allclose(out.preds.detach().numpy(), np.asarray(ref.preds), **FWD)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **FWD)
    assert int(out.n_examples) == B


def test_ndt1_ctc_param_grad_parity():
    jmodel, params, tmodel, batch = build_pair(model_config())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jmodel.apply({"params": p}, **jb, training=False).loss

    jgrads = ndt1_state_dict_from_jax(jax.device_get(jax.grad(loss_fn)(params)))
    tmodel(**tt(batch)).loss.backward()
    tgrads = dict(tmodel.named_parameters())
    assert set(jgrads) == set(tgrads)
    floor = 1e-5 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(
            tgrads[name].grad.numpy(), g.numpy(), rtol=1e-4, atol=floor, err_msg=name
        )


@pytest.mark.parametrize("variant", sorted(EMBEDDERS))
def test_bridge_matches_reference_export(variant):
    _, params, _, _ = build_pair(model_config(**EMBEDDERS[variant]))
    sd = ndt1_state_dict_from_jax(params)
    ref = _emit_ndt1_encoder(params["encoder"]).sd
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    assert set(enc) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(enc[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(sd["decoder.weight"].numpy(), np.asarray(params["decoder"]["kernel"]).T)


def test_unported_options_raise(tmp_path):
    # encoder.from_pt and decoder.from_pt build and load (the encoder and a
    # head of this shape from the encoder's directory, the head alone from
    # the decoder's), and endtoend is the ctc head under another name
    trained = tndt1.NDT1.from_config(model_config(), method_name="ctc", vocab_size=V)
    with torch.no_grad():      # every tensor apart from a fresh init's
        for v in trained.state_dict().values():
            v.add_(torch.rand_like(v) + 0.1)
    trained.save_checkpoint(str(tmp_path))
    trained.save_config(str(tmp_path))
    for comp, carried in (("encoder", ("encoder.", "decoder.")), ("decoder", ("decoder.",))):
        cfg = model_config()
        cfg.setdefault(comp, {})["from_pt"] = str(tmp_path)
        model = tndt1.NDT1.from_config(cfg, method_name="endtoend", vocab_size=V)
        model.warm_start()
        for key, value in trained.state_dict().items():
            assert torch.equal(model.state_dict()[key], value) == key.startswith(carried), key
    # a head of another shape (another vocabulary) by decoder.from_pt does not load
    cfg = model_config()
    cfg["decoder"] = {"from_pt": str(tmp_path)}
    with pytest.raises(RuntimeError, match="size mismatch for decoder.weight"):
        tndt1.NDT1.from_config(cfg, method_name="ctc", vocab_size=V + 3).warm_start()
    batch = tt(make_batch())
    trained.eval()
    model.load_state_dict(trained.state_dict())
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(**batch).loss, trained(**batch).loss)
    # active factors and remat are ported (tests/test_torch_port_factors.py and
    # tests/test_torch_port_remat.py hold them to the JAX package)
    cfg = model_config()
    cfg["encoder"]["factors"] = {"active": True, "size": 16}
    cfg["encoder"]["remat"] = True
    model = tndt1.NDT1.from_config(cfg, method_name="ctc", vocab_size=V)
    assert model.encoder.remat and model.decoder.in_features == 16


def test_ndt1_ctc_bf16_autocast_close_to_jax_bf16():
    # bf16 compute rounds at other places in the two frameworks; this holds
    # the port's autocast path to the JAX bf16 path at a bf16 tolerance.
    cfg = model_config()
    jmodel, params, tmodel, batch = build_pair(cfg)
    jbf16 = jndt1.NDT1.from_config(cfg, compute_dtype="bfloat16", method_name="ctc",
                                   vocab_size=V)
    ref = jbf16.apply(
        {"params": params}, **{k: jnp.asarray(v) for k, v in batch.items()}, training=False
    )
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = tmodel(**tt(batch))
    assert out.preds.dtype == torch.float32 and out.loss.dtype == torch.float32
    np.testing.assert_allclose(out.preds.detach().numpy(), np.asarray(ref.preds), atol=2e-2)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), rtol=2e-3)


def test_training_noise_and_dropout_follow_the_generator():
    # torch cannot reproduce jax.random streams: the stochastic parts are
    # held to their own contract instead — a seeded generator reproduces a
    # training forward, another seed changes it, and the dropout keep rate
    # and scale are those of inverted dropout.
    cfg = model_config()
    cfg["encoder"]["smooth_and_noise"]["noise"] = True
    cfg["encoder"]["transformer"]["dropout"] = 0.3
    tmodel = tndt1.NDT1.from_config(cfg, method_name="ctc", vocab_size=V).train()
    batch = tt(make_batch())

    def loss(seed):
        return tmodel(**batch, generator=torch.Generator().manual_seed(seed)).loss.item()

    assert loss(0) == loss(0)
    assert loss(0) != loss(1)
    x = torch.ones(200_000)
    y = tndt1.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    assert abs((y > 0).float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(torch.unique(y), torch.tensor([0.0, 1.0 / 0.75]))
    assert tndt1.dropout(x, 0.25, False) is x
