"""iTransformer parity: the port (llm_bci_tpu_torch) against the JAX package.

The same weights (carried by ``itransformer_state_dict_from_jax``) and the
same numpy inputs go through both in float32, in eval mode with dropout off;
the masker is off, or for ``mlm`` a ``force_active`` ``co-smooth`` masker on
fixed channels (deterministic: every masked bin is zeroed). Forward tolerance
atol 1e-5 / rtol 1e-4 (float32 sums in another order); parameter gradients
rtol 1e-4 with an absolute floor of 1e-5 of the largest gradient entry (for
entries that cancel to near zero), as ``test_torch_port_ndt1.py``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import itransformer as jitr
from llm_bci_tpu.models import layers as jlayers
from llm_bci_tpu.models.ndt1 import ACT2FN as JACT
from llm_bci_tpu.ops.ctc import ctc_loss as jctc_loss
from llm_bci_tpu_torch.interop import itransformer_state_dict_from_jax
from llm_bci_tpu_torch.models import itransformer as tit
from llm_bci_tpu_torch.models import layers as tlayers
from llm_bci_tpu_torch.models.ndt1 import ACT2FN as TACT
from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain

B, T, N, V, S = 3, 12, 6, 7, 4
REGIONS = ["CA1", "PO", "LP"]
FWD = dict(atol=1e-5, rtol=1e-4)
# embedder mode, CLS, MLP decoder
MODES = {"mlp": ("mlp", True, True), "transformer": ("transformer", False, False)}


def model_config(head, mode="mlp", dropout=0.0):
    emb_mode, use_cls, mlp_decoder = MODES[mode]
    masker = ({"active": True, "force_active": True, "mode": "co-smooth", "channels": [1, 4],
               "zero_ratio": 1.0} if head == "mlm" else {"active": False, "force_active": False})
    return {
        "masker": {"main": masker},
        "encoder": {
            "embedder": {"mode": emb_mode, "max_n_bins": T, "dropout": dropout,
                         "hidden_size": 8, "n_heads": 2, "n_layers": 1, "activation": "gelu"},
            "hidden_size": 16, "n_heads": 2, "n_layers": 2, "dropout": dropout,
            "activation": "relu", "max_n_channels": 8, "embed_region": True,
            "embed_depth": True, "regions": list(REGIONS),
        },
        "decoder": {"mlp_decoder": mlp_decoder, "use_cls": use_cls, "activation": "relu"},
    }


def head_kwargs(head):
    return {"mlm": dict(loss="poisson_nll", log_input=True),
            "ctc": dict(vocab_size=V, blank_id=0, zero_infinity=True),
            "dyn_behaviour": {},
            "stat_behaviour": dict(loss="xent", n_labels=3)}[head]


def make_batch(head, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 3, T - 5], np.int64)
    mask = (np.arange(T)[None, :] >= (T - lengths)[:, None]).astype(np.int64)   # left padding
    batch = {
        "spikes": (rng.poisson(1.2, size=(B, T, N)) * mask[:, :, None]).astype(np.float32),
        "spikes_mask": mask,
        "spikes_timestamp": np.where(mask > 0, np.arange(T)[None, :] - (T - lengths)[:, None],
                                     0).astype(np.int64),
        "spikes_spacestamp": np.broadcast_to(np.arange(N), (B, N)).astype(np.int64),
        "spikes_lengths": lengths,
        "neuron_regions_idx": rng.integers(0, len(REGIONS), size=(B, N)).astype(np.int32),
        "neuron_depths": rng.uniform(0, 1, size=(B, N)).astype(np.float32),
    }
    if head == "ctc":
        batch["targets"] = rng.integers(1, V, size=(B, S)).astype(np.int64)
        batch["targets_lengths"] = np.array([S, 2, 0], np.int64)
    elif head == "dyn_behaviour":
        batch["targets"] = rng.normal(size=(B, T)).astype(np.float32)
    elif head == "stat_behaviour":
        batch["targets"] = np.array([[2], [0], [1]], np.int64)
    return batch


def random_variables(jmodel, seed, *args, **kwargs):
    """Seeded numpy values in the shapes of ``jmodel.init``'s variables (only
    traced, not compiled): normal(0, 0.3) leaves, LayerNorm / BatchNorm scales
    and running variances near 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0),
                                          "mask": jax.random.PRNGKey(1)}, *args, **kwargs)

    def leaf(path, x):
        near_one = path[-1].key in ("scale", "var")
        draw = rng.normal(size=x.shape) * (0.1 if near_one else 0.3) + near_one
        return draw.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def build_pair(head, mode="mlp", seed=0):
    cfg = model_config(head, mode)
    kw = dict(method_name=head, **head_kwargs(head))
    jmodel = jitr.iTransformer.from_config(cfg, compute_dtype="float32", **kw)
    batch = make_batch(head, seed)
    params = random_variables(jmodel, seed, **{k: jnp.asarray(v) for k, v in batch.items()})
    params = params["params"]
    tmodel = tit.iTransformer.from_config(cfg, **kw)
    tmodel.load_state_dict(itransformer_state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval(), batch


def tt(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def jrun(jmodel, params, batch, **kw):
    return jmodel.apply({"params": params}, **{k: jnp.asarray(v) for k, v in batch.items()},
                        rngs={"mask": jax.random.PRNGKey(2)}, **kw)


def assert_grads_close(jgrads, tmodel):
    tgrads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(jgrads) == set(tgrads)
    floor = 1e-5 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(), rtol=1e-4, atol=floor,
                                   err_msg=name)


def stack_pair(seed=0, H=16, heads=2, layers=2, in_features=10, dropout=0.0, zero_bias=False):
    """The JAX ``TorchEncoderStack`` / ``MLPStack`` and the port's with the
    same weights (the stack's biases zero with ``zero_bias``)."""
    x = np.zeros((2, 5, H), np.float32)
    jstack = jlayers.TorchEncoderStack(H, heads, layers, JACT["relu"], dropout)
    sparams = random_variables(jstack, seed, jnp.asarray(x))["params"]
    if zero_bias:
        sparams = jax.tree_util.tree_map_with_path(
            lambda path, v: v * (path[-1].key != "bias"), sparams)
    jmlp = jlayers.MLPStack((H, H), JACT["relu"], dropout)
    mparams = random_variables(jmlp, seed + 1, jnp.zeros((2, 5, in_features)))["params"]
    tstack = tlayers.TorchEncoderStack(H, heads, layers, TACT["relu"], dropout)
    tstack.load_state_dict(itransformer_state_dict_from_jax(sparams), strict=True)
    tmlp = tlayers.MLPStack(in_features, (H, H), TACT["relu"], dropout)
    tmlp.load_state_dict(itransformer_state_dict_from_jax(mparams), strict=True)
    return (jstack, sparams, tstack.eval()), (jmlp, mparams, tmlp.eval())


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_stack_and_mlp_forward_parity(scale):
    # At scale 1e-3 (and no biases) the LayerNorms' variances are ~1e-6: the
    # parity needs flax's epsilon of 1e-6, and torch's default 1e-5 misses it.
    (jstack, sparams, tstack), (jmlp, mparams, tmlp) = stack_pair(zero_bias=scale < 1)
    rng = np.random.default_rng(3)
    x = (scale * rng.normal(size=(3, 7, 16))).astype(np.float32)
    ref = jstack.apply({"params": sparams}, jnp.asarray(x))
    out = tstack(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **FWD)
    assert all(m.eps == 1e-6 for m in tstack.modules() if isinstance(m, torch.nn.LayerNorm))
    if scale < 1:
        for m in tstack.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.eps = 1e-5
        assert not np.allclose(tstack(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               **FWD)
    xm = (scale * rng.normal(size=(3, 4, 10))).astype(np.float32)
    np.testing.assert_allclose(tmlp(torch.from_numpy(xm)).detach().numpy(),
                               np.asarray(jmlp.apply({"params": mparams}, jnp.asarray(xm))),
                               **FWD)


def _feature_mask(shape):
    """A fixed keep pattern over the last axis: every third feature dropped."""
    return (np.arange(shape[-1]) % 3 != 0).astype(np.float32)


def test_dropout_placement_matches_jax(monkeypatch):
    # Both frameworks' dropout replaced by the same deterministic keep pattern
    # over the last axis: the training-mode outputs agree only if dropout
    # falls on the same tensors (the attention context before out_proj, the
    # attention block's output, the FFN activation, the FFN output, each MLP
    # layer) and nowhere else.
    rate = 0.25

    def jdrop(self, x, deterministic=None, rng=None):
        if self.rate == 0.0 or (self.deterministic if deterministic is None else deterministic):
            return x
        return x * jnp.asarray(_feature_mask(x.shape)) / (1.0 - self.rate)

    def tdrop(x, p, training, generator=None):
        if not training or p == 0.0:
            return x
        return x * torch.from_numpy(_feature_mask(x.shape)) / (1.0 - p)

    monkeypatch.setattr(fnn.Dropout, "__call__", jdrop)
    monkeypatch.setattr(tlayers, "dropout", tdrop)
    (jstack, sparams, tstack), (jmlp, mparams, tmlp) = stack_pair(dropout=rate)
    x = np.random.default_rng(4).normal(size=(3, 7, 16)).astype(np.float32)
    ref = jstack.apply({"params": sparams}, jnp.asarray(x), training=True)
    out = tstack.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **FWD)
    assert not np.allclose(out, tstack.eval()(torch.from_numpy(x)).detach().numpy(), **FWD)
    xm = np.random.default_rng(5).normal(size=(3, 4, 10)).astype(np.float32)
    ref = jmlp.apply({"params": mparams}, jnp.asarray(xm), training=True)
    np.testing.assert_allclose(tmlp.train()(torch.from_numpy(xm)).detach().numpy(),
                               np.asarray(ref), **FWD)


def test_region_names_to_idx():
    rows = [{"neuron_regions": ["PO", "CA1", "LP", "PO"]}, {"spikes": np.zeros(3)},
            {"neuron_regions": np.array(["LP", "LP"]), "neuron_regions_idx": np.array([9, 9])}]
    jrows = [dict(r) for r in rows]
    tit.region_names_to_idx(rows, REGIONS)
    jitr.region_names_to_idx(jrows, REGIONS)
    np.testing.assert_array_equal(rows[0]["neuron_regions_idx"], [1, 0, 2, 1])
    assert rows[0]["neuron_regions_idx"].dtype == np.int32
    assert "neuron_regions_idx" not in rows[1]
    np.testing.assert_array_equal(rows[2]["neuron_regions_idx"], [9, 9])   # kept as given
    for r, j in zip(rows, jrows):
        assert r.keys() == j.keys()
        if "neuron_regions_idx" in r:
            np.testing.assert_array_equal(r["neuron_regions_idx"], j["neuron_regions_idx"])


def jax_value_and_grads(jmodel, params, batch):
    """The JAX model's eval-mode outputs and the gradient of its loss, in one
    jitted call."""
    def loss_fn(p):
        out = jrun(jmodel, p, batch, training=False)
        return out.loss, out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return ref, itransformer_state_dict_from_jax(jax.device_get(grads))


# every head, each embedder mode, with and without CLS before a behaviour head
@pytest.mark.parametrize("head, mode", [
    ("mlm", "mlp"), ("mlm", "transformer"), ("ctc", "transformer"), ("dyn_behaviour", "mlp"),
    ("stat_behaviour", "transformer")])
def test_itransformer_forward_and_grad_parity(head, mode):
    jmodel, params, tmodel, batch = build_pair(head, mode)
    ref, jgrads = jax_value_and_grads(jmodel, params, batch)
    out = tmodel(**tt(batch))
    np.testing.assert_allclose(out.preds.detach().numpy(), np.asarray(ref.preds), **FWD)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **FWD)
    assert int(out.n_examples) == int(ref.n_examples)
    if head == "mlm":
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
        assert out.mask.sum() > 0
    out.loss.backward()
    assert_grads_close(jgrads, tmodel)


def test_ctc_head_loss_through_plain_ctc_and_float32_under_autocast():
    # The head's log-probs (T' = max_n_bins frames), the unpadded spike
    # lengths as input lengths: the plain CTC against JAX's xla CTC.
    jmodel, params, tmodel, batch = build_pair("ctc")
    out = tmodel(**tt(batch))
    lp = out.preds.detach()
    assert tuple(lp.shape) == (B, T, V)
    ref = jctc_loss(jnp.asarray(lp.numpy()), jnp.asarray(batch["targets"]),
                    jnp.asarray(batch["spikes_lengths"]), jnp.asarray(batch["targets_lengths"]),
                    blank_id=0, zero_infinity=True, impl="xla")
    plain = ctc_loss_plain(lp, *tt({k: batch[k] for k in (
        "targets", "spikes_lengths", "targets_lengths")}).values())
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(out.loss.item(), float(np.asarray(ref).sum()), **FWD)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out16 = tmodel(**tt(batch))
    assert out16.preds.dtype == torch.float32 and out16.loss.dtype == torch.float32
    np.testing.assert_allclose(out16.preds.detach().numpy(), lp.numpy(), atol=5e-2)


def test_training_mode_follows_the_generator():
    # Dropout and the masker draw from the generator: one seed gives one
    # training forward, another seed another.
    cfg = model_config("mlm", dropout=0.3)
    tmodel = tit.iTransformer.from_config(cfg, method_name="mlm").train()
    batch = tt(make_batch("mlm"))

    def loss(seed):
        return tmodel(**batch, generator=torch.Generator().manual_seed(seed)).loss.item()

    assert loss(0) == loss(0)
    assert loss(0) != loss(1)


def test_from_pt_raises_naming_its_roadmap_item():
    for comp in ("encoder", "decoder"):
        cfg = model_config("ctc")
        cfg[comp]["from_pt"] = "some/dir"
        with pytest.raises(NotImplementedError, match="slice 3, left"):
            tit.iTransformer.from_config(cfg, method_name="ctc", vocab_size=V)
