"""PatchTST parity: the port (llm_bci_tpu_torch) against the JAX package.

The same weights and running statistics (carried by
``patchtst_state_dict_from_jax``) and the same numpy inputs go through both
in float32 with every dropout at 0. The patch masking's noise cannot come
from one stream in both, so each side's noise source is replaced by the same
fixed array (``jax.random.uniform`` in the JAX package, ``patch_noise`` in
the port); the rank rule on it is each package's own. Training mode (batch
statistics, masking) and eval mode (running statistics). Forward tolerance
atol 1e-5 / rtol 1e-4 (float32 sums in another order), running statistics
the same; parameter gradients rtol 1e-4 with an absolute floor of 1e-5 of
the largest gradient entry, as ``test_torch_port_ndt1.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import patchtst as jpt
from llm_bci_tpu_torch.interop import patchtst_state_dict_from_jax
from llm_bci_tpu_torch.models import patchtst as tpt

from test_torch_port_itransformer import random_variables, tt

B, T, C, V, S = 3, 22, 5, 7, 3
PL, PS = 4, 3
P = 1 + (T - PL) // PS                      # 7 patches
FWD = dict(atol=1e-5, rtol=1e-4)
NOISE = np.random.default_rng(11).uniform(size=(B, C, P)).astype(np.float32)


def model_config(norm="batchnorm", share=True, scaling=None, mlp_decoder=True, mask=True):
    return {
        "encoder": {
            "num_input_channels": C, "context_length": T, "patch_length": PL,
            "patch_stride": PS, "num_hidden_layers": 2, "d_model": 16,
            "num_attention_heads": 2, "ffn_dim": 32, "norm_type": norm,
            "attention_dropout": 0.0, "ff_dropout": 0.0, "positional_dropout": 0.0,
            "path_dropout": 0.0, "pre_norm": norm == "batchnorm", "scaling": scaling,
            "do_mask_input": mask, "random_mask_ratio": 0.4,
            "channel_consistent_masking": False, "mask_value": 0.5,
        },
        "decoder": {"share_projection": share, "mlp_decoder": mlp_decoder,
                    "pooling_type": "mean", "head_dropout": 0.0},
    }


def make_batch(method, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 4, T - 9], np.int64)
    mask = (np.arange(T)[None, :] >= (T - lengths)[:, None]).astype(np.int64)   # left padding
    batch = {
        "spikes": (rng.poisson(1.3, size=(B, T, C)) * mask[:, :, None]).astype(np.float32),
        "spikes_mask": mask,
    }
    if method == "ctc":
        batch["spikes_lengths"] = lengths
        batch["targets"] = rng.integers(1, V, size=(B, S)).astype(np.int64)
        batch["targets_lengths"] = np.array([S, 2, 3], np.int64)
    return batch


@pytest.fixture
def fixed_noise(monkeypatch):
    """Both packages' patch-masking noise is ``NOISE`` (its first channel
    for channel-consistent masking)."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(NOISE[:, :shape[1]]))

    def noise(shape, channel_consistent, generator, device):
        n = torch.from_numpy(NOISE[:, :1] if channel_consistent else NOISE)
        return n.expand(*shape)

    monkeypatch.setattr(tpt, "patch_noise", noise)


def build_pair(cfg, method):
    kw = dict(method_name=method, vocab_size=V, loss="poisson_nll", log_input=True)
    jmodel = jpt.PatchTSTForSpikingActivity.from_config(cfg, compute_dtype="float32", **kw)
    batch = make_batch(method)
    variables = random_variables(jmodel, 0, **{k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = tpt.PatchTSTForSpikingActivity.from_config(cfg, **kw)
    tmodel.load_state_dict(patchtst_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel, batch


def test_patchify_and_num_patches():
    x = np.random.default_rng(0).normal(size=(2, 20, 3)).astype(np.float32)
    for pl, ps in ((5, 4), (4, 4), (10, 10)):
        ref = np.asarray(jpt.patchify(jnp.asarray(x), pl, ps))
        out = tpt.patchify(torch.from_numpy(x), pl, ps).numpy()
        np.testing.assert_array_equal(out, ref)
        assert out.shape[2] == tpt.num_patches(20, pl, ps) == jpt.num_patches(20, pl, ps)


@pytest.mark.parametrize("channel_consistent", [False, True])
def test_random_patch_masking_same_noise_same_mask(channel_consistent):
    patches = np.random.default_rng(1).normal(size=(4, 6, 10, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    masked, mask = jpt.random_patch_masking(jnp.asarray(patches), key, 0.4, channel_consistent,
                                            -1.0)
    # the noise that JAX draws inside, from the same key and shape
    noise = np.array(jax.random.uniform(key, (4, 1 if channel_consistent else 6, 10)))
    tmasked, tmask = tpt.random_patch_masking(
        torch.from_numpy(patches), torch.from_numpy(noise).expand(4, 6, 10), 0.4, -1.0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(tmasked.numpy(), np.asarray(masked))
    assert (tmask.sum(-1) == 10 - int(10 * 0.6)).all()


def test_sincos_table_is_the_jax_packages():
    for P_, D in ((7, 16), (52, 256)):
        table = tpt.sincos_position_encoding(P_, D)
        np.testing.assert_array_equal(table, jpt.sincos_position_encoding(P_, D))
        # the ddof=1 normalisation: mean 0, unbiased std 0.1
        assert abs(table.mean()) < 1e-6 and abs(table.std(ddof=1) - 0.1) < 1e-6


# mlm and ctc; shared and per-channel heads; BatchNorm (pre-norm) and
# LayerNorm (post-norm); no, std and mean scaling
CASES = [("mlm", "batchnorm", True, "std"), ("mlm", "layernorm", False, None),
         ("ctc", "layernorm", True, "mean"), ("ctc", "batchnorm", False, None)]


@pytest.mark.parametrize("method, norm, share, scaling", CASES)
def test_patchtst_training_step_parity(fixed_noise, method, norm, share, scaling):
    # A training-mode forward and backward: the masking of the fixed noise,
    # batch statistics, the loss and its gradients, and, with BatchNorm, the
    # running statistics after the step against flax's batch_stats.
    cfg = model_config(norm, share, scaling)
    jmodel, variables, tmodel, batch = build_pair(cfg, method)
    mutable = ["batch_stats"] if norm == "batchnorm" else []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, new_vars = jmodel.apply({**variables, "params": params}, **jb, training=True,
                                     rngs={"mask": jax.random.PRNGKey(0)}, mutable=mutable)
        return out.loss, (out, new_vars)

    (_, (ref, new_vars)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    out = tmodel.train()(**tt(batch))
    np.testing.assert_allclose(out.preds.detach().numpy(), np.asarray(ref.preds), **FWD)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **FWD)
    assert int(out.n_examples) == int(ref.n_examples)
    if method == "mlm":
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
        assert 0 < out.mask.sum() < out.mask.numel()

    jgrads = patchtst_state_dict_from_jax({"params": jax.device_get(grads)})
    out.loss.backward()
    tgrads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(jgrads) == set(tgrads)
    floor = 1e-5 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(), rtol=1e-4, atol=floor,
                                   err_msg=name)

    if norm == "batchnorm":
        stats = patchtst_state_dict_from_jax(jax.device_get(dict(new_vars)))
        buffers = dict(tmodel.named_buffers())
        assert set(stats) == set(buffers) and len(stats) == 8
        for name, v in stats.items():
            before = patchtst_state_dict_from_jax(variables)[name]
            assert not torch.equal(buffers[name], before)         # moved by the step
            np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), **FWD, err_msg=name)


@pytest.mark.parametrize("norm", ["batchnorm", "layernorm"])
def test_patchtst_eval_parity_with_running_statistics(norm):
    # eval: BatchNorm normalises with the running statistics and leaves them;
    # mlm masks nothing (loss and count 0, as in the JAX package)
    cfg = model_config(norm, share=True, scaling="std")
    for method in ("ctc", "mlm"):
        jmodel, variables, tmodel, batch = build_pair(cfg, method)
        ref = jax.jit(lambda v, b: jmodel.apply(v, **b, training=False))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
        before = {n: b.clone() for n, b in tmodel.named_buffers()}
        with torch.no_grad():
            out = tmodel.eval()(**tt(batch))
        np.testing.assert_allclose(out.preds.numpy(), np.asarray(ref.preds), **FWD)
        np.testing.assert_allclose(out.loss.item(), float(ref.loss), **FWD)
        assert all(torch.equal(b, before[n]) for n, b in tmodel.named_buffers())
    assert out.loss.item() == 0.0 and int(out.n_examples) == 0


def test_flax_batchnorm_is_not_torch_batchnorm():
    # one step of torch's BatchNorm1d moves the running variance by 0.1 of the
    # unbiased variance; the port's moves it by 0.01 of the biased one
    x = torch.randn(40, 6) * 3 + 1
    bn = tpt.FlaxBatchNorm(6).train()
    bn(x)
    torch.testing.assert_close(bn.running_mean, 0.01 * x.mean(0))
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * x.var(0, unbiased=False))
    ref = torch.nn.BatchNorm1d(6).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var)


def test_from_pt_and_inactive_masking_raise(tmp_path):
    # from_pt builds and loads each component from its directory, BatchNorm's
    # running averages with the encoder
    trained = tpt.PatchTSTForSpikingActivity.from_config(model_config(), method_name="ctc")
    with torch.no_grad():      # every tensor apart from a fresh init's
        for v in trained.state_dict().values():
            v.add_(torch.rand_like(v) + 0.1)
    trained.save_checkpoint(str(tmp_path))
    trained.save_config(str(tmp_path))
    for comp in ("encoder", "decoder"):
        cfg = model_config()
        cfg[comp]["from_pt"] = str(tmp_path)
        model = tpt.PatchTSTForSpikingActivity.from_config(cfg, method_name="ctc")
        model.warm_start()
        for key, value in trained.state_dict().items():
            assert torch.equal(model.state_dict()[key], value) == key.startswith(comp), key
    with pytest.raises(ValueError, match="inactive masking"):
        tpt.PatchTSTForSpikingActivity.from_config(model_config(mask=False), method_name="mlm")
