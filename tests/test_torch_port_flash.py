"""Banded flash attention of the port against the JAX package, on the CPU.

The JAX side is ``llm_bci_tpu.ops.flash_attention.banded_flash_attention``
with its Pallas kernels in interpret mode, as ``tests/test_flash_attention.py``
runs it. The port side is the plain version of its CUDA kernels, reached
through the public function on CPU tensors. The same numpy inputs go to
both, in float32.

Tolerances: forward atol 2e-5 (that file's own, float32 sums in another
order); gradients atol/rtol 1e-4 with a loss weighted by O(1) normal draws
(tighter than that file's 1e-3, which covers its weights up to ~1500); the
keep mask bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.ops import flash_attention as jfa
from llm_bci_tpu_torch.ops import flash_attention as tfa
from tests.test_flash_attention import _np_keep_mask


@pytest.fixture(autouse=True)
def _interpret_mode():
    jfa.set_interpret_mode(True)
    yield
    jfa.set_interpret_mode(False)


def make_inputs(B=2, T=24, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))


def padding(kind, B, T):
    valid = np.ones((B, T), np.int32)
    if kind == "right":
        valid[0, T - 6:] = 0
        valid[1, T - 1:] = 0
    elif kind == "left":
        valid[0, :6] = 0
        valid[1, :11] = 0
    elif kind == "dead":          # one example with no valid key at all
        valid[0, :] = 0
        valid[1, :3] = 0
    return valid


def jax_out(q, k, v, valid, fwd, bwd, **kw):
    return np.asarray(jfa.banded_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if valid is None else jnp.asarray(valid),
        context_forward=fwd, context_backward=bwd, block_q=8, block_k=8, **kw))


def port_out(q, k, v, valid, fwd, bwd, **kw):
    t = torch.from_numpy
    return tfa.banded_flash_attention(
        t(q), t(k), t(v), None if valid is None else t(valid),
        context_forward=fwd, context_backward=bwd, **kw).numpy()


BANDS = [(None, None), (0, None), (3, 5), (0, 0)]


@pytest.mark.parametrize("fwd,bwd", BANDS)
@pytest.mark.parametrize("pad", ["none", "right", "left"])
def test_forward_matches_jax_kernel(fwd, bwd, pad):
    q, k, v = make_inputs()
    valid = padding(pad, *q.shape[:2])
    np.testing.assert_allclose(port_out(q, k, v, valid, fwd, bwd),
                               jax_out(q, k, v, valid, fwd, bwd), atol=2e-5)


def test_key_valid_none_is_all_valid():
    q, k, v = make_inputs(T=16)
    np.testing.assert_allclose(port_out(q, k, v, None, 2, 2),
                               jax_out(q, k, v, None, 2, 2), atol=2e-5)


def test_dead_rows_are_exactly_zero():
    q, k, v = make_inputs(T=16)
    valid = padding("dead", 2, 16)
    out = port_out(q, k, v, valid, None, None)
    assert (out[0] == 0.0).all()
    np.testing.assert_allclose(out, jax_out(q, k, v, valid, None, None), atol=2e-5)
    # left padding under a causal band narrower than the padding: the first
    # valid queries see keys, the padded ones see none
    valid = padding("left", 2, 16)
    out = port_out(q, k, v, valid, 0, 2)
    assert (out[1, :11] == 0.0).all() and np.abs(out[1, 11:]).min() > 0.0
    np.testing.assert_allclose(out, jax_out(q, k, v, valid, 0, 2), atol=2e-5)


def test_odd_length_and_head_dim():
    q, k, v = make_inputs(T=13, D=5)
    valid = np.ones((2, 13), np.int32)
    np.testing.assert_allclose(port_out(q, k, v, valid, None, None),
                               jax_out(q, k, v, valid, None, None), atol=2e-5)


def grads(q, k, v, valid, fwd, bwd, w, jax_kw, port_kw):
    def jloss(q, k, v):
        out = jfa.banded_flash_attention(
            q, k, v, jnp.asarray(valid), context_forward=fwd, context_backward=bwd,
            block_q=8, block_k=8, **jax_kw)
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.banded_flash_attention(tq, tk, tv, torch.from_numpy(valid), context_forward=fwd,
                                     context_backward=bwd, **port_kw)
    (out * torch.from_numpy(w)).sum().backward()
    return [np.asarray(g) for g in jg], [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("pad", ["right", "left", "dead"])
@pytest.mark.parametrize("fwd,bwd", [(4, 6), (None, None), (0, None)])
def test_gradients_match_jax_kernels(fwd, bwd, pad):
    q, k, v = make_inputs(T=16, D=8)
    valid = padding(pad, 2, 16)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    jg, tg = grads(q, k, v, valid, fwd, bwd, w, {}, {})
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")
    if pad == "dead":
        assert all((g[0] == 0.0).all() for g in tg)


# ---------------------------------------------------------------- dropout

@pytest.mark.parametrize("drop_p", [0.4, 0.05, 0.999])
@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
def test_keep_mask_equals_jax_bit_for_bit(seed, drop_p):
    BH, T = 6, 37
    pos = np.arange(T)
    ref = np.asarray(jfa._keep_mask(
        jnp.uint32(seed), jnp.arange(BH, dtype=jnp.int32)[:, None, None],
        jnp.asarray(pos, jnp.int32)[None, :, None], jnp.asarray(pos, jnp.int32)[None, None, :],
        drop_p))
    tpos = torch.arange(T)
    ours = tfa.keep_mask(seed, torch.arange(BH)[:, None, None], tpos[None, :, None],
                         tpos[None, None, :], drop_p).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, _np_keep_mask(seed, BH, T, drop_p))
    # a seed tensor, as the CUDA wrapper keeps it, gives the same mask
    again = tfa.keep_mask(torch.tensor([seed], dtype=torch.int32), torch.arange(BH)[:, None, None],
                          tpos[None, :, None], tpos[None, None, :], drop_p).numpy()
    np.testing.assert_array_equal(again, ours)


def jax_seed(rng):
    """The seed the JAX wrapper draws from its key."""
    return int(jax.random.randint(rng, (1,), 0, np.iinfo(np.int32).max, jnp.int32)[0])


@pytest.mark.parametrize("fwd,bwd", [(None, None), (3, 5)])
def test_dropout_forward_matches_jax_kernel(fwd, bwd):
    q, k, v = make_inputs(T=16)
    valid = padding("left", 2, 16)
    rng = jax.random.PRNGKey(11)
    ref = jax_out(q, k, v, valid, fwd, bwd, dropout_rate=0.4, dropout_rng=rng)
    out = port_out(q, k, v, valid, fwd, bwd, dropout_rate=0.4, seed=jax_seed(rng))
    np.testing.assert_allclose(out, ref, atol=3e-5)
    assert np.abs(out - port_out(q, k, v, valid, fwd, bwd)).max() > 1e-3


def test_dropout_gradients_match_jax_kernels():
    q, k, v = make_inputs(T=16, seed=3)
    valid = padding("right", 2, 16)
    rng = jax.random.PRNGKey(5)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    jg, tg = grads(q, k, v, valid, 3, 5, w, dict(dropout_rate=0.3, dropout_rng=rng),
                   dict(dropout_rate=0.3, seed=jax_seed(rng)))
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


def test_dropout_from_a_generator():
    q, k, v = (torch.from_numpy(x) for x in make_inputs(T=16))
    run = lambda s: tfa.banded_flash_attention(
        q, k, v, dropout_rate=0.4, generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    # a rate with neither generator nor seed drops nothing, as in the JAX package
    assert torch.equal(tfa.banded_flash_attention(q, k, v, dropout_rate=0.4),
                       tfa.banded_flash_attention(q, k, v))
    keep = tfa.keep_mask(7, torch.arange(64)[:, None, None], torch.arange(128)[None, :, None],
                         torch.arange(128)[None, None, :], 0.4)
    assert abs(keep.float().mean().item() - 0.6) < 0.01


def test_flash_attention_generic_entry():
    q, k, v = make_inputs(T=16)
    for causal in (False, True):
        ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             is_causal=causal))
        out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), is_causal=causal)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            mask=torch.ones(16, 16, dtype=torch.bool))


def test_shape_checks_and_cuda_wrapper_refuses_cpu_tensors():
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    q, k, v = (torch.from_numpy(x) for x in make_inputs(T=8, D=32))
    with pytest.raises(ValueError, match="no GQA"):
        tfa.banded_flash_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="CUDA"):
        fc.flash_forward_cuda(q, k, v, None, None, 8, 8, 32 ** -0.5, 0.0)
    assert fc._LIB is None and (fc.FWD_LAUNCHES, fc.BWD_DQ_LAUNCHES, fc.BWD_DKV_LAUNCHES) == (0, 0, 0)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("bf16", [True, False])
def test_forward_plan_per_head_size(D, bf16):
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    plan = fc.forward_plan(D, bf16)
    if bf16 and D >= 64:
        # Q, two K and two V tiles of 64 rows, the rings' barriers, 1 KB to align
        assert plan.kernel == "wgmma" and plan.stages == 2
        assert plan.smem_bytes == 5 * 64 * D * 2 + 64 + 1024
        assert plan.blocks_per_sm >= 2          # a second block overlaps softmax and products
    else:
        assert plan.kernel == "mma" and plan.stages == 1
    assert plan.smem_bytes + 1024 <= fc.MAX_SMEM_BYTES
    assert plan.blocks_per_sm == fc.MAX_SMEM_BYTES // (plan.smem_bytes + 1024) >= 1


def test_forward_plan_refuses_other_head_sizes():
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    with pytest.raises(ValueError, match="head size"):
        fc.forward_plan(48, True)


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"),
    ("float16", TypeError, "dtype"),
    ("three dimensions", ValueError, r"\(B, T, H, D\)"),
    ("head size 48", ValueError, "head size"),
    ("k of another dtype", TypeError, "k has dtype"),
    ("v not contiguous", ValueError, "contiguous"),
    ("key_valid int64", TypeError, "key_valid"),
    ("band wider than T", ValueError, "band widths"),
])
def test_cuda_function_refuses_what_the_kernels_do_not_take(case, error, match):
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    B, T, H, D = 2, 8, 2, 64
    q, k, v = (torch.zeros((B, T, H, D), dtype=torch.bfloat16) for _ in range(3))
    valid, fwd = None, T
    if case == "float16":
        q = q.to(torch.float16)
    elif case == "three dimensions":
        q = q[0]
    elif case == "head size 48":
        q, k, v = (x[..., :48].contiguous() for x in (q, k, v))
    elif case == "k of another dtype":
        k = k.float()
    elif case == "v not contiguous":
        v = torch.zeros((B, H, T, D), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "key_valid int64":
        valid = torch.ones((B, T), dtype=torch.int64)
    elif case == "band wider than T":
        fwd = T + 1
    with pytest.raises(error, match=match):
        fc.flash_forward_cuda(q, k, v, valid, None, fwd, T, 0.125, 0.0)
    assert fc._LIB is None and fc.FWD_LAUNCHES == 0


# ---------------------------------------------------------------- backward

@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("bf16", [True, False])
def test_backward_plan_per_head_size(D, bf16):
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    plan = fc.backward_plan(D, bf16)
    tile = 64 * D * 2
    if bf16 and D >= 64:
        # dQ: Q, dO, three K tiles and one or two V tiles; two blocks an SM
        assert plan.dq.kernel == "wgmma" and plan.dq.tile_rows == 64 and plan.dq.threads == 128
        assert plan.dq.smem_bytes == (5 + (1 if D == 128 else 2)) * tile + 128 + 1024
        assert plan.dq.blocks_per_sm == 2
        assert 2 * (plan.dq.smem_bytes + 1024) <= 228 * 1024
        # dK/dV: K and V of 128 keys, four (Q, dO) pairs, lse and delta; dk
        # and dv fill the registers of one block an SM at D = 128
        assert plan.dkv.kernel == "wgmma" and plan.dkv.tile_rows == 128
        assert plan.dkv.threads == 256 and plan.dkv.stages == 4
        assert plan.dkv.smem_bytes == 12 * tile + 2048 + 128 + 1024
        assert plan.dkv.blocks_per_sm == (1 if D == 128 else 2)
        assert plan.dkv.blocks_per_sm * (plan.dkv.smem_bytes + 1024) <= 228 * 1024
    else:
        for one in plan:
            assert one.kernel == "mma" and one.tile_rows == 64 and one.threads == 128
            assert one.stages == 1
            assert one.blocks_per_sm == fc.MAX_SMEM_BYTES // (one.smem_bytes + 1024)
    for one in plan:
        assert one.smem_bytes <= fc.MAX_SMEM_BYTES == 232448 and one.blocks_per_sm >= 1


def test_backward_plan_refuses_other_head_sizes():
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    for D in (48, 16, 256):
        with pytest.raises(ValueError, match="head size"):
            fc.backward_plan(D, True)


@pytest.mark.parametrize("shape", [(2, 24, 2, 16), (1, 13, 3, 5), (3, 70, 2, 64)])
def test_flash_delta_plain_matches_jax_expression(shape):
    """``delta`` as ``_flash_bwd`` writes it on (B*H, T, D) tensors, against
    the port's plain version on (B, T, H, D); float32, rtol 1e-6 (atol the
    same share of the largest |dO * O| row sum: the sums run in another
    order)."""
    B, T, H, D = shape
    rng = np.random.default_rng(4)
    out, dout = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    to_bh = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, T, D))
    ref = jnp.sum(to_bh(out).astype(jnp.float32) * to_bh(dout).astype(jnp.float32), axis=-1)
    got = tfa.flash_delta_plain(torch.from_numpy(out), torch.from_numpy(dout))
    assert got.shape == (B, H, T) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy().reshape(B * H, T), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * np.abs(out * dout).sum(-1).max())
    # bf16 inputs are multiplied and summed in float32
    got16 = tfa.flash_delta_plain(torch.from_numpy(out).bfloat16(),
                                  torch.from_numpy(dout).bfloat16())
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), got.numpy(), atol=0.05 * np.sqrt(D), rtol=0.05)


def test_flash_delta_kernel_wrapper_refuses_cpu_tensors():
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    x = torch.zeros((2, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fc.flash_delta(x, x)
    assert fc._LIB is None and fc.BWD_DELTA_LAUNCHES == 0


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_gradients_match_jax_kernels_over_three_tiles(drop):
    """T spans three 64-row tiles of the JAX kernels and the band (70 / 40)
    cuts them: tiles wholly inside, cut and outside. float32, atol 2e-5
    (sums in another order), weights of O(1)."""
    B, T, H, D = 1, 192, 2, 8
    q, k, v = make_inputs(B=B, T=T, H=H, D=D, seed=7)
    valid = np.ones((B, T), np.int32)
    valid[0, :9] = 0
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    jax_kw = dict(dropout_rate=drop, dropout_rng=rng) if drop else {}
    port_kw = dict(dropout_rate=drop, seed=jax_seed(rng)) if drop else {}

    def jloss(q, k, v):
        out = jfa.banded_flash_attention(
            q, k, v, jnp.asarray(valid), context_forward=70, context_backward=40,
            block_q=64, block_k=64, **jax_kw)
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.banded_flash_attention(tq, tk, tv, torch.from_numpy(valid), context_forward=70,
                                     context_backward=40, **port_kw)
    (out * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=2e-5, err_msg=f"d{name}")
