"""Int8 weight-only quantization: the port (``llm_bci_tpu_torch.ops.quant``)
against the JAX package (``llm_bci_tpu.ops.quant``), on the CPU.

* ``quantize_int8`` / ``dequantize_int8`` / ``adapt_quantization`` give the
  JAX package's arrays exactly (both are host-side numpy);
* ``int8_matmul`` on a CPU tensor (the plain version) against the JAX
  ``int8_matmul(impl="xla")`` and against the Pallas kernel in interpret mode
  (``block_n=128, block_k=128``), rtol 1e-5 in float32;
* ``dx`` through the port's autograd Function against ``jax.grad``;
* the launch plans of the CUDA wrapper (pure Python): the cluster kernel's
  K-split covers K with no empty rank and fits the card at every decode M,
  and the wrapper refuses a plan that is not the kernel's before the device
  check;
* grouped-query attention against a repeat of the key / value heads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.ops import quant as jquant
from llm_bci_tpu_torch.ops import int8_matmul_cuda
from llm_bci_tpu_torch.ops import quant as tquant
from llm_bci_tpu_torch.ops.attention import dot_product_attention


@pytest.mark.parametrize("shape,axis", [((128, 256), 0), ((64, 48), 0), ((32, 16), 1)])
def test_quantize_int8_equals_jax_package(shape, axis):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.02, size=shape).astype(np.float32)
    w[:, 3] = 0.0                                # an all-zero channel
    q_ref, s_ref = jquant.quantize_int8(w, axis=axis)
    q, s = tquant.quantize_int8(w, axis=axis)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(s, s_ref)
    if axis == 0:
        np.testing.assert_array_equal(tquant.dequantize_int8(q, s),
                                      jquant.dequantize_int8(q_ref, s_ref))


def _tree(rng, quantized):
    """A two-level tree of Dense nodes, float or int8."""
    def dense(k, n):
        w = rng.normal(0, 0.05, size=(k, n)).astype(np.float32)
        if not quantized:
            return {"kernel": w, "lora_A": rng.normal(size=(k, 2)).astype(np.float32)}
        q, s = jquant.quantize_int8(w)
        return {"kernel": q, "kernel_scale": s,
                "lora_A": rng.normal(size=(k, 2)).astype(np.float32)}

    return {"layers_0": {"q_proj": dense(16, 32), "norm": {"weight": np.ones(16, np.float32)}},
            "lm_head": dense(16, 48)}


@pytest.mark.parametrize("saved_q,target_q", [(False, True), (True, False), (True, True),
                                              (False, False)])
def test_adapt_quantization_equals_jax_package(saved_q, target_q):
    saved = _tree(np.random.default_rng(1), saved_q)
    target = _tree(np.random.default_rng(2), target_q)
    ref = jquant.adapt_quantization(saved, target)
    got = tquant.adapt_quantization(saved, target)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_got, flat_ref):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _case(seed, M_shape, K, N):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, size=(K, N)).astype(np.float32)
    x = rng.normal(size=(*M_shape, K)).astype(np.float32)
    q, s = jquant.quantize_int8(w)
    return x, q, s


@pytest.mark.parametrize("M_shape,K,N", [((3, 5), 64, 192), ((8,), 256, 256), ((1,), 32, 48)])
def test_int8_matmul_matches_jax_xla_path(M_shape, K, N):
    x, q, s = _case(1, M_shape, K, N)
    ref = jquant.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), impl="xla")
    got = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert got.shape == (*M_shape, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    plain = tquant.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                     torch.from_numpy(s))
    assert torch.equal(got, plain)               # a CPU tensor takes the plain version


def test_int8_matmul_matches_pallas_kernel_in_interpret_mode():
    x, q, s = _case(2, (8,), 256, 256)
    jquant.set_interpret_mode(True)
    try:
        ref = jquant.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                 block_n=128, block_k=128)
    finally:
        jquant.set_interpret_mode(False)
    got = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_int8_matmul_out_dtype_and_bf16_input():
    x, q, s = _case(3, (4,), 64, 32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tquant.int8_matmul(xb, torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    got32 = tquant.int8_matmul(xb, torch.from_numpy(q), torch.from_numpy(s),
                               out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    ref = jquant.int8_matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
                             out_dtype=jnp.float32, impl="xla")
    # bf16 products summed in float32 by both; the sums' order differs
    np.testing.assert_allclose(got32.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-3)


def test_int8_matmul_dx_matches_jax_grad():
    x, q, s = _case(4, (6,), 64, 96)
    w = np.random.default_rng(5).normal(size=(6, 96)).astype(np.float32)

    def loss(xj):
        return (jquant.int8_matmul(xj, jnp.asarray(q), jnp.asarray(s), impl="xla")
                * jnp.asarray(w)).sum()

    ref = jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    (tquant.int8_matmul(xt, qt, st) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert not qt.requires_grad and not st.requires_grad


def test_int8_matmul_under_autocast_sees_bf16():
    x, q, s = _case(6, (4,), 32, 32)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("M", [1, 8, 16, 17, 40, 64])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                                 (32, 32), (48, 80)])
@pytest.mark.parametrize("bf16", [True, False])
def test_small_m_plan_covers_k_with_no_empty_block(M, K, N, bf16):
    """bf16: the ranks of a cluster split K into whole 64-deep k-tiles, cover
    it, and the last rank has work; float32 makes one pass over K."""
    ic = int8_matmul_cuda
    if not bf16:
        assert ic.regime(M, False) == "f32"
        return
    assert ic.regime(M, True) == "cluster"
    p = ic.cluster_plan(M, K, N)
    assert p.cluster in ic.CLUSTER_SIZES and p.grid == (p.cluster, -(-N // 128))
    assert p.k_per_rank % 64 == 0
    assert p.cluster * p.k_per_rank >= K                  # K is covered
    assert (p.cluster - 1) * p.k_per_rank < K             # and the last rank has work
    assert 8 * p.m_tiles >= M and (p.m_tiles == 1 or 8 * ic.CLUSTER_M_TILES[
        ic.CLUSTER_M_TILES.index(p.m_tiles) - 1] < M)     # the smallest x box that holds M


def test_large_m_plan_is_one_pass():
    ic = int8_matmul_cuda
    assert ic.regime(65, True) == "tiled" and ic.regime(1480, True) == "tiled"
    assert ic.tile_plan(65, 4096, 11008).grid == (1, 86)          # every block walks all of K
    assert ic.tile_plan(1480, 11008, 4096).grid == (6, 32)
    with pytest.raises(ValueError, match="1..64"):
        ic.cluster_plan(65, 4096, 11008)


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)])
def test_cluster_plan_fits_the_card_at_every_decode_m(K, N):
    """Every M of a decode step at each Llama-2-7B shape: a plan the kernel
    takes, within one block's shared memory, C <= 8, and three blocks an SM
    (each block also holds 1 KB of the SM's 228 KB for itself)."""
    ic = int8_matmul_cuda
    for M in range(1, 65):
        p = ic.cluster_plan(M, K, N)
        ic.check_cluster_plan(p, M, K, N)
        assert p.smem_bytes <= ic.MAX_SMEM_BYTES == 232448
        assert p.cluster <= 8 and p.threads == 160
        assert 3 * (p.smem_bytes + 1024) <= 228 * 1024
        assert p.stages * 64 * 128 >= 32 * 1024                  # 32 KB of codes in flight a block
        assert p.stages == 8 or 3 * (p.smem_bytes + p.smem_bytes // p.stages + 1024) > 228 * 1024


@pytest.mark.parametrize("K,N,cluster,rank_tiles,blocks", [
    (4096, 4096, 8, 8, 256), (4096, 11008, 4, 16, 344), (11008, 4096, 8, 22, 256),
    (4096, 32000, 1, 64, 250),
])
@pytest.mark.parametrize("M,m_tiles,stages,smem", [(8, 1, 8, 74880), (40, 5, 5, 67664)])
def test_cluster_plan_at_the_decode_shapes(K, N, cluster, rank_tiles, blocks, M, m_tiles, stages,
                                           smem):
    """Greedy (M=8) and 5 beams (M=40): about one or two waves of two blocks
    an SM, every rank streaming at least 8 k-tiles."""
    p = int8_matmul_cuda.cluster_plan(M, K, N)
    assert (p.cluster, p.k_per_rank // 64, p.grid[0] * p.grid[1]) == (cluster, rank_tiles, blocks)
    assert (p.m_tiles, p.stages, p.smem_bytes) == (m_tiles, stages, smem)


@pytest.mark.parametrize("field", int8_matmul_cuda.ClusterPlan._fields)
def test_cuda_wrapper_refuses_an_altered_cluster_plan(field, monkeypatch):
    """A plan that differs from the kernel's constants in any field is
    refused before the device check, and nothing is launched or loaded."""
    ic = int8_matmul_cuda
    real = ic.cluster_plan

    def altered(M, K, N):
        p = real(M, K, N)
        value = getattr(p, field)
        return p._replace(**{field: (value[0], value[1] + 1) if field == "grid" else value + 1})

    monkeypatch.setattr(ic, "cluster_plan", altered)
    x, q, s = _cuda_args(M=8, K=4096, N=4096)
    before = ic.LAUNCHES
    with pytest.raises(ValueError, match="not the cluster kernel's"):
        ic.int8_matmul_cuda(x, q, s, torch.bfloat16)
    assert ic._LIB is None and ic.LAUNCHES == before


@pytest.mark.parametrize("M", [65, 129, 185, 256, 257, 1480, 4096])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                                 (160, 144), (4112, 272)])
def test_tile_plan_covers_the_output_within_one_block_s_shared_memory(M, K, N):
    ic = int8_matmul_cuda
    t = ic.tile_plan(M, K, N)
    assert t.tile_m in ic.TILE_MS and t.threads == 288 and t.stages == ic.TILE_STAGES
    gm, gn = t.grid
    assert gm * t.tile_m >= M and (gm - 1) * t.tile_m < M      # M covered, no empty block
    assert gn * ic.TILE_N >= N and (gn - 1) * ic.TILE_N < N
    # the ring (x as bf16, q as int8), the converted weight tiles, the ring's
    # barriers, 1 KB to align
    ring = t.stages * (t.tile_m * ic.TILE_K * 2 + ic.TILE_K * ic.TILE_N)
    assert t.smem_bytes == ring + ic.TILE_B_TILES * ic.TILE_K * ic.TILE_N * 2 + 128 + 1024
    assert t.smem_bytes <= ic.MAX_SMEM_BYTES


@pytest.mark.parametrize("M,K,N,tile_m", [
    (1480, 4096, 4096, 256), (1480, 4096, 11008, 256), (1480, 11008, 4096, 256),
    (1480, 4096, 32000, 256), (185, 4096, 4096, 128), (185, 11008, 4096, 128),
    (185, 4096, 11008, 256), (185, 4096, 32000, 256), (65, 160, 144, 128),
])
def test_tile_plan_picks_the_rows_whose_waves_cost_least(M, K, N, tile_m):
    """A wave is one block on each of the 132 SMs, and a 128-row tile costs
    1.5 times a 256-row tile's time a row (it converts twice the codes a
    product). At M = 1480 the 256-row tiles win at every Llama-2-7B shape; at
    one trial's prompt (M = 185) the 4096-wide products fit one wave either
    way and the 128-row tiles, two blocks where there was one, are faster."""
    assert int8_matmul_cuda.tile_plan(M, K, N).tile_m == tile_m


def test_tile_plan_refuses_the_split_k_regime():
    with pytest.raises(ValueError, match="split-K"):
        int8_matmul_cuda.tile_plan(64, 4096, 4096)


def _cuda_args(M=70, K=32, N=32, dtype=torch.bfloat16):
    return (torch.zeros((M, K), dtype=dtype), torch.zeros((K, N), dtype=torch.int8),
            torch.ones((N,), dtype=torch.float32))


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"),
    ("x float16", TypeError, "bfloat16 or float32"),
    ("q float", TypeError, "int8"),
    ("out float16", TypeError, "out_dtype"),
    ("K not a multiple of 16", ValueError, "multiples of 16"),
    ("shapes do not fit", ValueError, "do not fit"),
    ("x not contiguous", ValueError, "contiguous"),
    ("q unaligned", ValueError, "aligned"),
])
def test_cuda_wrapper_refuses_what_the_kernels_do_not_take(case, error, match):
    x, q, s = _cuda_args()
    out_dtype = torch.bfloat16
    if case == "x float16":
        x = x.to(torch.float16)
    elif case == "q float":
        q = q.float()
    elif case == "out float16":
        out_dtype = torch.float16
    elif case == "K not a multiple of 16":
        x, q, s = _cuda_args(K=24)
    elif case == "shapes do not fit":
        s = torch.ones((48,), dtype=torch.float32)
    elif case == "x not contiguous":
        x = torch.zeros((32, 70), dtype=torch.bfloat16).t()
    elif case == "q unaligned":
        q = torch.zeros((32 * 32 + 1,), dtype=torch.int8)[1:].view(32, 32)
    before = int8_matmul_cuda.LAUNCHES
    with pytest.raises(error, match=match):
        int8_matmul_cuda.int8_matmul_cuda(x, q, s, out_dtype)
    assert int8_matmul_cuda._LIB is None and int8_matmul_cuda.LAUNCHES == before


@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 1), (4, 4)])
def test_grouped_query_attention_equals_repeated_heads(H, Hkv):
    rng = np.random.default_rng(7)
    B, T, S, D = 2, 5, 7, 8
    q = torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    mask = torch.from_numpy(rng.random((B, 1, T, S)) > 0.3)
    mask[..., 0] = True
    got = dot_product_attention(q, k, v, mask=mask)
    rep = H // Hkv
    ref = dot_product_attention(q, k.repeat_interleave(rep, dim=2),
                                v.repeat_interleave(rep, dim=2), mask=mask)
    assert got.shape == (B, T, H, D)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    import llm_bci_tpu.ops.attention as jattn

    jref = jattn.dot_product_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                       jnp.asarray(v.numpy()), mask=jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-4, atol=1e-5)
