"""The port's kernels as ``torch.library`` custom ops (``llm_bci::*``), on
the CPU, where each op runs its plain version:

* ``torch.library.opcheck`` on each op (schema, fake tensor, autograd
  registration, an AOT-dispatch trace);
* the CPU bodies against the JAX package: the CTC loss and its gradient
  (``ctc_alpha_beta``'s occupancies through the registered backward) against
  ``ctc_loss(impl="xla")`` and the Pallas kernel in interpret mode (rtol /
  atol 1e-5, ``tests/test_torch_port_ctc.py``'s); the flash forward and
  backward against the Pallas kernels in interpret mode (out atol 2e-5,
  gradients atol / rtol 1e-4, ``tests/test_torch_port_flash.py``'s); int8
  against ``_int8_matmul_xla`` (rtol 1e-5, atol 1e-6);
* the written-out backwards against autograd of the plain versions (float64
  CTC occupancies against float32 autograd: atol 1e-5; flash: atol 1e-5);
* each op's fake output: the real output's shapes and dtypes;
* a ``torch.export`` trace on the CPU that holds each op's node.

The CUDA bodies run only on the card: ``chip_smoke.py`` runs ``opcheck`` on
each op there (phase 17 F)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from llm_bci_tpu.ops import ctc_pallas
from llm_bci_tpu.ops import flash_attention as jfa
from llm_bci_tpu.ops import quant as jquant
from llm_bci_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from llm_bci_tpu_torch.ops import ctc as tctc
from llm_bci_tpu_torch.ops import flash_attention as tfa
from llm_bci_tpu_torch.ops import quant as tquant
from tests.test_torch_port_flash import jax_seed

OPS = ("ctc_alpha", "ctc_alpha_beta", "flash_fwd", "flash_bwd", "int8_matmul")


@pytest.fixture(autouse=True)
def _interpret_mode():
    ctc_pallas.set_interpret_mode(True)
    jfa.set_interpret_mode(True)
    yield
    ctc_pallas.set_interpret_mode(False)
    jfa.set_interpret_mode(False)


def ctc_case(seed=0, B=3, T=12, V=6, S=4):
    """log-probs, targets, input and target lengths (numpy): partial lengths,
    an empty target and one that 4 frames cannot hold (1, 1, 1 needs 5)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    targets = rng.integers(1, V, size=(B, S)).astype(np.int32)
    targets[2, :3] = 1
    il = np.array([T, T - 3, 4], np.int32)
    tl = np.array([S, 0, 3], np.int32)
    return lp, targets, il, tl


def flash_case(B=2, T=20, H=2, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    valid = np.ones((B, T), np.int32)
    valid[0, T - 5:] = 0
    valid[1, :] = 0                       # no visible key: rows exactly 0
    valid[1, 7:11] = 1
    return q, k, v, valid


def int8_case(M=5, K=64, N=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = (rng.random(N) * 0.02 + 1e-3).astype(np.float32)
    return x, q, s


def op_args(name):
    """Arguments of one call of each op at a small shape, as torch tensors."""
    t = torch.from_numpy
    if name.startswith("ctc"):
        lp, targets, il, tl = ctc_case()
        return (t(lp).requires_grad_(name == "ctc_alpha_beta"), t(targets), t(il), t(tl), 0,
                True)
    if name.startswith("flash"):
        q, k, v, valid = flash_case()
        seed = torch.tensor([1234], dtype=torch.int32)
        fwd_args = (t(q), t(k), t(v), t(valid), seed, 3, 5, 32 ** -0.5, 0.25)
        if name == "flash_fwd":
            return tuple(a.requires_grad_(True) if i < 3 else a for i, a in enumerate(fwd_args))
        out, lse = torch.ops.llm_bci.flash_fwd(*fwd_args)
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
        return (*fwd_args[:5], out, lse, dout, *fwd_args[5:])
    x, q, s = int8_case()
    return t(x).requires_grad_(True), t(q), t(s), torch.float32


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    torch.library.opcheck(getattr(torch.ops.llm_bci, name).default, op_args(name))


def test_opcheck_flash_without_padding_or_dropout_and_int8_bf16():
    q, k, v, _ = flash_case()
    args = tuple(torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    torch.library.opcheck(torch.ops.llm_bci.flash_fwd.default,
                          (*args, None, None, 20, 20, 32 ** -0.5, 0.0))
    x, qw, s = int8_case(M=3)
    torch.library.opcheck(torch.ops.llm_bci.int8_matmul.default,
                          (torch.from_numpy(x).bfloat16().requires_grad_(True),
                           torch.from_numpy(qw), torch.from_numpy(s), torch.bfloat16))


@pytest.mark.parametrize("name", OPS)
def test_fake_outputs_have_the_real_shapes_and_dtypes(name):
    op = getattr(torch.ops.llm_bci, name).default
    args = op_args(name)
    with torch.no_grad():
        real = op(*args)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake_args = tuple(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args)
            fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(r.shape), r.dtype) for r in real] == [(tuple(f.shape), f.dtype) for f in fake]


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_ops_match_jax_xla_and_pallas(seed):
    lp, targets, il, tl = ctc_case(seed)
    x = torch.tensor(lp, requires_grad=True)
    args = (torch.from_numpy(targets), torch.from_numpy(il), torch.from_numpy(tl), 0, True)
    loss, occ = torch.ops.llm_bci.ctc_alpha_beta(x, *args)
    loss.sum().backward()
    with torch.no_grad():
        alone = torch.ops.llm_bci.ctc_alpha(x, *args)
    assert torch.equal(alone, loss)         # one loss with and without the gradient
    np.testing.assert_allclose(x.grad.numpy(), -occ.numpy(), rtol=1e-6, atol=1e-7)
    for fn in (lambda *a: jax_ctc_loss(*a, impl="xla"), ctc_pallas.ctc_loss_pallas):
        j = tuple(jnp.asarray(a) for a in (targets, il, tl))
        vals = np.asarray(fn(jnp.asarray(lp), *j))
        grad = np.asarray(jax.grad(lambda v: fn(v, *j).sum())(jnp.asarray(lp)))
        np.testing.assert_allclose(loss.detach().numpy(), vals, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), grad, rtol=1e-5, atol=1e-5)
    assert loss[2].item() == 0.0 and (x.grad[2] == 0).all()      # infeasible, zero_infinity
    assert (x.grad[1, il[1]:] == 0).all()                        # past the input length


def test_ctc_occupancy_equals_autograd_of_the_plain_loss():
    lp, targets, il, tl = ctc_case(2)
    x = torch.tensor(lp, requires_grad=True)
    t = lambda a: torch.from_numpy(a)
    tctc.ctc_loss_plain(x, t(targets), t(il), t(tl)).sum().backward()
    occ = tctc.ctc_occupancy_plain(t(lp), t(targets), t(il), t(tl))
    np.testing.assert_allclose(-occ.numpy(), x.grad.numpy(), atol=1e-5)


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_flash_ops_match_jax_kernels(drop):
    q, k, v, valid = flash_case(D=16)
    rng = jax.random.PRNGKey(13)
    seed = jax_seed(rng)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    w = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    out = tfa.banded_flash_attention(tq, tk, tv, torch.from_numpy(valid), 4, 6,
                                     dropout_rate=drop, seed=seed)
    (out * torch.from_numpy(w)).sum().backward()

    def jloss(q_, k_, v_):
        o = jfa.banded_flash_attention(q_, k_, v_, jnp.asarray(valid), context_forward=4,
                                       context_backward=6, block_q=8, block_k=8,
                                       dropout_rate=drop, dropout_rng=rng if drop else None)
        return (o * jnp.asarray(w)).sum(), o

    (_, ref), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_flash_backward_equals_autograd_of_the_plain_version(drop):
    q, k, v, valid = flash_case()
    seed = torch.tensor([99], dtype=torch.int32)
    x = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    out = tfa.banded_flash_attention_plain(*x, torch.from_numpy(valid), 3, 5, drop, seed)
    out.backward(dout)
    got = tfa.flash_backward_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(valid), seed, dout, 3, 5, 32 ** -0.5, drop)
    for g, t in zip(got, x):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_op_matches_jax_xla(dtype):
    x, q, s = int8_case(M=7)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    got = tquant.int8_matmul(tx, torch.from_numpy(q), torch.from_numpy(s))
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jquant._int8_matmul_xla(jnp.asarray(tx.detach().float().numpy()).astype(jdtype),
                                  jnp.asarray(q), jnp.asarray(s), jdtype)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-3)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(ref, np.float32), **tol)
    got.float().sum().backward()
    want = (torch.from_numpy(s).float()[None, :].expand(7, -1).to(dtype)
            @ torch.from_numpy(q).to(dtype).T)
    assert torch.equal(tx.grad, want)


class _AllOps(torch.nn.Module):
    def forward(self, lp, targets, il, tl, q, k, v, valid, x, w, scale):
        loss, _ = torch.ops.llm_bci.ctc_alpha_beta(lp, targets, il, tl, 0, True)
        loss2 = torch.ops.llm_bci.ctc_alpha(lp, targets, il, tl, 0, True)
        out, lse = torch.ops.llm_bci.flash_fwd(q, k, v, valid, None, 3, 5, 32 ** -0.5, 0.0)
        dq, dk, dv = torch.ops.llm_bci.flash_bwd(q, k, v, valid, None, out, lse, out, 3, 5,
                                                 32 ** -0.5, 0.0)
        y = torch.ops.llm_bci.int8_matmul(x, w, scale, torch.float32)
        return loss + loss2, out, dq + dk + dv, y


def test_export_on_the_cpu_holds_each_op_node():
    lp, targets, il, tl = ctc_case()
    q, k, v, valid = flash_case()
    x, w, s = int8_case()
    args = tuple(torch.from_numpy(a) for a in (lp, targets, il, tl, q, k, v, valid, x, w, s))
    ep = torch.export.export(_AllOps(), args, strict=False)
    targets_ = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert {f"llm_bci.{name}.default" for name in OPS} <= targets_
    got = ep.module()(*args)
    want = _AllOps()(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
