"""The arithmetic and the plan of the CTC kernels (``csrc/ctc.cu``), on the CPU.

The kernels run only on the card. What can be held here:

* a torch emulation of their arithmetic — each slot's running value as a
  double-float pair (emulated in double), the differences from the max,
  their ``exp`` and the ``log1p`` of the sum in float32; the loss from
  alpha's terminal slots in double; the occupancies exp(alpha + beta - log p)
  in float32 with the same log p, summed by vocabulary entry — against
  the float64 plain version and the JAX package's XLA path, at the flagship
  shape with ``chip_smoke.ctc_case``'s edge cases (an empty target, an
  infeasible one, repeated labels, one label 30 times), with and without
  ``zero_infinity``, and in a confident case (logits x 15) whose likeliest
  complete paths lie up to hundreds of nats below a frame's best slot, where
  a linear-space scaled recursion fails;
* ``ctc_plan``: the kernel, slots a thread, threads, shared memory, where
  the lattices live and blocks an example, the same constants as the CUDA
  source, and its refusals; the CPU path builds and launches nothing.

Tolerances are the chip gates' (loss rtol 1e-4 / atol 1e-4, gradient atol
1e-4 against the float64 plain version), but for the JAX XLA path in the
confident case: it recurses in float32 and is itself 2.3e-4 off there."""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llm_bci_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from llm_bci_tpu_torch.ops import ctc_cuda
from llm_bci_tpu_torch.ops.ctc import NEG_INF, ctc_loss_plain, extended_labels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFEASIBLE = 2          # the row of chip_smoke.ctc_case with 64 labels in 40 frames
GATE_LOSS = dict(rtol=1e-4, atol=1e-4)
GATE_GRAD = dict(rtol=0.0, atol=1e-4)


def _lse3(a, b, c):
    """The kernel's lse3: the max of the running values, the two smallest
    differences in float32 through exp, log1p of their sum."""
    m = torch.maximum(torch.maximum(a, b), c).clamp_min(NEG_INF)
    d = torch.stack([(a - m).float(), (b - m).float(), (c - m).float()], -1)
    lo = torch.sort(d, -1).values[..., :2]
    return m + torch.log1p(torch.exp(lo[..., 0]) + torch.exp(lo[..., 1])).double()


def emulate_kernel(lp, targets, il, tl, blank=0, zero_infinity=True):
    """(loss (B,) float32, gradient w.r.t. ``lp`` for a unit grad_loss, the
    alpha and beta lattices) as ``ctc_alpha_beta_kernel`` computes them."""
    B, T, V = lp.shape
    S = targets.shape[1]
    Sb = tl.long().clamp(0, S)
    n = il.long().clamp(1, T)
    Lb = 2 * Sb + 1
    z, can_skip = extended_labels(targets.long(), blank)
    z = z.clamp(0, V - 1)
    L = z.shape[1]
    slot = torch.arange(L)[None]
    live = slot < Lb[:, None]
    skip_in = can_skip & live
    skip_out = torch.cat([can_skip[:, 2:], torch.zeros(B, 2, dtype=torch.bool)], 1) & (
        slot + 2 < Lb[:, None])
    e = torch.gather(lp.float(), 2, z[:, None, :].expand(B, T, L)).double()
    neg = torch.full((B, L), NEG_INF, dtype=torch.float64)

    alpha = torch.empty(B, T, L, dtype=torch.float64)
    a = torch.where(live & (slot <= 1), e[:, 0], neg)
    alpha[:, 0] = a
    for t in range(1, T):
        adv1 = torch.cat([neg[:, :1], a[:, :-1]], 1)
        adv2 = torch.where(skip_in, torch.cat([neg[:, :2], a[:, :-2]], 1), neg)
        new = torch.where(live, _lse3(a, adv1, adv2) + e[:, t], neg)
        a = torch.where((t < n)[:, None], new, a)
        alpha[:, t] = a

    terminal = live & ((slot == 2 * Sb[:, None]) | ((Sb[:, None] > 0) & (slot == 2 * Sb[:, None] - 1)))
    beta = torch.empty(B, T, L, dtype=torch.float64)
    bt = torch.where(terminal, torch.zeros_like(neg), neg)
    beta[:, T - 1] = bt
    for t in range(T - 2, -1, -1):
        term = torch.where(live, bt + e[:, t + 1], neg)
        adv1 = torch.cat([term[:, 1:], neg[:, :1]], 1)
        adv2 = torch.where(skip_out, torch.cat([term[:, 2:], neg[:, :2]], 1), neg)
        stepped = torch.where(live, _lse3(term, adv1, adv2), neg)
        # beta_{n-1} is the terminal gate; frames at and past n are not read
        bt = torch.where((t < n - 1)[:, None], stepped, torch.where(terminal, 0.0, neg))
        beta[:, t] = bt

    # the loss from alpha's terminal slots, in double
    rows = torch.arange(B)
    last = alpha[rows, n - 1]
    lb = last.gather(1, (2 * Sb)[:, None])[:, 0]
    ll = torch.where(Sb > 0, last.gather(1, (2 * Sb - 1).clamp(min=0)[:, None])[:, 0], NEG_INF)
    mm = torch.maximum(lb, ll).clamp_min(NEG_INF)
    loss = -(mm + torch.log(torch.exp(lb - mm) + torch.exp(ll - mm)))
    # the occupancies in float32, with the same log p
    logp = -loss
    feasible = torch.isfinite(logp) & (logp > NEG_INF / 2)
    occ = torch.exp(torch.clamp((alpha + beta - logp[:, None, None]).float(), max=0.0))
    keep = live[:, None, :] & (torch.arange(T)[None, :, None] < n[:, None, None])
    occ = torch.where(keep & feasible[:, None, None], occ, 0.0)
    occ_v = torch.zeros(B, T, V).scatter_add_(2, z[:, None, :].expand(B, T, L), occ)

    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF / 2, 0.0, loss)
    return loss.float(), -occ_v, alpha, beta


def scaled_linear_loss(lp, targets, il, tl, blank=0):
    """The linear-space recursion with alpha scaled to sum 1 each frame
    (Rabiner; Graves), in float32: the design the kernels do not take."""
    B, T, V = lp.shape
    S = targets.shape[1]
    Sb = tl.long().clamp(0, S)
    n = il.long().clamp(1, T)
    z, can_skip = extended_labels(targets.long(), blank)
    L = z.shape[1]
    slot = torch.arange(L)[None]
    live = slot < (2 * Sb + 1)[:, None]
    p = torch.exp(torch.gather(lp.float(), 2, z[:, None, :].expand(B, T, L)))
    zero = torch.zeros(B, L)
    a = torch.where(live & (slot <= 1), p[:, 0], zero)
    c = a.sum(1)
    a, logc = a / c[:, None], torch.log(c)
    for t in range(1, T):
        new = (a + torch.cat([zero[:, :1], a[:, :-1]], 1)
               + torch.where(can_skip & live, torch.cat([zero[:, :2], a[:, :-2]], 1), zero))
        new = torch.where(live, new * p[:, t], zero)
        c = new.sum(1)
        a = torch.where((t < n)[:, None], new / c[:, None], a)
        logc = logc + torch.where(t < n, torch.log(c), 0.0)
    fin = a.gather(1, (2 * Sb)[:, None])[:, 0] + torch.where(
        Sb > 0, a.gather(1, (2 * Sb - 1).clamp(min=0)[:, None])[:, 0], 0.0)
    return -(logc + torch.log(fin))


def flagship(scale: float):
    """chip_smoke's flagship CTC case (B=64, T=121, V=41, S=64) on the CPU,
    its logits times ``scale``, as log-probs."""
    logits, targets, il, tl = chip_smoke.ctc_case("cpu")
    return torch.log_softmax(logits * scale, -1), targets, il, tl


@functools.lru_cache(maxsize=None)
def emulated(scale: float, zero_infinity: bool = True):
    """``emulate_kernel`` on ``flagship(scale)``, computed once for the
    module: several tests read the same emulation, none changes it."""
    lp, targets, il, tl = flagship(scale)
    return emulate_kernel(lp, targets, il, tl, zero_infinity=zero_infinity)


def plain_f64(lp, targets, il, tl, zero_infinity):
    x = lp.double().requires_grad_(True)
    loss = ctc_loss_plain(x, targets, il, tl, zero_infinity=zero_infinity)
    (grad,) = torch.autograd.grad(loss.sum(), x)
    return loss.detach(), grad


@pytest.mark.parametrize("scale", [1.0, 15.0], ids=["ctc_case", "confident"])
@pytest.mark.parametrize("zero_infinity", [True, False])
def test_kernel_arithmetic_matches_float64_plain(scale, zero_infinity):
    lp, targets, il, tl = flagship(scale)
    loss, grad, _, _ = emulated(scale, zero_infinity)
    ref_loss, ref_grad = plain_f64(lp, targets, il, tl, zero_infinity)
    torch.testing.assert_close(loss, ref_loss.float(), **GATE_LOSS)
    feasible = torch.arange(lp.shape[0]) != INFEASIBLE
    torch.testing.assert_close(grad[feasible].double(), ref_grad[feasible], **GATE_GRAD)
    # infeasible: loss exactly 0 under zero_infinity, else the float32 sentinel;
    # a zero gradient either way (the plain version's autograd leaves -0.5 on
    # the terminal slots of its last frame without zero_infinity)
    assert loss[INFEASIBLE].item() == (0.0 if zero_infinity else np.float32(-NEG_INF))
    assert grad[INFEASIBLE].abs().max().item() == 0.0
    # the edge rows: an empty target is -sum_t log p(blank)
    n1 = int(il[1])
    np.testing.assert_allclose(loss[1].item(), -lp[1, :n1, 0].double().sum().item(), rtol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 15.0], ids=["ctc_case", "confident"])
def test_kernel_arithmetic_matches_jax_xla(scale):
    lp, targets, il, tl = flagship(scale)
    loss, grad, _, _ = emulated(scale)
    args = [jnp.asarray(a.numpy()) for a in (targets, il, tl)]
    x = jnp.asarray(lp.numpy())
    jloss = np.asarray(jax_ctc_loss(x, *args, impl="xla"))
    jgrad = np.asarray(jax.grad(lambda v: jax_ctc_loss(v, *args, impl="xla").sum())(x))
    grad_atol = 1e-4 if scale == 1.0 else 5e-4      # JAX's own float32 error: 2.3e-4
    np.testing.assert_allclose(loss.numpy(), jloss, **GATE_LOSS)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0.0, atol=grad_atol)


def test_confident_case_defeats_a_scaled_linear_recursion():
    """The confident case is there to catch a linear-space design: the slot
    of a frame's most likely complete path lies up to hundreds of nats below
    the frame's best alpha (more than float32's 103 in a good share of the
    frames), where the scaled float32 recursion underflows; log space holds."""
    def gaps(scale):
        lp, targets, il, tl = flagship(scale)
        _, _, alpha, beta = emulated(scale)
        rows = torch.arange(lp.shape[0])
        out = []
        for t in range(0, lp.shape[1], 10):
            on_path = (alpha[:, t] + beta[:, t]).argmax(1)
            gap = alpha[:, t].max(1).values - alpha[rows, t, on_path]
            out.append(gap[(t < il.long()) & (rows != INFEASIBLE)])
        return torch.cat(out)

    confident, base = gaps(15.0), gaps(1.0)
    assert confident.max() > 300 and (confident > 103).float().mean() > 0.1
    assert base.max() < 100
    lp, targets, il, tl = flagship(15.0)
    ref = ctc_loss_plain(lp.double(), targets, il, tl)
    feasible = torch.arange(lp.shape[0]) != INFEASIBLE
    linear = scaled_linear_loss(lp, targets, il, tl).double()
    bad = ~torch.isfinite(linear) | ((linear - ref).abs() > 1e-4 * ref.abs())
    assert bad[feasible].sum() > 10
    base_lp, *rest = flagship(1.0)
    base = scaled_linear_loss(base_lp, *rest).double()
    torch.testing.assert_close(base[feasible], ctc_loss_plain(base_lp.double(), *rest)[feasible],
                               rtol=1e-4, atol=1e-4)


def test_every_frame_gives_the_terminal_log_p_and_unit_occupancy():
    """alpha_t + beta_t of any frame gives alpha's terminal log p, and the
    occupancies of every frame below the input length sum to 1: each block
    of the fused kernel may form the occupancies of its own frames."""
    lp, targets, il, tl = flagship(1.0)
    loss, grad, alpha, beta = emulated(1.0)
    feasible = torch.arange(lp.shape[0]) != INFEASIBLE
    n = il.long()
    frame_sums = -grad.sum(-1)                       # (B, T)
    valid = torch.arange(lp.shape[1])[None] < n[:, None]
    np.testing.assert_allclose(frame_sums[feasible][valid[feasible]].numpy(), 1.0, atol=1e-5)
    assert frame_sums[~valid].abs().max().item() == 0.0
    for t in (0, 30, 60):   # any frame gives the same log p, to double rounding
        x = alpha[:, t] + beta[:, t]
        lp_t = torch.logsumexp(x, 1)
        np.testing.assert_allclose(-lp_t[feasible].numpy(), loss[feasible].double().numpy(),
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# ctc_plan
# --------------------------------------------------------------------------

def test_plan_flagship_keeps_the_lattices_in_shared_memory():
    plan = ctc_cuda.ctc_plan(121, 64, 41, want_grad=True)
    # a block of 512 threads, 96 in the recursion: log p, two exchange rows of
    # 2 x 96 + 4 pairs, a ring of 8 frames x 2 x 96 floats, its 121 x 129
    # lattice of pairs, the occupancy rows of its 61 frames (2 x 96 floats
    # each), the label chains
    smem = 16 + 2 * 196 * 8 + 8 * 192 * 4 + 121 * 129 * 8 + 61 * 192 * 4 + (41 + 192) * 4
    assert plan == ctc_cuda.CTCPlan("ctc_alpha_beta_kernel", 2, 512, -(-smem // 16) * 16,
                                    "shared", 2)
    assert plan.smem_bytes == 181952
    fwd = ctc_cuda.ctc_plan(121, 64, 41, want_grad=False)
    assert fwd == ctc_cuda.CTCPlan("ctc_alpha_kernel", 2, 96, 9296, "none", 1)


@pytest.mark.parametrize("T,where", [(167, "shared"), (168, "global"), (1000, "global")])
def test_plan_moves_the_lattices_to_global_scratch_when_they_do_not_fit(T, where):
    plan = ctc_cuda.ctc_plan(T, 64, 41, want_grad=True)
    assert plan.lattice == where and plan.kernel == "ctc_alpha_beta_kernel"
    assert plan.smem_bytes <= ctc_cuda.MAX_SMEM_BYTES and plan.cluster == 2
    if where == "global":
        # no lattice; occupancy rows for as many frames as 48 KB hold
        assert ctc_cuda.acc_rows(T, 96) == 64
        assert plan.smem_bytes == 9296 + 64 * 192 * 4 + (41 + 192) * 4 + 12
        assert ctc_cuda.scratch_shape(8, T, 64) == (8, 2, T, 129)
    # the forward without a gradient holds no lattice at any T
    assert ctc_cuda.ctc_plan(T, 64, 41, want_grad=False).lattice == "none"


@pytest.mark.parametrize("S,threads", [(0, 32), (31, 32), (32, 64), (64, 96), (95, 96),
                                       (96, 128), (511, 512)])
def test_plan_threads_hold_two_slots_each(S, threads):
    """A recursion's threads hold two slots each; the fused kernel's block
    has 512 threads, of which the first run the recursion."""
    assert ctc_cuda.recursion_threads(2 * S + 1) == threads and 2 * threads >= 2 * S + 1
    fwd = ctc_cuda.ctc_plan(121, S, 41, False)
    fused = ctc_cuda.ctc_plan(121, S, 41, True)
    assert (fwd.slots, fwd.threads) == (2, threads)
    assert (fused.slots, fused.threads) == (2, 512) and threads <= 512


@pytest.mark.parametrize("T,S,V,match", [(121, 512, 41, "slots"), (121, 64, 8193, "vocabulary"),
                                         (0, 64, 41, "empty"), (121, 64, 0, "empty")])
def test_plan_refuses_shapes_no_kernel_takes(T, S, V, match):
    for want_grad in (True, False):
        with pytest.raises(ValueError, match=match):
            ctc_cuda.ctc_plan(T, S, V, want_grad)


def test_plan_constants_are_the_kernel_source_constants():
    """``ctc_plan`` and ``ctc_launch`` compute the same plan: the slots a
    thread, the ring, the head, the limits and the lattice codes agree."""
    with open(os.path.join(REPO, "llm_bci_tpu_torch", "csrc", "ctc.cu")) as f:
        src = f.read()
    const = lambda name: int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))
    assert const("SLOTS") == ctc_cuda.SLOTS
    assert const("RING") == ctc_cuda.RING
    assert const("MAX_SLOTS") == ctc_cuda.MAX_SLOTS
    assert const("MAX_VOCAB") == ctc_cuda.MAX_VOCAB
    assert const("MAX_SMEM") == ctc_cuda.MAX_SMEM_BYTES
    assert const("HEAD") == ctc_cuda._HEAD
    assert const("FUSED_THREADS") == ctc_cuda.FUSED_THREADS
    assert const("ACC_BYTES") == ctc_cuda.ACC_BYTES
    assert "int recursion_threads(int L) { return 32 * ((L + 63) / 64); }" in src
    assert re.search(r"LATTICE_NONE = 0, LATTICE_SHARED = 1, LATTICE_GLOBAL = 2", src)
    assert ctc_cuda.LATTICES == ("none", "shared", "global")


def test_cpu_path_builds_and_launches_nothing():
    from llm_bci_tpu_torch.ops import _build
    from llm_bci_tpu_torch.ops.ctc import ctc_loss

    ctc_cuda.reset_counters()
    lp, targets, il, tl = flagship(1.0)
    x = lp.clone().requires_grad_(True)
    ctc_loss(x, targets, il, tl).sum().backward()
    with torch.no_grad():
        ctc_loss(lp, targets, il, tl)
    for T in (121, 1000):
        ctc_cuda.ctc_plan(T, 64, 41, want_grad=True)
    assert (ctc_cuda.FWD_LAUNCHES, ctc_cuda.FUSED_LAUNCHES) == (0, 0)
    assert ctc_cuda._LIB is None and "ctc" not in _build._LOADED
    with pytest.raises(ValueError, match="CUDA"):
        ctc_cuda.ctc_alpha_beta_cuda(lp, targets.int(), il.int(), tl.int(), 0, True)
