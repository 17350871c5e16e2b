"""CTC loss through the hand-written CUDA kernels of ``csrc/ctc.cu``.

Replaces the Pallas TPU kernels of ``llm_bci_tpu/ops/ctc_pallas.py``
(``_fwd_kernel`` via ``_run_fwd``, ``_bwd_kernel`` via ``_run_bwd``, and
the custom VJP ``ctc_loss_pallas``). A forward that needs no gradient
launches ``ctc_alpha_kernel`` (one block an example runs the alpha recursion
and writes the loss). A forward that needs one launches
``ctc_alpha_beta_kernel``: a cluster of two blocks an example runs alpha and
beta at the same time, each into its own lattice, and then writes the loss and
the occupancy sums ``occ[b, t, v] = sum_{s: z_s = v} exp(alpha + beta - log p)``.
The backward is then one multiply, ``grad = -grad_loss[b] * occ``: the JAX
package's convention (not torch's native CTC gradient, whose ``log_probs``
gradient is only right after log-softmax's backward), zero for an infeasible
example and for frames at and past its input length.

On an H100 the kernels are bound by the chain of n dependent frames, not by
bytes; see ``csrc/ctc.cu`` for the design. :func:`ctc_plan` gives a call's
launch geometry (kernel, slots a thread, threads, shared memory, whether the
lattices live in shared memory or in a global scratch the wrapper allocates,
blocks an example); the launcher refuses a plan that differs from its own in
any field.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernels do not take; there is no fallback to the plain
version. ``FWD_LAUNCHES`` counts ``ctc_alpha_kernel`` and ``FUSED_LAUNCHES``
``ctc_alpha_beta_kernel``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from llm_bci_tpu_torch.ops import _build

FWD_LAUNCHES = 0
FUSED_LAUNCHES = 0

FWD_KERNEL = "ctc_alpha_kernel"
FUSED_KERNEL = "ctc_alpha_beta_kernel"

MAX_SLOTS = 1024          # L = 2S+1 slots: 16 warps x 32 threads x 2 slots
MAX_VOCAB = 8192
SLOTS = 2                 # slots a thread: a blank and a label
RING = 8                  # frames of emissions a block keeps in shared memory
MAX_SMEM_BYTES = 232448   # shared memory a block can have on an H100
LATTICES = ("none", "shared", "global")
_HEAD = 16                # bytes: the example's log p
ACC_BYTES = 49152         # occupancy rows a block of the fused kernel keeps, at most
FUSED_THREADS = 512       # a block of the fused kernel: its recursion, then all in the pass
_PAIR = 8                 # bytes of a lattice value: a (hi, lo) pair of floats

_LIB: Optional[ctypes.CDLL] = None


class CTCPlan(NamedTuple):
    """Launch geometry of one call (``csrc/ctc.cu``'s ``ctc_launch`` checks
    every field against its own)."""
    kernel: str        # FWD_KERNEL (no gradient) or FUSED_KERNEL
    slots: int         # lattice slots a thread (SLOTS: a blank and a label)
    threads: int       # a block: 32 x ceil(L / 64) run the recursion; FUSED_THREADS the fused kernel
    smem_bytes: int    # dynamic shared memory of a block
    lattice: str       # where the fused kernel keeps its lattices, one of LATTICES
    cluster: int       # blocks an example: 1, or 2 (alpha and beta) for FUSED_KERNEL


def recursion_threads(L: int) -> int:
    """Threads that run a recursion: two slots each, whole warps."""
    return 32 * -(-L // (32 * SLOTS))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _alpha_smem(threads: int) -> int:
    """[log p] [two exchange rows of 2 x threads + 4 pairs] [a ring of RING
    frames x 2 x threads floats]."""
    return _HEAD + 2 * (2 * threads + 4) * _PAIR + RING * 2 * threads * 4


def acc_rows(T: int, G: int) -> int:
    """Frames of occupancy rows (2G floats each; G threads in the recursion)
    a block of the fused kernel keeps in shared memory: its half of the
    frames, or as many as ACC_BYTES hold."""
    return min((T + 1) // 2, max(1, ACC_BYTES // (8 * G)))


def _fused_smem(T: int, L: int, V: int, G: int, lattice_shared: bool) -> int:
    """A block of the fused kernel: the alpha kernel's, [its T x L lattice of
    pairs, if shared] [the occupancy rows] [the label chains: V + 2G ints]."""
    lattice = T * L * _PAIR if lattice_shared else 0
    rows = acc_rows(T, G) * 2 * G * 4
    return _round16(_alpha_smem(G) + lattice + rows + (V + 2 * G) * 4)


def ctc_plan(T: int, S: int, V: int, want_grad: bool) -> CTCPlan:
    """The kernel and geometry for log-probs (B, T, V) and targets (B, S).

    A recursion runs on ceil((2S+1) / 64) warps, two slots a thread (3 warps
    at the flagship's S = 64). Without a gradient: ``ctc_alpha_kernel``, one
    block of those warps an example. With one: ``ctc_alpha_beta_kernel``, a
    cluster of two blocks of FUSED_THREADS an example (alpha and beta, then
    all the threads form the occupancies), each with its (T, 2S+1) lattice
    of float pairs in shared memory where it fits in a block's 227 KB
    (T <= 167 at S = 64, V = 41; 181,952 bytes at the flagship's T = 121)
    and else in a (B, 2, T, 2S+1) global scratch. Raises for a shape no
    plan takes (2S+1 > MAX_SLOTS, V > MAX_VOCAB, an empty dimension)."""
    L = 2 * S + 1
    if T < 1 or V < 1 or S < 0:
        raise ValueError(f"ctc kernel: no plan for an empty shape (T={T}, S={S}, V={V})")
    if L > MAX_SLOTS:
        raise ValueError(f"ctc kernel: 2*S+1 = {L} slots > {MAX_SLOTS}")
    if V > MAX_VOCAB:
        raise ValueError(f"ctc kernel: vocabulary {V} > {MAX_VOCAB}")
    G = recursion_threads(L)
    if not want_grad:
        return CTCPlan(FWD_KERNEL, SLOTS, G, _round16(_alpha_smem(G)), "none", 1)
    shared = _fused_smem(T, L, V, G, True)
    if shared <= MAX_SMEM_BYTES:
        return CTCPlan(FUSED_KERNEL, SLOTS, FUSED_THREADS, shared, "shared", 2)
    return CTCPlan(FUSED_KERNEL, SLOTS, FUSED_THREADS, _fused_smem(T, L, V, G, False), "global", 2)


def scratch_shape(B: int, T: int, S: int) -> tuple:
    """float64 elements of the global scratch: (B, 2, T, 2S+1) float pairs."""
    return (B, 2, T, 2 * S + 1)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ctc")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ctc_launch.argtypes = [p, p, p, p] + [i] * 12 + [p, p, p, p]
        lib.ctc_launch.restype = i
        _LIB = lib
    return _LIB


def reset_counters() -> None:
    global FWD_LAUNCHES, FUSED_LAUNCHES
    FWD_LAUNCHES = 0
    FUSED_LAUNCHES = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"ctc kernel: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"ctc kernel: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ctc kernel: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"ctc kernel: {name} must be contiguous")


def raw_launch(plan: CTCPlan, log_probs, targets, input_lengths, target_lengths,
               blank_id: int, zero_infinity: bool, loss, occ=None, scratch=None) -> int:
    """One ``ctc_launch`` on the current stream with ``plan`` as given; returns
    its CUDA error code (0 on success). Counts nothing."""
    B, T, V = log_probs.shape
    S = targets.shape[1]
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(log_probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _lib().ctc_launch(
            log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
            target_lengths.data_ptr(), B, T, V, S, int(blank_id), int(bool(zero_infinity)),
            int(plan.kernel == FUSED_KERNEL), plan.slots, plan.threads, plan.smem_bytes,
            LATTICES.index(plan.lattice), plan.cluster, ptr(scratch), ptr(loss), ptr(occ), stream,
        )


def launch(plan: CTCPlan, log_probs, targets, input_lengths, target_lengths,
           blank_id: int, zero_infinity: bool, loss, occ=None, scratch=None) -> None:
    """:func:`raw_launch`, raising on a refused or failed launch, and counted."""
    global FWD_LAUNCHES, FUSED_LAUNCHES
    rc = raw_launch(plan, log_probs, targets, input_lengths, target_lengths, blank_id,
                    zero_infinity, loss, occ, scratch)
    if rc != 0:
        raise RuntimeError(f"ctc kernel: {plan.kernel} launch failed with CUDA error {rc}")
    if plan.kernel == FUSED_KERNEL:
        FUSED_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1


class CTCLossFunction(torch.autograd.Function):
    """Per-example CTC loss. The forward is one kernel; with ``want_grad`` it
    also writes the occupancy sums, and the backward scales them.

    Takes ``log_probs`` (B, T, V) float32, ``targets`` (B, S) int32 and
    ``input_lengths`` / ``target_lengths`` (B,) int32, all contiguous and
    on one CUDA device."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank_id: int, zero_infinity: bool, want_grad: bool = True):
        device = log_probs.device
        if device.type != "cuda":
            raise ValueError(f"ctc kernel: log_probs is on {device}, expected a CUDA device")
        if log_probs.dim() != 3 or targets.dim() != 2:
            raise ValueError("ctc kernel: expected log_probs (B, T, V) and targets (B, S)")
        B, T, V = log_probs.shape
        S = targets.shape[1]
        _check(log_probs, "log_probs", torch.float32, (B, T, V), device)
        _check(targets, "targets", torch.int32, (B, S), device)
        _check(input_lengths, "input_lengths", torch.int32, (B,), device)
        _check(target_lengths, "target_lengths", torch.int32, (B,), device)
        if B < 1:
            raise ValueError(f"ctc kernel: empty batch (B={B})")
        if not 0 <= blank_id < V:
            raise ValueError(f"ctc kernel: blank_id {blank_id} outside [0, {V})")
        # ``needs_input_grad`` is True under no_grad too; the caller says.
        want_grad = bool(want_grad) and ctx.needs_input_grad[0]
        plan = ctc_plan(T, S, V, want_grad)
        loss = torch.empty(B, device=device, dtype=torch.float32)
        occ = torch.empty_like(log_probs) if want_grad else None
        scratch = (torch.empty(scratch_shape(B, T, S), device=device, dtype=torch.float64)
                   if plan.lattice == "global" else None)
        launch(plan, log_probs, targets, input_lengths, target_lengths, blank_id,
               zero_infinity, loss, occ, scratch)
        ctx.save_for_backward(occ)
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        (occ,) = ctx.saved_tensors
        if occ is None:
            raise RuntimeError("ctc kernel: the forward ran without a gradient (want_grad=False)")
        grad = occ * (-grad_loss.to(occ.dtype))[:, None, None]
        return grad, None, None, None, None, None, None


def ctc_loss_cuda(
    log_probs: torch.Tensor,        # (B, T, V) log-softmax normalized, CUDA
    targets: torch.Tensor,          # (B, S)
    input_lengths: torch.Tensor,    # (B,)
    target_lengths: torch.Tensor,   # (B,)
    blank_id: int = 0,
    zero_infinity: bool = True,
) -> torch.Tensor:                  # (B,)
    """Casts to the kernels' dtypes (float32 log-probs, int32 labels and
    lengths, contiguous) and applies :class:`CTCLossFunction`; the gradient
    is formed in the forward only when autograd will ask for it."""
    log_probs = log_probs.float().contiguous()
    return CTCLossFunction.apply(
        log_probs,
        targets.to(torch.int32).contiguous(),
        input_lengths.to(torch.int32).contiguous(),
        target_lengths.to(torch.int32).contiguous(),
        blank_id,
        zero_infinity,
        torch.is_grad_enabled() and log_probs.requires_grad,
    )
