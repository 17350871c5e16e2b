"""Banded flash attention through the hand-written CUDA kernels of
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernels of ``llm_bci_tpu/ops/flash_attention.py``
(``_fwd_kernel`` via ``_flash_fwd``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` via ``_flash_bwd``; the custom VJP ``_flash_core`` is the
ops' registered backward).
The forward kernel writes ``out`` and ``lse``; the backward takes
``delta = rowsum(dO * O)`` from ``flash_delta_kernel`` (one pass over ``out``
and ``dout``, in place of the expression XLA fuses in the JAX package) and
recomputes the probabilities from ``lse`` in two kernels, one owning query
tiles (dQ) and one owning key tiles (dK, dV; no atomics).
:func:`forward_plan` and :func:`backward_plan` say which kernel a dtype and
head size run. See the ``.cu`` file for the design and what bounds it.

The kernels read the public ``(B, T, H, D)`` layout directly and take head
sizes 32, 64 and 128; ``banded_flash_attention`` zero-pads any other ``D`` to
the next of those (the logits do not change: ``scale`` comes from the true
``D``), and a ``D`` above 128 raises. bf16 and float32 are taken, any ``T``.
:func:`flash_forward_cuda` and :func:`flash_backward_cuda` are the CUDA
bodies of the custom ops ``llm_bci::flash_fwd`` and ``llm_bci::flash_bwd``
(registered in :mod:`llm_bci_tpu_torch.ops.flash_attention`); they check
device, dtype, shape and contiguity and raise on the rest; there is no
fallback to the plain version. ``FWD_LAUNCHES``, ``BWD_DELTA_LAUNCHES``,
``BWD_DQ_LAUNCHES`` and ``BWD_DKV_LAUNCHES`` count the launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from llm_bci_tpu_torch.ops import _build
from llm_bci_tpu_torch.ops.flash_attention import HEAD_SIZES, dropout_threshold

FWD_LAUNCHES = 0
BWD_DELTA_LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0

TILE = 64                # queries a block owns, and keys a step of its sweep
MAX_SMEM_BYTES = 232448  # what one block can use on an H100

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        meta = [i, i, i, i, i, i, i, f, u, f, i]   # B T H D bf16 fwd bwd scale thresh inv use
        plan = [i, i, i, i, i]                       # KernelPlan after its kernel name
        lib.flash_fwd_launch.argtypes = [p, p, p, p, p, p, p] + meta + [i, p]   # smem, stream
        lib.flash_delta_launch.argtypes = [p, p, p, i, i, i, i, i, p]   # B T H D bf16 stream
        lib.flash_dq_launch.argtypes = [p, p, p, p, p, p, p, p, p] + meta + plan + [p]
        lib.flash_dkv_launch.argtypes = [p, p, p, p, p, p, p, p, p, p] + meta + plan + [p]
        for fn in (lib.flash_fwd_launch, lib.flash_delta_launch, lib.flash_dq_launch,
                   lib.flash_dkv_launch):
            fn.restype = i
        _LIB = lib
    return _LIB


def reset_counters() -> None:
    global FWD_LAUNCHES, BWD_DELTA_LAUNCHES, BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_DELTA_LAUNCHES = 0
    BWD_DQ_LAUNCHES = 0
    BWD_DKV_LAUNCHES = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"flash kernel: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash kernel: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"flash kernel: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash kernel: {name} must be contiguous")


def _raise_if_failed(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash kernel: {what} launch failed with CUDA error {rc}")


def kernel_meta(q: torch.Tensor, fwd: int, bwd: int, scale: float, drop_p: float) -> tuple:
    """The scalar arguments shared by the three launchers: B, T, H, D,
    is_bf16, band widths, scale, the keep threshold, 1 / (1 - p), use_drop."""
    B, T, H, D = q.shape
    return (
        B, T, H, D, int(q.dtype == torch.bfloat16), int(fwd), int(bwd), float(scale),
        dropout_threshold(drop_p) if drop_p > 0.0 else 0,
        1.0 / (1.0 - drop_p) if drop_p > 0.0 else 1.0, int(drop_p > 0.0),
    )


class ForwardPlan(NamedTuple):
    """What the forward launcher decides on the host."""
    kernel: str          # "wgmma" or "mma"
    stages: int          # K / V tiles in shared memory at a time
    smem_bytes: int      # dynamic shared memory of a block
    blocks_per_sm: int   # by shared memory, each block paying 1 KB of overhead


def forward_plan(D: int, is_bf16: bool) -> ForwardPlan:
    """The forward kernel of one head size and dtype. bf16 with ``D`` of 64
    or 128 takes the wgmma kernel: Q and rings of two K and two V tiles of
    ``TILE`` rows in the swizzled layout, the rings' barriers, and 1 KB of
    slack to align the tiles to the swizzle atom. float32 and ``D = 32`` take
    the ``mma.sync`` / CUDA-core kernel: Q, one K and one V tile with 16
    bytes of padding a row, and the probabilities. The launcher refuses a
    plan whose shared memory differs from the kernel's own."""
    if D not in HEAD_SIZES:
        raise ValueError(f"flash kernel: head size {D} not in {HEAD_SIZES}")
    if is_bf16 and D >= 64:
        kernel, stages = "wgmma", 2
        smem = (1 + 2 * stages) * TILE * D * 2 + 64 + 1024
    else:
        kernel, stages = "mma", 1
        e = 2 if is_bf16 else 4
        pad = 16 // e
        smem = e * (3 * TILE * (D + pad) + TILE * (TILE + pad)) + 4 * TILE
    return ForwardPlan(kernel, stages, smem, MAX_SMEM_BYTES // (smem + 1024))


class KernelPlan(NamedTuple):
    """One backward kernel as the launcher decides it on the host. Every
    field after ``kernel`` goes to the launcher, which refuses a launch when
    one differs from the kernel's own constants."""
    kernel: str          # "wgmma" or "mma"
    tile_rows: int       # rows a block owns: queries (dQ) or keys (dK/dV)
    stages: int          # tiles of the swept side in shared memory at a time
    threads: int         # threads of a block
    smem_bytes: int      # dynamic shared memory of a block
    blocks_per_sm: int   # by shared memory (1 KB of overhead a block) and registers


class BackwardPlan(NamedTuple):
    dq: KernelPlan
    dkv: KernelPlan


def backward_plan(D: int, is_bf16: bool) -> BackwardPlan:
    """The backward kernels of one head size and dtype. bf16 with ``D`` of 64
    or 128 takes the wgmma kernels. dQ: one warpgroup, whose first thread
    also issues the TMA loads, owns ``TILE`` queries, with Q, dO, a ring of
    three K tiles and of one (``D = 128``) or two V tiles; two blocks an SM.
    dK/dV: two warpgroups own ``2 * TILE`` keys, with K, V, a ring of four
    (Q, dO) pairs that the block's first thread loads and two buffers of lse
    and delta a warpgroup; one block an SM at ``D = 128``, where dk and dv
    fill the registers, two at ``D = 64``.
    float32 and ``D = 32`` take the ``mma.sync`` / CUDA-core kernels: one
    tile of each operand with 16 bytes of padding a row, ``ds`` (dQ) or
    ``p^T`` and ``ds^T`` over 32 queries (dK/dV). The launchers refuse a plan
    whose rows, stages, threads, shared memory or blocks an SM differ from
    the kernel's own."""
    if D not in HEAD_SIZES:
        raise ValueError(f"flash kernel: head size {D} not in {HEAD_SIZES}")
    if is_bf16 and D >= 64:
        tile = TILE * D * 2
        v_stages = 1 if D == 128 else 2
        dq = KernelPlan("wgmma", TILE, 3, 128, (2 + 3 + v_stages) * tile + 128 + 1024, 2)
        dkv = KernelPlan("wgmma", 2 * TILE, 4, 256, (4 + 2 * 4) * tile + 2048 + 128 + 1024,
                         1 if D == 128 else 2)
    else:
        e = 2 if is_bf16 else 4
        pad = 16 // e
        qstep = TILE // 2        # queries a step of the dK/dV sweep
        dq_smem = e * (4 * TILE * (D + pad) + TILE * (TILE + pad)) + 4 * TILE
        dkv_smem = e * ((2 * TILE + 2 * qstep) * (D + pad) + 2 * TILE * (qstep + pad)) + 8 * qstep
        dq = KernelPlan("mma", TILE, 1, 128, dq_smem, MAX_SMEM_BYTES // (dq_smem + 1024))
        dkv = KernelPlan("mma", TILE, 1, 128, dkv_smem, MAX_SMEM_BYTES // (dkv_smem + 1024))
    return BackwardPlan(dq, dkv)


def check_forward(q, k, v, key_valid, seed, fwd: int, bwd: int) -> None:
    """Raise unless the kernels take these arguments: contiguous ``(B, T, H,
    D)`` tensors of one dtype (bf16 or float32) on one CUDA device with ``D``
    in ``HEAD_SIZES``, ``key_valid`` ``(B, T)`` int32 or ``None``, ``seed`` a
    one-element int32 tensor or ``None``, band widths in ``[0, T]``."""
    device = q.device
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel: dtype {q.dtype} not taken (bfloat16, float32)")
    if q.dim() != 4:
        raise ValueError("flash kernel: expected q, k, v of shape (B, T, H, D)")
    B, T, H, D = q.shape
    if D not in HEAD_SIZES:
        raise ValueError(f"flash kernel: head size {D} not in {HEAD_SIZES}")
    if B < 1 or T < 1 or H < 1:
        raise ValueError(f"flash kernel: empty input {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, q.dtype, (B, T, H, D), device)
    if key_valid is not None:
        _check(key_valid, "key_valid", torch.int32, (B, T), device)
    if seed is not None:
        _check(seed, "seed", torch.int32, (1,), device)
    if not (0 <= fwd <= T and 0 <= bwd <= T):
        raise ValueError(f"flash kernel: band widths ({fwd}, {bwd}) outside [0, {T}]")
    # the device last, so that every other refusal can be seen without a card
    if device.type != "cuda":
        raise ValueError(f"flash kernel: q is on {device}, expected a CUDA device")


def flash_forward_cuda(q, k, v, key_valid, seed, fwd: int, bwd: int, scale: float,
                       drop_p: float):
    """``llm_bci::flash_fwd`` on CUDA: checks the call (:func:`check_forward`)
    and launches the forward kernel; ``(out, lse)``. ``scale`` is passed in
    because ``D`` may be padded."""
    check_forward(q, k, v, key_valid, seed, fwd, bwd)
    use_drop = drop_p > 0.0 and seed is not None
    meta = kernel_meta(q, fwd, bwd, scale, drop_p if use_drop else 0.0)
    return flash_fwd(q, k, v, key_valid, seed if use_drop else None, meta)


def flash_backward_cuda(q, k, v, key_valid, seed, out, lse, dout, fwd: int, bwd: int,
                        scale: float, drop_p: float):
    """``llm_bci::flash_bwd`` on CUDA: ``delta`` by ``flash_delta_kernel``,
    then the dQ and the dK / dV kernels; ``(dq, dk, dv)``."""
    check_forward(q, k, v, key_valid, seed, fwd, bwd)
    _check(dout, "dout", q.dtype, q.shape, q.device)
    use_drop = drop_p > 0.0 and seed is not None
    seed = seed if use_drop else None
    meta = kernel_meta(q, fwd, bwd, scale, drop_p if use_drop else 0.0)
    delta = flash_delta(out, dout)
    dq = flash_dq(q, k, v, key_valid, seed, dout, lse, delta, meta)
    dk, dv = flash_dkv(q, k, v, key_valid, seed, dout, lse, delta, meta)
    return dq, dk, dv


def flash_fwd(q, k, v, key_valid, seed, meta):
    """Launches the forward kernel on tensors :func:`check_forward` has
    passed; ``meta`` is :func:`kernel_meta`'s tuple. Returns ``out``
    and ``lse`` ``(B, H, T)`` float32."""
    global FWD_LAUNCHES
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), device=q.device, dtype=torch.float32)
    smem = forward_plan(D, q.dtype == torch.bfloat16).smem_bytes
    with torch.cuda.device(q.device):
        rc = _lib().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_valid.data_ptr() if key_valid is not None else None,
            seed.data_ptr() if seed is not None else None,
            out.data_ptr(), lse.data_ptr(), *meta, smem,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "forward")
    FWD_LAUNCHES += 1
    return out, lse


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout * out)`` in float32, in the ``(B, H, T)`` layout
    of ``lse``, by ``flash_delta_kernel`` (the plain version is
    :func:`llm_bci_tpu_torch.ops.flash_attention.flash_delta_plain`). Takes
    contiguous ``(B, T, H, D)`` CUDA tensors of one dtype (bf16 or float32)
    with ``D`` in ``HEAD_SIZES``."""
    global BWD_DELTA_LAUNCHES
    if out.device.type != "cuda":
        raise ValueError(f"flash kernel: out is on {out.device}, expected a CUDA device")
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel: dtype {out.dtype} not taken (bfloat16, float32)")
    if out.dim() != 4 or out.shape[-1] not in HEAD_SIZES or out.numel() == 0:
        raise ValueError(f"flash kernel: out of shape {tuple(out.shape)} not taken")
    _check(out, "out", out.dtype, out.shape, out.device)
    _check(dout, "dout", out.dtype, out.shape, out.device)
    B, T, H, D = out.shape
    delta = torch.empty((B, H, T), device=out.device, dtype=torch.float32)
    with torch.cuda.device(out.device):
        rc = _lib().flash_delta_launch(
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, T, H, D,
            int(out.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "delta")
    BWD_DELTA_LAUNCHES += 1
    return delta


def _backward_args(q, k, v, key_valid, seed, dout, lse, delta):
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_valid.data_ptr() if key_valid is not None else None,
        seed.data_ptr() if seed is not None else None,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
    )


def flash_dq(q, k, v, key_valid, seed, dout, lse, delta, meta) -> torch.Tensor:
    """Launches the dQ kernel; see :func:`flash_fwd`."""
    global BWD_DQ_LAUNCHES
    dq = torch.empty_like(q)
    plan = backward_plan(q.shape[-1], q.dtype == torch.bfloat16).dq
    with torch.cuda.device(q.device):
        rc = _lib().flash_dq_launch(
            *_backward_args(q, k, v, key_valid, seed, dout, lse, delta), dq.data_ptr(), *meta,
            *plan[1:], torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "dQ")
    BWD_DQ_LAUNCHES += 1
    return dq


def flash_dkv(q, k, v, key_valid, seed, dout, lse, delta, meta):
    """Launches the dK/dV kernel; see :func:`flash_fwd`."""
    global BWD_DKV_LAUNCHES
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan = backward_plan(q.shape[-1], q.dtype == torch.bfloat16).dkv
    with torch.cuda.device(q.device):
        rc = _lib().flash_dkv_launch(
            *_backward_args(q, k, v, key_valid, seed, dout, lse, delta), dk.data_ptr(),
            dv.data_ptr(), *meta, *plan[1:], torch.cuda.current_stream().cuda_stream,
        )
    _raise_if_failed(rc, "dK/dV")
    BWD_DKV_LAUNCHES += 1
    return dk, dv
