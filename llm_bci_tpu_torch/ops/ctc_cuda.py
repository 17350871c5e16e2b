"""CTC loss through the hand-written CUDA kernels of ``csrc/ctc.cu``.

Replaces the Pallas TPU kernels of ``llm_bci_tpu/ops/ctc_pallas.py``
(``_fwd_kernel`` via ``_run_fwd``, ``_bwd_kernel`` via ``_run_bwd``, and
the custom VJP ``ctc_loss_pallas``). The forward kernel runs the alpha
recursion and writes the loss, ``log p`` and, when a gradient is wanted,
the alpha lattice; the backward kernel runs the beta recursion and writes
the gradient w.r.t. ``log_probs`` directly, ``-g * sum_{s: z_s = v} occ``,
the JAX package's convention (not torch's native CTC gradient, whose
``log_probs`` gradient is only right after log-softmax's backward).

On an H100 the kernels are bound by latency: T sequential frames of a few
exp/log and one block barrier each, one block per example, so at B=64 only
64 of the 132 SMs are busy. See ``csrc/ctc.cu`` for the design.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernels do not take; there is no fallback to the plain
version. ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llm_bci_tpu_torch.ops import _build

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_SLOTS = 1024    # one thread per lattice slot, one block per example
MAX_VOCAB = 8192    # the backward kernel keeps one (V,) row in shared memory

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ctc")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ctc_alpha_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, p, p]
        lib.ctc_alpha_launch.restype = i
        lib.ctc_beta_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, p]
        lib.ctc_beta_launch.restype = i
        _LIB = lib
    return _LIB


def reset_counters() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"ctc kernel: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"ctc kernel: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ctc kernel: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"ctc kernel: {name} must be contiguous")


def _raise_if_failed(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"ctc kernel: {what} launch failed with CUDA error {rc}")


class CTCLossFunction(torch.autograd.Function):
    """Per-example CTC loss; forward and backward are one kernel each.

    Takes ``log_probs`` (B, T, V) float32, ``targets`` (B, S) int32 and
    ``input_lengths`` / ``target_lengths`` (B,) int32, all contiguous and
    on one CUDA device."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank_id: int, zero_infinity: bool):
        global FWD_LAUNCHES
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
        if 2 * S + 1 > MAX_SLOTS:
            raise ValueError(f"ctc kernel: 2*S+1 = {2 * S + 1} slots > {MAX_SLOTS}")
        if V > MAX_VOCAB:
            raise ValueError(f"ctc kernel: vocabulary {V} > {MAX_VOCAB}")
        if T < 1 or B < 1:
            raise ValueError(f"ctc kernel: empty input (B={B}, T={T})")
        if not 0 <= blank_id < V:
            raise ValueError(f"ctc kernel: blank_id {blank_id} outside [0, {V})")

        loss = torch.empty(B, device=device, dtype=torch.float32)
        # The recursion runs in double precision (see csrc/ctc.cu).
        log_p = torch.empty(B, device=device, dtype=torch.float64)
        alpha = (
            torch.empty((B, T, 2 * S + 1), device=device, dtype=torch.float64)
            if ctx.needs_input_grad[0]
            else None
        )
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib().ctc_alpha_launch(
                log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
                target_lengths.data_ptr(), B, T, V, S, int(blank_id),
                int(bool(zero_infinity)),
                alpha.data_ptr() if alpha is not None else None,
                loss.data_ptr(), log_p.data_ptr(), stream,
            )
        _raise_if_failed(rc, "forward")
        FWD_LAUNCHES += 1
        ctx.blank_id = int(blank_id)
        ctx.save_for_backward(log_probs, targets, input_lengths, target_lengths, alpha, log_p)
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        global BWD_LAUNCHES
        log_probs, targets, input_lengths, target_lengths, alpha, log_p = ctx.saved_tensors
        B, T, V = log_probs.shape
        S = targets.shape[1]
        grad_loss = grad_loss.to(torch.float32).contiguous()
        _check(grad_loss, "grad_loss", torch.float32, (B,), log_probs.device)
        grad = torch.empty_like(log_probs)
        with torch.cuda.device(log_probs.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib().ctc_beta_launch(
                log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
                target_lengths.data_ptr(), alpha.data_ptr(), log_p.data_ptr(),
                grad_loss.data_ptr(), B, T, V, S, ctx.blank_id, grad.data_ptr(), stream,
            )
        _raise_if_failed(rc, "backward")
        BWD_LAUNCHES += 1
        return grad, None, None, None, None, None


def ctc_loss_cuda(
    log_probs: torch.Tensor,        # (B, T, V) log-softmax normalized, CUDA
    targets: torch.Tensor,          # (B, S)
    input_lengths: torch.Tensor,    # (B,)
    target_lengths: torch.Tensor,   # (B,)
    blank_id: int = 0,
    zero_infinity: bool = True,
) -> torch.Tensor:                  # (B,)
    """Casts to the kernels' dtypes (float32 log-probs, int32 labels and
    lengths, contiguous) and applies :class:`CTCLossFunction`."""
    return CTCLossFunction.apply(
        log_probs.float().contiguous(),
        targets.to(torch.int32).contiguous(),
        input_lengths.to(torch.int32).contiguous(),
        target_lengths.to(torch.int32).contiguous(),
        blank_id,
        zero_infinity,
    )
