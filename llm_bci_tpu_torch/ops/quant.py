"""Int8 weight-only quantization of the frozen LLM base (counterpart of
``llm_bci_tpu/ops/quant.py``).

The frozen Llama projection kernels and ``lm_head`` are stored as int8 plus
one float32 scale per output channel (symmetric, absmax); matmuls
dequantize on the fly::

    y = (x @ q.to(compute)) * scale        # |q| <= 127 is exact in bf16

**Layout.** The port keeps the JAX package's leaf layout: ``kernel`` int8
``(K, N)`` = (in, out), row-major, and ``kernel_scale`` float32 ``(N,)``.
That is the transpose of ``nn.Linear``'s ``(out, in)`` weight; the CUDA
kernel reads 16 codes a thread along the contiguous N direction. The
bridges (``interop/from_jax.py``, ``models/llama.py::load_hf_llama_params``)
do the transposes.

**Dispatch.** :func:`int8_matmul` on a CUDA tensor always launches the
hand-written kernel (``ops/int8_matmul_cuda.py``) or raises; on a CPU tensor
it takes :func:`int8_matmul_plain`. The backward is a plain product outside
any kernel, ``dx = (g * scale) @ q^T``, as in the JAX package; ``q`` and
``scale`` take no gradient (the base is frozen).

``quantize_int8`` / ``dequantize_int8`` / ``adapt_quantization`` are
host-side numpy with the JAX package's semantics.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

QUANT_MODES = ("int8", "int8_xla")   # one storage layout, one path in the port


def quantize_int8(w, axis: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric absmax int8 quantization, one scale per output channel.
    ``w`` is an (in, out) kernel and ``axis`` its reduction (input) axis.
    Returns ``(q int8, scale float32)`` with ``q * scale ~= w``."""
    w = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(w), axis=axis, keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=axis).astype(np.float32)


def dequantize_int8(q, scale, dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_int8` for (in, out) kernels."""
    w = np.asarray(q).astype(np.float32) * np.asarray(scale, np.float32)[None, :]
    return w.astype(np.dtype(dtype))


def adapt_quantization(saved, target):
    """Re-lay-out a saved tree of numpy leaves to match ``target``'s
    quantization. At any dict node holding a ``kernel`` leaf: target int8
    and saved float quantizes the saved kernel (adds ``kernel_scale``);
    target float and saved int8 + ``kernel_scale`` dequantizes; agreeing
    layouts and all other leaves pass through."""
    if not (isinstance(saved, dict) and isinstance(target, dict)):
        return saved
    out = {
        k: adapt_quantization(v, target[k])
        if isinstance(v, dict) and isinstance(target.get(k), dict)
        else v
        for k, v in saved.items()
    }
    t_k, s_k = target.get("kernel"), out.get("kernel")
    if t_k is None or s_k is None or isinstance(s_k, dict):
        return out
    t_int8 = np.dtype(getattr(t_k, "dtype", np.float32)) == np.int8
    s_arr = np.asarray(s_k)
    s_float = not np.issubdtype(s_arr.dtype, np.integer)
    if t_int8 and s_float:
        q, scale = quantize_int8(s_arr.astype(np.float32), axis=0)
        out["kernel"], out["kernel_scale"] = q, scale
    elif not t_int8 and s_arr.dtype == np.int8 and "kernel_scale" in out:
        out["kernel"] = dequantize_int8(
            s_arr, out.pop("kernel_scale"), getattr(t_k, "dtype", np.float32)
        )
    return out


def int8_matmul_plain(
    x: torch.Tensor,                          # (..., K)
    q: torch.Tensor,                          # (K, N) int8
    scale: torch.Tensor,                      # (N,) float32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:                            # (..., N)
    """The plain version: convert, multiply, scale in float32, cast."""
    y = (x @ q.to(x.dtype)).float() * scale.float()
    return y.to(out_dtype or x.dtype)


class Int8MatmulFunction(torch.autograd.Function):
    """``x (M, K)`` times the int8 kernel; the forward is the CUDA kernel on a
    CUDA tensor and the plain version on a CPU tensor, the backward
    ``dx = (g * scale) @ q^T`` in the dtype of ``x``."""

    @staticmethod
    def forward(ctx, x, q, scale, out_dtype):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        if x.device.type == "cuda":
            from llm_bci_tpu_torch.ops.int8_matmul_cuda import int8_matmul_cuda

            return int8_matmul_cuda(x, q, scale, out_dtype)
        return int8_matmul_plain(x, q, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        gs = (g.float() * scale).to(ctx.x_dtype)
        return gs @ q.to(ctx.x_dtype).T, None, None, None


def int8_matmul(
    x: torch.Tensor,                          # (..., K)
    q: torch.Tensor,                          # (K, N) int8
    scale: torch.Tensor,                      # (N,) float32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:                            # (..., N)
    """``x @ dequant(q, scale)`` with the weight read as int8. Leading dims
    of ``x`` are flattened into M. Under ``torch.autocast`` ``x`` is cast to
    the autocast dtype first (a custom Function is invisible to autocast)."""
    if torch.is_autocast_enabled(x.device.type):
        x = x.to(torch.get_autocast_dtype(x.device.type))
    out_dtype = out_dtype or x.dtype
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    y = Int8MatmulFunction.apply(x2, q, scale, out_dtype)
    return y.reshape(*x.shape[:-1], q.shape[1])
