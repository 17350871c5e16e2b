"""Banded flash attention: public functions and the plain PyTorch version
(counterpart of ``llm_bci_tpu/ops/flash_attention.py``).

Self-attention on ``(B, T, H, D)`` where key ``j`` is visible to query
``i`` iff ``i - backward <= j <= i + forward`` and ``key_valid[b, j] != 0``
(``None`` widths are unbounded). Unlike the dense path
(:func:`llm_bci_tpu_torch.ops.attention.make_attention_mask`) there is **no
self-attend diagonal** here: a query with no visible key returns 0 and gets
zero gradients. Attention-probability dropout uses the JAX package's
counter-based keep mask (:func:`keep_mask`), so for one seed both packages
drop the same entries; the softmax normaliser is not affected by dropout and
kept probabilities are scaled by ``1 / (1 - p)``.

:func:`banded_flash_attention` calls the ``torch.library`` custom op
``llm_bci::flash_fwd`` (``out`` and ``lse``), whose registered backward is
``llm_bci::flash_bwd`` (``dq``, ``dk``, ``dv``). The op's dispatch key picks
the implementation, so a graph exported with ``torch.export`` keeps the op
node wherever it was traced: a CUDA tensor runs the hand-written kernels of
``csrc/flash_attention.cu`` (:mod:`llm_bci_tpu_torch.ops.flash_attention_cuda`),
or raises; a CPU tensor runs :func:`banded_flash_attention_plain` (and
:func:`flash_backward_plain`), which is also what the kernels are held
against on the card; any other device has no kernel. The plain version
materialises the ``(B, H, T, T)`` logits and is no measure of speed.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30
# Sequence length from which the NDT1 "auto" dispatch takes these kernels.
# The value is the JAX package's; where the kernels overtake the dense path
# on an H100 is measured by chip_smoke.py (see PERF.md) and the threshold
# will be set from those numbers.
FLASH_AUTO_MIN_T = 512

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` on int64 tensors holding uint32 values, without
    overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def dropout_threshold(drop_p: float) -> int:
    return min(int(drop_p * 4294967296.0), 4294967295)


def keep_mask(seed, bh: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
              drop_p: float) -> torch.Tensor:
    """The JAX package's ``_keep_mask``, element for element: a murmur3-style
    mixer of ``(seed, batch*H + head, q_pos, k_pos)`` in uint32 arithmetic
    (here on int64 masked to 32 bits). ``True`` = keep. The arguments
    broadcast against each other."""
    bh, q_pos, k_pos = (t.to(torch.int64) for t in (bh, q_pos, k_pos))
    if torch.is_tensor(seed):
        seed = seed.to(device=q_pos.device, dtype=torch.int64).reshape(())
    x = _mul32(q_pos, 0x9E3779B1) ^ _mul32(k_pos, 0x85EBCA77)
    x = x ^ _mul32(bh, 0xC2B2AE3D)
    x = (x + (seed & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(drop_p)


def _band_bounds(fwd: Optional[int], bwd: Optional[int], T: int) -> Tuple[int, int]:
    """(forward, backward) widths; ``None`` -> T (unbounded)."""
    return (T if fwd is None else min(int(fwd), T)), (T if bwd is None else min(int(bwd), T))


def visibility_mask(T: int, key_valid: Optional[torch.Tensor], fwd: int, bwd: int,
                    device) -> torch.Tensor:
    """(B or 1, 1, T, T) bool: band AND key padding, no diagonal."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    mask = ((j >= i - bwd) & (j <= i + fwd))[None, None]
    if key_valid is not None:
        mask = mask & (key_valid != 0)[:, None, None, :]
    return mask


def banded_flash_attention_plain(
    q: torch.Tensor,                          # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: Optional[torch.Tensor] = None,  # (B, T), nonzero = valid key
    context_forward: Optional[int] = None,
    context_backward: Optional[int] = None,
    dropout_rate: float = 0.0,
    seed: Union[None, int, torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain tensor version of the kernels: dense logits, the band + padding
    mask, a float32 softmax, rows with no visible key zeroed, the
    counter-based keep mask, the value product. Its gradient is autograd's.
    ``dropout_rate > 0`` needs a ``seed``; without one nothing is dropped.
    ``scale`` defaults to ``1 / sqrt(D)``."""
    return _plain_forward(q, k, v, key_valid, context_forward, context_backward,
                          dropout_rate, seed, scale)[0]


def _plain_forward(q, k, v, key_valid, context_forward, context_backward, dropout_rate, seed,
                   scale):
    """(out, lse (B, H, T) float32 with -1e30 on rows with no visible key, the
    probabilities before dropout (B, H, T, T) float32, the keep mask as 0 / 1
    floats or ``None`` without dropout)."""
    B, T, H, D = q.shape
    fwd, bwd = _band_bounds(context_forward, context_backward, T)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))        # (B, H, T, D)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float()
    logits = logits / math.sqrt(D) if scale is None else logits * scale
    mask = visibility_mask(T, key_valid, fwd, bwd, q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    lse = torch.where(mask.any(-1), torch.logsumexp(logits, dim=-1),
                      torch.full_like(logits[..., 0], NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask, probs, torch.zeros_like(probs))  # dead rows -> 0
    keep, dropped = None, probs
    if dropout_rate > 0.0 and seed is not None:
        pos = torch.arange(T, device=q.device)
        bh = torch.arange(B * H, device=q.device).reshape(B, H, 1, 1)
        keep = keep_mask(seed, bh, pos[:, None], pos[None, :], float(dropout_rate))
        keep = keep.to(probs.dtype)
        dropped = probs * keep / (1.0 - float(dropout_rate))
    out = torch.matmul(dropped.to(vh.dtype), vh).transpose(1, 2)
    return out, lse.expand(B, H, T), probs, keep


def flash_backward_plain(q, k, v, key_valid, seed, dout, fwd: int, bwd: int, scale: float,
                         drop_p: float):
    """``(dq, dk, dv)`` of :func:`banded_flash_attention_plain` in float32,
    returned in the dtypes of ``q``, ``k``, ``v``: the probabilities ``P``
    recomputed, ``dv = P_drop^T dO``, ``ds = P * (keep * dO V^T / (1 - p) -
    rowsum(dO * O))``, ``dq = ds K * scale``, ``dk = ds^T Q * scale``; 0 for
    masked entries and rows with no visible key. This is the kernels'
    backward written out: a custom op's CPU body cannot call into autograd."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    out, _, probs, keep = _plain_forward(qf, kf, vf, key_valid, fwd, bwd, drop_p, seed, scale)
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (qf, kf, vf, gf))  # (B, H, T, D)
    delta = (gf * out).sum(-1).transpose(1, 2)[..., None]          # (B, H, T, 1)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    dropped = probs
    if keep is not None:
        dp = dp * keep / (1.0 - drop_p)
        dropped = probs * keep / (1.0 - drop_p)
    ds = probs * (dp - delta)
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(dropped.transpose(-1, -2), gh)
    return tuple(g.transpose(1, 2).to(x.dtype).contiguous()
                 for g, x in ((dq, q), (dk, k), (dv, v)))


def flash_delta_plain(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout * out)`` of ``(B, T, H, D)`` tensors in float32,
    in the ``(B, H, T)`` layout of ``lse``: the softmax backward's row term,
    as the JAX package's ``_flash_bwd`` writes it. Plain version of
    ``flash_delta_kernel``."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One int32 in ``[0, 2**31 - 1)`` on ``device`` from ``generator``."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int32)


# --------------------------------------------------------------- custom ops

@torch.library.custom_op("llm_bci::flash_fwd", mutates_args=(), device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_valid: Optional[torch.Tensor], seed: Optional[torch.Tensor], fwd: int,
              bwd: int, scale: float, drop_p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of the banded attention; ``fwd`` / ``bwd`` are resolved
    band widths, ``seed`` a one-element int32 tensor or ``None`` (no
    dropout). CUDA: ``flash_fwd_wgmma_kernel`` / ``flash_fwd_kernel``."""
    out, lse, _, _ = _plain_forward(q, k, v, key_valid, fwd, bwd, drop_p, seed, scale)
    return out.contiguous(), lse.contiguous()


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, key_valid, seed, fwd, bwd, scale, drop_p):
    from llm_bci_tpu_torch.ops import flash_attention_cuda

    return flash_attention_cuda.flash_forward_cuda(q, k, v, key_valid, seed, fwd, bwd, scale,
                                                   drop_p)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, key_valid, seed, fwd, bwd, scale, drop_p):
    B, T, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, T), dtype=torch.float32)


@torch.library.custom_op("llm_bci::flash_bwd", mutates_args=(), device_types="cpu")
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_valid: Optional[torch.Tensor], seed: Optional[torch.Tensor],
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, fwd: int, bwd: int,
              scale: float, drop_p: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``. CUDA: ``flash_delta_kernel``, then the dQ and the
    dK / dV kernels."""
    return flash_backward_plain(q, k, v, key_valid, seed, dout, fwd, bwd, scale, drop_p)


@flash_bwd.register_kernel("cuda")
def _flash_bwd_cuda(q, k, v, key_valid, seed, out, lse, dout, fwd, bwd, scale, drop_p):
    from llm_bci_tpu_torch.ops import flash_attention_cuda

    return flash_attention_cuda.flash_backward_cuda(q, k, v, key_valid, seed, out, lse, dout,
                                                    fwd, bwd, scale, drop_p)


@flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, key_valid, seed, out, lse, dout, fwd, bwd, scale, drop_p):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, key_valid, seed, fwd, bwd, scale, drop_p = inputs
    out, lse = output
    ctx.band = (fwd, bwd, scale, drop_p)
    ctx.save_for_backward(q, k, v, out, lse, key_valid, seed)
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse, key_valid, seed = ctx.saved_tensors
    dout = dout.to(q.dtype).contiguous()   # arrives strided after a transpose
    dq, dk, dv = flash_bwd(q, k, v, key_valid, seed, out, lse, dout, *ctx.band)
    return dq, dk, dv, None, None, None, None, None, None


flash_fwd.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_core(q, k, v, key_valid, seed, fwd: int, bwd: int, scale: float,
               drop_p: float) -> torch.Tensor:
    """``out`` of ``llm_bci::flash_fwd`` on arguments already in the kernels'
    form (contiguous ``(B, T, H, D)`` of one dtype, int32 ``key_valid``, a
    one-element int32 ``seed`` or ``None``), with its gradient."""
    return flash_fwd(q, k, v, key_valid, seed, fwd, bwd, scale, drop_p)[0]


HEAD_SIZES = (32, 64, 128)   # the kernels' head sizes; a smaller D is zero-padded to one


def banded_flash_attention(
    q: torch.Tensor,                          # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: Optional[torch.Tensor] = None,  # (B, T), nonzero = valid key
    context_forward: Optional[int] = None,     # None = unbounded
    context_backward: Optional[int] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    seed: Union[None, int, torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention with a static banded window and dynamic key padding.
    Rows with no visible key return 0.

    ``dropout_rate > 0`` with a ``generator`` (on the tensors' device) draws
    one seed from it and drops attention probabilities inside the kernel;
    with neither ``generator`` nor ``seed`` nothing is dropped, as in the JAX
    package. ``seed`` (an int or a one-element tensor) pins the keep mask.

    Brings the arguments to the kernels' form (contiguous, one dtype, int32
    ``key_valid``, a one-element int32 seed tensor, ``D`` zero-padded to 32 /
    64 / 128 with ``scale`` from the true ``D``) on every device and calls
    :func:`flash_core`: a CUDA tensor runs the kernels (and raises on what
    they do not take), a CPU tensor the plain version."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "banded_flash_attention: q, k, v must share one (B, T, H, D) shape (no GQA), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, T, H, D = q.shape
    drop_p = float(dropout_rate)
    if drop_p > 0.0 and seed is None and generator is not None:
        seed = draw_seed(generator, q.device)
    if drop_p > 0.0 and seed is not None:
        if not torch.is_tensor(seed):
            seed = torch.tensor([int(seed)], dtype=torch.int32, device=q.device)
        seed = seed.to(device=q.device, dtype=torch.int32).reshape(1).contiguous()
    else:
        seed, drop_p = None, 0.0
    fwd, bwd = _band_bounds(context_forward, context_backward, T)
    if fwd < 0 or bwd < 0:
        raise ValueError(f"flash kernel: negative band widths ({fwd}, {bwd})")
    scale = 1.0 / math.sqrt(D)
    Dp = next((s for s in HEAD_SIZES if s >= D), D)   # above 128 the kernels refuse
    k, v = k.to(q.dtype), v.to(q.dtype)
    if Dp != D:
        q, k, v = (torch.nn.functional.pad(x, (0, Dp - D)) for x in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if key_valid is not None:
        key_valid = (key_valid != 0).to(torch.int32).contiguous()
    out = flash_core(q, k, v, key_valid, seed, fwd, bwd, scale, drop_p)
    return out[..., :D] if Dp != D else out


def flash_attention(q, k, v, mask=None, is_causal: bool = False) -> torch.Tensor:
    """Full or causal self-attention (band forward = 0) through
    :func:`banded_flash_attention`; dense masks are not expressible."""
    if mask is not None:
        raise NotImplementedError(
            "dense masks are not supported on the generic flash path; "
            "use banded_flash_attention(key_valid=...) for band+padding"
        )
    return banded_flash_attention(
        q, k, v, None, context_forward=0 if is_causal else None, context_backward=None
    )
