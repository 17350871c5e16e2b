"""Plain PyTorch NDT1 train step: the reference that the benchmark holds the
port's timed path against.

It imports nothing of the port. It follows the published model
(colehurwitz/llm_bci ``models/ndt1.py`` and ``configs/ndt1.yaml``) as the
port's config runs it: Gaussian smoothing and white / constant-offset noise,
the maskers' ``random`` mode, a per-bin Linear with softsign, the temporal
stack as Unfold -> Linear (or a Linear projection without stacking), a
learned position table, pre-LN encoder layers (8 heads, GELU MLP), the out
norm and the head, the CTC loss or the masked Poisson NLL, then the AdamW
update of ``torch.optim.AdamW`` under the configured OneCycle / step /
linear schedule. Everything runs in float32 (TF32 off) except the CTC loss,
which runs in float64.

Random draws: the model's dropout, noise and maskers are part of the step
that is checked, so the reference makes the same draws, in the same order
and shapes, from a ``torch.Generator`` seeded with the trainer's seed on the
same device: a generator's stream is a function of its seed and the shapes
drawn. Attention-probability dropout has two forms, as the model has two
attention paths: below ``FLASH_MIN_T`` tokens a keep mask drawn with
``torch.rand`` over (B, heads, T, T); from it one int32 seed drawn with
``torch.randint`` and a counter-based keep mask of (seed, batch * heads +
head, query, key) (:func:`keep_mask`). The dense path lets each token attend
to itself whatever its padding; the long path has no such diagonal, and a
query with no valid key gives 0.

The precision of its matrix products, the weights, the schedule, AdamW and
the CER are ``reference.common``'s.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import Precision

LN_EPS = 1e-6        # the published model's LayerNorm epsilon (flax's default)
NEG = -1e30          # masked logits
FLASH_MIN_T = 512    # from this many tokens "flash_attention: auto" takes the long path
MAX_MASK_ROWS = 16   # (batch * head) rows of the long path's keep mask made at once


# -------------------------------------------------------------- parameters

def _supported(model: Dict) -> None:
    enc = model["encoder"]
    emb, tr, ctx = enc["embedder"], enc["transformer"], enc["context"]
    unsupported = {
        "embedder.adapt": emb["adapt"], "embedder.day_token": emb["day_token"],
        "embedder.block_token": emb["block_token"], "transformer.use_rope": tr["use_rope"],
        "factors.active": enc["factors"]["active"], "remat": enc.get("remat", False),
    }
    on = [k for k, v in unsupported.items() if v]
    if on or not (emb["pos"] and emb["bias"] and tr["attention_bias"] and tr["mlp_bias"]):
        raise NotImplementedError(f"reference NDT1: unsupported options {on}")
    if (ctx["forward"], ctx["backward"]) != (-2, -2):
        raise NotImplementedError("reference NDT1: only the unbounded context (-2, -2)")
    if emb["stack"]["active"] and int(emb["stack"].get("pad_to_multiple", 1)) != 1:
        raise NotImplementedError("reference NDT1: stack.pad_to_multiple must be 1")


def param_spec(model: Dict, n_channels: int, n_outputs: int) -> List[Tuple[str, tuple]]:
    """Names and shapes of the trainable leaves, in the published torch
    layout's names."""
    _supported(model)
    enc = model["encoder"]
    emb, tr = enc["embedder"], enc["transformer"]
    H, I, D = tr["hidden_size"], tr["inter_size"], emb["input_dim"]
    spec = [("encoder.embedder.embed_spikes.weight", (D, n_channels)),
            ("encoder.embedder.embed_spikes.bias", (D,))]
    if emb["stack"]["active"]:
        spec += [("encoder.embedder.stack_projection.weight", (H, emb["stack"]["size"] * D)),
                 ("encoder.embedder.stack_projection.bias", (H,))]
    else:
        spec += [("encoder.embedder.projection.weight", (H, D)),
                 ("encoder.embedder.projection.bias", (H,))]
    spec.append(("encoder.embedder.embed_pos.weight", (emb["max_F"], H)))
    for layer in range(tr["n_layers"]):
        p = f"encoder.layers.{layer}."
        spec += [(p + "ln1.weight", (H,)), (p + "ln1.bias", (H,))]
        for name in ("query", "key", "value", "out_proj"):
            spec += [(p + f"attn.{name}.weight", (H, H)), (p + f"attn.{name}.bias", (H,))]
        spec += [(p + "ln2.weight", (H,)), (p + "ln2.bias", (H,)),
                 (p + "mlp.up_proj.weight", (I, H)), (p + "mlp.up_proj.bias", (I,)),
                 (p + "mlp.down_proj.weight", (H, I)), (p + "mlp.down_proj.bias", (H,))]
    spec += [("encoder.out_norm.weight", (H,)), ("encoder.out_norm.bias", (H,)),
             ("decoder.weight", (n_outputs, H)), ("decoder.bias", (n_outputs,))]
    return spec

# ------------------------------------------------------------------ pieces

def gaussian_window(sd: float) -> np.ndarray:
    width = int(1 + 6 * sd)
    n = np.arange(width, dtype=np.float64) - (width - 1) / 2.0
    k = np.exp(-0.5 * (n / sd) ** 2)
    return (k / k.sum()).astype(np.float32)


def smooth(spikes: torch.Tensor, sd: float) -> torch.Tensor:
    """Correlate each channel with the window along time, zeros past the ends
    (``(W - 1) // 2`` bins before, the rest after)."""
    k = gaussian_window(sd)
    W = len(k)
    lo = (W - 1) // 2
    B, T, N = spikes.shape
    x = F.pad(spikes, (0, 0, lo, W - 1 - lo))
    out = torch.zeros_like(spikes)
    for w in range(W):
        out = out + float(k[w]) * x[:, w:w + T]
    return out


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def layer_norm(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w + b


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def keep_mask(seed: torch.Tensor, bh: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
              rate: float) -> torch.Tensor:
    """The long path's dropout: a murmur3-style mix of (seed, batch * heads +
    head, query, key) in uint32 arithmetic; kept where it reaches the
    threshold of ``rate``."""
    threshold = min(int(rate * 4294967296.0), 4294967295)
    x = _mul32(q_pos, 0x9E3779B1) ^ _mul32(k_pos, 0x85EBCA77)
    x = x ^ _mul32(bh, 0xC2B2AE3D)
    x = (x + (seed.to(torch.int64).reshape(()) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= threshold


def long_path(transformer: Dict, tokens: int) -> bool:
    """Whether attention over ``tokens`` takes the long path (its dropout and
    its missing diagonal): ``flash_attention`` on, or auto from
    ``FLASH_MIN_T`` tokens."""
    mode = transformer.get("flash_attention", "auto")
    mode = {True: "on", False: "off"}.get(mode, str(mode))
    return mode == "on" or (mode == "auto" and tokens >= FLASH_MIN_T)


def attention(x, p, prefix, n_heads, key_valid, rate, gen, prec: Precision, training: bool,
              long: bool):
    B, T, H = x.shape
    Dh = H // n_heads

    def heads(name):
        y = prec.linear(x, p[prefix + name + ".weight"], p[prefix + name + ".bias"])
        return y.view(B, T, n_heads, Dh).transpose(1, 2)           # (B, h, T, Dh)

    q, k, v = heads("query"), heads("key"), heads("value")
    logits = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(Dh)
    valid = key_valid.bool()[:, None, None, :]                     # (B, 1, 1, T)
    rate = rate if training else 0.0
    if not long:
        eye = torch.eye(T, dtype=torch.bool, device=x.device)[None, None]
        mask = valid | eye
        probs = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
        if rate > 0.0:
            keep = torch.rand((B, n_heads, T, T), generator=gen, device=x.device) >= rate
            probs = probs * keep.to(probs.dtype) / (1.0 - rate)
    else:
        seed = (torch.randint(0, 2**31 - 1, (1,), generator=gen, device=x.device,
                              dtype=torch.int32) if rate > 0.0 else None)
        mask = valid.expand(B, 1, T, T)
        probs = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
        probs = probs * mask.to(probs.dtype)            # a query with no valid key gives 0
        if seed is not None:
            pos = torch.arange(T, device=x.device, dtype=torch.int64)
            keep = torch.empty((B * n_heads, T, T), dtype=torch.bool, device=x.device)
            for r0 in range(0, B * n_heads, MAX_MASK_ROWS):
                rows = torch.arange(r0, min(r0 + MAX_MASK_ROWS, B * n_heads),
                                    device=x.device, dtype=torch.int64)
                keep[r0:r0 + len(rows)] = keep_mask(seed, rows[:, None, None], pos[:, None],
                                                    pos[None, :], rate)
            probs = probs * keep.view(B, n_heads, T, T).to(probs.dtype) / (1.0 - rate)
    out = prec.matmul(probs, v).transpose(1, 2).reshape(B, T, H)
    if training:
        out = dropout(out, rate, gen)
    return prec.linear(out, p[prefix + "out_proj.weight"], p[prefix + "out_proj.bias"])


# ------------------------------------------------------------------- model

def forward(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], model: Dict,
            method: str, gen, prec: Precision, training: bool = True):
    """``(loss, n_examples, preds)`` of one batch: the model's forward and
    its loss. ``batch`` holds ``spikes`` (B, T, N) float32, ``spikes_mask``,
    ``spikes_timestamp`` (B, T), ``spikes_lengths`` (B,) and, for ``ctc``,
    ``targets`` (B, S) and ``targets_lengths`` (B,)."""
    enc = model["encoder"]
    emb, tr, sn = enc["embedder"], enc["transformer"], enc["smooth_and_noise"]
    raw = batch["spikes"].float()
    spikes_mask, stamps = batch["spikes_mask"], batch["spikes_timestamp"]
    B, T, N = raw.shape
    dev = raw.device

    x = smooth(raw, sn["smooth_sd"]) if sn["smooth_sd"] is not None else raw
    if sn["noise"] and training:
        if sn["white_noise_sd"] is not None:
            x = x + sn["white_noise_sd"] * torch.randn((B, T, N), generator=gen, device=dev)
        if sn["constant_offset_sd"] is not None:
            x = x + sn["constant_offset_sd"] * torch.randn((B, 1, N), generator=gen, device=dev)

    targets_mask = torch.zeros((B, T, N), dtype=torch.bool, device=dev)
    for m in (enc.get("masker") or {}).values():
        if not m.get("active", True) or not training:
            continue
        if m.get("mode", "random") != "random":
            raise NotImplementedError("reference NDT1: only the random masker")
        mask = torch.rand((B, T, N), generator=gen, device=dev) < float(m["ratio"])
        zero = (torch.rand((B, T, N), generator=gen, device=dev) < float(m["zero_ratio"])) & mask
        x = torch.where(zero, torch.zeros_like(x), x)
        rnd = ((torch.rand((B, T, N), generator=gen, device=dev) < float(m["random_ratio"]))
               & mask & ~zero)
        top = x.max()
        x = torch.where(rnd, top * torch.rand((B, T, N), generator=gen, device=dev), x)
        targets_mask = targets_mask | mask

    h = F.softsign(prec.linear(x, p["encoder.embedder.embed_spikes.weight"],
                               p["encoder.embedder.embed_spikes.bias"]))
    stack = emb["stack"]
    if stack["active"]:
        size, stride = int(stack["size"]), int(stack["stride"])
        win = h.unfold(1, size, stride)                               # (B, L, D, size)
        L = win.shape[1]
        win = win.permute(0, 1, 3, 2).reshape(B, L, size * h.shape[-1])
        h = prec.linear(win, p["encoder.embedder.stack_projection.weight"],
                        p["encoder.embedder.stack_projection.bias"])
        tok_mask = spikes_mask.float().unfold(1, size, stride).prod(-1)
        stamps = stamps[:, :L]
    else:
        h = prec.linear(h, p["encoder.embedder.projection.weight"],
                        p["encoder.embedder.projection.bias"])
        tok_mask = spikes_mask.float()
    h = h + p["encoder.embedder.embed_pos.weight"][stamps.long()]
    if training:
        h = dropout(h, float(emb["dropout"]), gen)

    rate = float(tr["dropout"])
    long = long_path(tr, h.shape[1])
    for layer in range(tr["n_layers"]):
        pre = f"encoder.layers.{layer}."
        a = layer_norm(h, p[pre + "ln1.weight"], p[pre + "ln1.bias"])
        h = h + attention(a, p, pre + "attn.", tr["n_heads"], tok_mask, rate, gen, prec,
                          training, long)
        m = layer_norm(h, p[pre + "ln2.weight"], p[pre + "ln2.bias"])
        m = prec.linear(m, p[pre + "mlp.up_proj.weight"], p[pre + "mlp.up_proj.bias"])
        m = F.gelu(m, approximate="none")
        m = prec.linear(m, p[pre + "mlp.down_proj.weight"], p[pre + "mlp.down_proj.bias"])
        if training:
            m = dropout(m, rate, gen)
        h = h + m
    h = layer_norm(h, p["encoder.out_norm.weight"], p["encoder.out_norm.bias"])
    logits = prec.linear(h, p["decoder.weight"], p["decoder.bias"])

    if method == "mlm":
        tmask = targets_mask & spikes_mask.bool()[:, :, None]
        loss = ((torch.exp(logits) - raw * logits) * tmask).sum()
        return loss, tmask.sum(), logits
    if method != "ctc":
        raise NotImplementedError(f"reference NDT1: method {method!r}")
    log_probs = F.log_softmax(logits, dim=-1)
    if stack["active"]:
        lengths = (batch["spikes_lengths"].long() - int(stack["size"])) // int(stack["stride"]) + 1
    else:
        lengths = batch["spikes_lengths"].long()
    nll = F.ctc_loss(log_probs.double().transpose(0, 1), batch["targets"].long(), lengths,
                     batch["targets_lengths"].long(), blank=0, reduction="none",
                     zero_infinity=True)
    return nll.sum().float(), torch.tensor(B), log_probs


def draw_only(model: Dict, method: str, shape: Tuple[int, int, int], gen, device) -> None:
    """Move ``gen`` as one training forward of a batch of ``shape`` (B, T, N)
    moves it, without computing the step."""
    enc = model["encoder"]
    emb, tr, sn = enc["embedder"], enc["transformer"], enc["smooth_and_noise"]
    B, T, N = shape
    if sn["noise"]:
        if sn["white_noise_sd"] is not None:
            torch.randn((B, T, N), generator=gen, device=device)
        if sn["constant_offset_sd"] is not None:
            torch.randn((B, 1, N), generator=gen, device=device)
    for m in (enc.get("masker") or {}).values():
        if m.get("active", True):
            for _ in range(4):
                torch.rand((B, T, N), generator=gen, device=device)
    stack = emb["stack"]
    L = (T - int(stack["size"])) // int(stack["stride"]) + 1 if stack["active"] else T
    H = tr["hidden_size"]
    if emb["dropout"]:
        torch.rand((B, L, H), generator=gen, device=device)
    rate = float(tr["dropout"])
    if rate == 0.0:
        return
    for _ in range(tr["n_layers"]):
        if not long_path(tr, L):
            torch.rand((B, tr["n_heads"], L, L), generator=gen, device=device)
        else:
            torch.randint(0, 2**31 - 1, (1,), generator=gen, device=device, dtype=torch.int32)
        torch.rand((B, L, H), generator=gen, device=device)
        torch.rand((B, L, H), generator=gen, device=device)


def train_step(params: Dict[str, torch.Tensor], batch, model: Dict, method: str, gen,
               prec: Precision):
    """``(loss, n_examples, grads, preds)`` of one step on ``params``
    (leaves with ``requires_grad``); the gradient is that of the summed
    loss."""
    for v in params.values():
        v.grad = None
    loss, n, preds = forward(params, batch, model, method, gen, prec, training=True)
    loss.backward()
    grads = {k: v.grad.detach().clone() for k, v in params.items()}
    return float(loss.detach()), float(n), grads, preds.detach()


# -------------------------------------------------------------- operations

def _product(m: int, k: int, n: int, input_grad: bool = True) -> float:
    """Forward and backward operations of one (m, k) x (k, n) product whose
    second operand is a weight: 2 m k n each for the forward, the input
    gradient (where its input takes one) and the weight gradient."""
    return 2.0 * m * k * n * (3 if input_grad else 2)


def step_flops_per_sample(model: Dict, bins: int, n_channels: int, n_outputs: int) -> float:
    """Matrix-product operations of one training sample of ``bins`` bins
    through NDT1, counted from the shapes (nothing recomputed): the per-bin
    embedding (no input gradient: the spikes take none), the stack or the
    projection, each layer's four projections, its attention products (both
    operands take gradients) and its MLP, and the head."""
    enc = model["encoder"]
    emb, tr = enc["embedder"], enc["transformer"]
    H, I, D = tr["hidden_size"], tr["inter_size"], emb["input_dim"]
    flops = _product(bins, n_channels, D, input_grad=False)
    stack = emb["stack"]
    if stack["active"]:
        L = (bins - int(stack["size"])) // int(stack["stride"]) + 1
        flops += _product(L, int(stack["size"]) * D, H)
    else:
        L = bins
        flops += _product(L, D, H)
    per_layer = 4 * _product(L, H, H)
    per_layer += 2 * 3 * (2.0 * L * L * H)      # Q K^T and P V, forward and two gradients
    per_layer += _product(L, H, I) + _product(L, I, H)
    flops += tr["n_layers"] * per_layer
    flops += _product(L, H, n_outputs)
    return flops
