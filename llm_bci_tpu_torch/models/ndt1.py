"""NDT1 — transformer encoder over time-binned spikes, with the ``ctc``,
``mlm`` and ``autoregressive`` heads (counterpart of
``llm_bci_tpu/models/ndt1.py``).

The module tree and parameter names follow the reference torch layout that
``llm_bci_tpu/interop/torch_export.py`` emits, so a JAX param tree loads
here with a strict ``load_state_dict`` (:mod:`llm_bci_tpu_torch.interop`).

Attention takes one of two paths, chosen per call by
``NeuralEncoder._use_flash_now``: the dense path (explicit probabilities,
the band + padding mask OR the diagonal) or the banded flash-attention
kernels (``ops/flash_attention.py``: the mask evaluated in the kernel, no
diagonal, attention-probability dropout inside the kernel). Options not
ported yet raise ``NotImplementedError`` naming their ROADMAP item: the
``endtoend`` method, active factors, ``from_pt`` warm start and remat.

Stochastic parts (white / offset noise, maskers, dropout, Poisson sampling
in ``generate``) draw from an explicit ``torch.Generator`` passed in; with
``generator=None`` they use torch's global RNG. Train / eval follows
``Module.training``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from llm_bci_tpu_torch.config import resolve_path, to_plain_dict, update_config
from llm_bci_tpu_torch import not_ported
from llm_bci_tpu_torch.model_output import ModelOutput
from llm_bci_tpu_torch.ops.attention import dot_product_attention, dropout, make_attention_mask
from llm_bci_tpu_torch.ops.context import create_context_mask
from llm_bci_tpu_torch.models.masker import MaskerConfig, apply_maskers
from llm_bci_tpu_torch.ops.ctc import ctc_loss
from llm_bci_tpu_torch.ops.flash_attention import (
    FLASH_AUTO_MIN_T,
    banded_flash_attention,
    draw_seed,
)
from llm_bci_tpu_torch.ops.losses import mse_loss, poisson_nll_loss
from llm_bci_tpu_torch.ops.rotary import apply_rotary_pos_emb, rope_cos_sin
from llm_bci_tpu_torch.ops.smoothing import gaussian_kernel, smooth_spikes
from llm_bci_tpu_torch.registry import register_model

DEFAULT_CONFIG = "configs/ndt1.yaml"
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)

ACT2FN = {
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="none"),   # exact erf GELU
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


class NDT1Output(ModelOutput):
    pass


def _linear(n_in: int, n_out: int, bias: bool = True, scale: float = 1.0) -> nn.Linear:
    """``nn.Linear`` with torch's default init (uniform in +-1/sqrt(fan_in)),
    the kernel scaled by the fixup factor ``scale``."""
    layer = nn.Linear(n_in, n_out, bias=bias)
    if scale != 1.0:
        with torch.no_grad():
            layer.weight.mul_(scale)
    return layer


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class SmoothAndNoise(nn.Module):
    """Gaussian temporal smoothing plus train-time white and constant-offset
    noise (``llm_bci_tpu/models/ndt1.py:108``)."""

    def __init__(self, noise: bool, smooth_sd: Optional[float],
                 white_noise_sd: Optional[float], constant_offset_sd: Optional[float]):
        super().__init__()
        self.noise = noise
        self.white_noise_sd = white_noise_sd
        self.constant_offset_sd = constant_offset_sd
        kernel = None if smooth_sd is None else torch.from_numpy(gaussian_kernel(smooth_sd))
        self.register_buffer("kernel", kernel, persistent=False)

    def forward(self, spikes: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, N = spikes.shape
        if self.kernel is not None:
            spikes = smooth_spikes(spikes, self.kernel)
        if self.noise and self.training:
            if self.white_noise_sd is not None:
                spikes = spikes + self.white_noise_sd * torch.randn(
                    (B, T, N), generator=generator, device=spikes.device, dtype=spikes.dtype
                )
            if self.constant_offset_sd is not None:
                spikes = spikes + self.constant_offset_sd * torch.randn(
                    (B, 1, N), generator=generator, device=spikes.device, dtype=spikes.dtype
                )
        return spikes


class StackProjection(nn.Module):
    """Temporal stacking and projection as one strided conv:
    ``out[b,l,h] = sum_{w,d} x[b, l*stride+w, d] * weight[h, w*D+d] + bias[h]``.
    The parameter keeps the Linear layout ``weight (H, size*D)`` of the
    reference's Unfold -> Linear, so checkpoints carry over unchanged."""

    def __init__(self, in_dim: int, hidden_size: int, size: int, stride: int):
        super().__init__()
        self.in_dim, self.size, self.stride = in_dim, size, stride
        fan_in = size * in_dim
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = nn.Parameter(torch.empty(hidden_size, fan_in).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(hidden_size).uniform_(-bound, bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, D) -> (B, L, H)
        H = self.weight.shape[0]
        kernel = self.weight.view(H, self.size, self.in_dim).transpose(1, 2)   # (H, D, size)
        out = F.conv1d(x.transpose(1, 2), kernel, self.bias, stride=self.stride)
        return out.transpose(1, 2)


def stacked_lengths(lengths: torch.Tensor, size: int, stride: int, active: bool) -> torch.Tensor:
    """Sequence lengths after stacking."""
    if not active:
        return lengths
    return torch.div(lengths - size, stride, rounding_mode="floor") + 1


class NeuralEmbeddingLayer(nn.Module):
    """Spike embedding: (per-day) linear, activation, temporal stacking,
    learned positional embedding, optional day / block prefix tokens
    (``llm_bci_tpu/models/ndt1.py:194``)."""

    def __init__(self, hidden_size: int, n_channels: int, n_blocks: int, n_days: int,
                 max_F: int, input_dim: int, adapt: bool, day_token: bool,
                 block_token: bool, pos: bool, act: str, use_bias: bool, dropout: float,
                 stack_active: bool, stack_size: int, stack_stride: int,
                 stack_pad_multiple: int = 1):
        super().__init__()
        self.adapt, self.day_token, self.block_token = adapt, day_token, block_token
        self.act = ACT2FN[act]
        self.dropout = dropout
        self.stack_active = stack_active
        self.stack_size, self.stack_stride = stack_size, stack_stride
        self.stack_pad_multiple = max(int(stack_pad_multiple), 1)
        if adapt:
            # Per-day Linear layers, applied as one gathered einsum.
            self.embed_spikes = nn.ModuleList(
                _linear(n_channels, input_dim, use_bias) for _ in range(n_days)
            )
        else:
            self.embed_spikes = _linear(n_channels, input_dim, use_bias)
        if stack_active:
            self.stack_projection = StackProjection(input_dim, hidden_size, stack_size, stack_stride)
        else:
            self.projection = _linear(input_dim, hidden_size)
        self.embed_pos = nn.Embedding(max_F, hidden_size) if pos else None
        self.block_embedding = nn.Embedding(n_blocks, hidden_size) if block_token else None
        self.day_embedding = nn.Embedding(n_days, hidden_size) if day_token else None

    def forward(self, spikes, spikes_mask, spikes_timestamp, block_idx=None, day_idx=None,
                generator: Optional[torch.Generator] = None):
        if (self.adapt or self.day_token) and day_idx is None:
            raise ValueError("adapt/day_token require a day_idx batch column")
        if self.block_token and block_idx is None:
            raise ValueError("block_token requires a block_idx batch column")
        if self.adapt:
            w = torch.stack([layer.weight for layer in self.embed_spikes])    # (days, D, C)
            x = torch.einsum("btc,bdc->btd", spikes, w[day_idx])
            if self.embed_spikes[0].bias is not None:
                b = torch.stack([layer.bias for layer in self.embed_spikes])  # (days, D)
                x = x + b[day_idx][:, None, :]
        else:
            x = self.embed_spikes(spikes)
        x = self.act(x)

        if self.stack_active:
            x = self.stack_projection(x)
            L = x.shape[1]
            spikes_timestamp = spikes_timestamp[:, :L]
            # A stacked frame is valid only if every bin of its window was.
            windows = spikes_mask.float().unfold(1, self.stack_size, self.stack_stride)
            spikes_mask = windows.prod(-1).to(spikes_mask.dtype)
            pad = (-L) % self.stack_pad_multiple
            if pad:
                x = F.pad(x, (0, 0, 0, pad))
                spikes_mask = F.pad(spikes_mask, (0, pad))
                spikes_timestamp = F.pad(spikes_timestamp, (0, pad))
        else:
            x = self.projection(x)

        if self.embed_pos is not None:
            x = x + self.embed_pos(spikes_timestamp).to(x.dtype)
        ones = torch.ones_like(spikes_mask[:, :1])
        if self.block_embedding is not None:
            x = torch.cat([self.block_embedding(block_idx)[:, None, :].to(x.dtype), x], dim=1)
            spikes_mask = torch.cat([ones, spikes_mask], dim=1)
        if self.day_embedding is not None:
            x = torch.cat([self.day_embedding(day_idx)[:, None, :].to(x.dtype), x], dim=1)
            spikes_mask = torch.cat([ones, spikes_mask], dim=1)

        x = dropout(x, self.dropout, self.training, generator)
        return x, spikes_mask, spikes_timestamp


class NeuralAttention(nn.Module):
    """Multi-head self-attention with optional RoPE
    (``llm_bci_tpu/models/ndt1.py:330``). ``attn_mask=None`` selects the
    flash path, which takes ``key_valid`` and the band widths instead."""

    def __init__(self, hidden_size: int, n_heads: int, use_bias: bool, dropout: float,
                 n_layers: int, fixup_init: bool, use_rope: bool = False,
                 rope_theta: float = 10000.0, max_F: int = 1024,
                 context_forward: Optional[int] = None,
                 context_backward: Optional[int] = None):
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by n_heads {n_heads}")
        self.n_heads = n_heads
        self.dropout = dropout
        self.use_rope = use_rope
        self.context_forward, self.context_backward = context_forward, context_backward
        if use_rope:
            cos, sin = rope_cos_sin(hidden_size // n_heads, max_F, rope_theta)
            self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)
        fixup = 0.67 * n_layers ** (-0.25) if fixup_init else 1.0
        self.query = _linear(hidden_size, hidden_size, use_bias)
        self.key = _linear(hidden_size, hidden_size, use_bias)
        self.value = _linear(hidden_size, hidden_size, use_bias,
                             fixup * 2**0.5 if fixup_init else 1.0)
        self.out_proj = _linear(hidden_size, hidden_size, use_bias, fixup)

    def forward(self, x, attn_mask, key_valid=None, timestamp=None,
                generator: Optional[torch.Generator] = None):
        B, T, Hd = x.shape
        shape = (B, T, self.n_heads, Hd // self.n_heads)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        if self.use_rope:
            qh, kh = apply_rotary_pos_emb(q.transpose(1, 2), k.transpose(1, 2), timestamp,
                                          self.rope_cos, self.rope_sin)
            q, k = qh.transpose(1, 2), kh.transpose(1, 2)
        rate = self.dropout if self.training else 0.0
        if attn_mask is None:
            # Attention-probability dropout runs inside the kernel; no
            # (B, H, T, T) tensor is made. Its seed is drawn here, on the
            # device, from the generator (or from the global RNG).
            seed = draw_seed(generator, x.device) if rate > 0.0 else None
            out = banded_flash_attention(
                q, k, v, key_valid, context_forward=self.context_forward,
                context_backward=self.context_backward, dropout_rate=rate, seed=seed,
            )
        else:
            out = dot_product_attention(q, k, v, mask=attn_mask, dropout_rate=rate,
                                        generator=generator)
        out = dropout(out.reshape(B, T, Hd), self.dropout, self.training, generator)
        return self.out_proj(out)


class NeuralMLP(nn.Module):
    """Up-proj -> act -> down-proj -> dropout (``llm_bci_tpu/models/ndt1.py:415``)."""

    def __init__(self, hidden_size: int, inter_size: int, act: str, use_bias: bool,
                 dropout: float, fixup_scale: float = 1.0):
        super().__init__()
        self.up_proj = _linear(hidden_size, inter_size, use_bias)
        self.act = ACT2FN[act]
        self.down_proj = _linear(inter_size, hidden_size, use_bias, fixup_scale)
        self.dropout = dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.down_proj(self.act(self.up_proj(x)))
        return dropout(x, self.dropout, self.training, generator)


class NeuralEncoderLayer(nn.Module):
    """Pre-LN block: LN -> attn -> residual, LN -> MLP -> residual
    (``llm_bci_tpu/models/ndt1.py:448``)."""

    def __init__(self, cfg: Dict[str, Any], max_F: int = 1024,
                 context_forward: Optional[int] = None,
                 context_backward: Optional[int] = None):
        super().__init__()
        fixup = 0.67 * cfg["n_layers"] ** (-0.25) if cfg["fixup_init"] else 1.0
        H = cfg["hidden_size"]
        self.ln1 = nn.LayerNorm(H, eps=LN_EPS)
        self.attn = NeuralAttention(
            H, cfg["n_heads"], cfg["attention_bias"], cfg["dropout"], cfg["n_layers"],
            cfg["fixup_init"], use_rope=bool(cfg.get("use_rope")),
            rope_theta=float(cfg.get("rope_theta", 10000.0)), max_F=max_F,
            context_forward=context_forward, context_backward=context_backward,
        )
        self.ln2 = nn.LayerNorm(H, eps=LN_EPS)
        self.mlp = NeuralMLP(H, cfg["inter_size"], cfg["act"], cfg["mlp_bias"], cfg["dropout"],
                             fixup)

    def forward(self, x, attn_mask, key_valid=None, timestamp=None,
                generator: Optional[torch.Generator] = None):
        x = x + self.attn(self.ln1(x), attn_mask, key_valid, timestamp, generator)
        return x + self.mlp(self.ln2(x), generator)


class NeuralEncoder(nn.Module):
    """NDT1 trunk: smooth + noise -> maskers -> embed / stack -> transformer
    -> out-norm (``llm_bci_tpu/models/ndt1.py:546``)."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = config
        emb, tr, ctx = config["embedder"], config["transformer"], config["context"]
        self.masker_cfgs = tuple(
            MaskerConfig.from_config(m) for m in (config.get("masker") or {}).values()
        )
        if config["factors"]["active"]:
            raise not_ported("An active factors projection", "Queue 1, slice 1, item 4")
        if config.get("remat"):
            raise not_ported("remat", "Queue 1, slice 1, item 5")
        self.context_mask_np = create_context_mask(ctx["forward"], ctx["backward"], emb["max_F"])
        mode = tr.get("flash_attention", "auto")
        self.flash_mode = {True: "on", False: "off"}.get(mode, str(mode))
        self.flash_possible = (
            ctx["forward"] != -1 and ctx["backward"] != -1 and self.flash_mode != "off"
        )
        sn = config["smooth_and_noise"]
        self.smooth_and_noise = SmoothAndNoise(
            sn["noise"], sn["smooth_sd"], sn["white_noise_sd"], sn["constant_offset_sd"]
        )
        self.embedder = NeuralEmbeddingLayer(
            hidden_size=tr["hidden_size"], n_channels=emb["n_channels"],
            n_blocks=emb["n_blocks"], n_days=emb["n_days"], max_F=emb["max_F"],
            input_dim=emb["input_dim"], adapt=emb["adapt"], day_token=emb["day_token"],
            block_token=emb["block_token"], pos=emb["pos"], act=emb["act"],
            use_bias=emb["bias"], dropout=emb["dropout"],
            stack_active=emb["stack"]["active"], stack_size=emb["stack"]["size"],
            stack_stride=emb["stack"]["stride"],
            stack_pad_multiple=int(emb["stack"].get("pad_to_multiple", 1)),
        )
        # -2 is unbounded; -1 ("mask the self-offset") is only expressible as
        # a dense mask, so it keeps the dense path (flash_possible above).
        fwd_w = None if ctx["forward"] < 0 else ctx["forward"]
        bwd_w = None if ctx["backward"] < 0 else ctx["backward"]
        self.layers = nn.ModuleList(
            NeuralEncoderLayer(tr, emb["max_F"], fwd_w, bwd_w) for _ in range(tr["n_layers"])
        )
        self.out_norm = nn.LayerNorm(tr["hidden_size"], eps=LN_EPS)
        self.factors_dropout = config["factors"]["dropout"]

    def _use_flash_now(self, T: int) -> bool:
        """Per-call flash decision (``_use_flash_now`` of the JAX package,
        without its mesh conditions): mode ``on`` takes the flash path,
        ``auto`` takes it from ``FLASH_AUTO_MIN_T`` tokens, a ``-1`` context
        or mode ``off`` never. The decision does not look at the device: on
        a CUDA tensor the flash path launches the kernels, on a CPU tensor it
        runs their plain version."""
        if not self.flash_possible:
            return False
        if self.flash_mode == "on":
            return True
        return self.flash_mode == "auto" and T >= FLASH_AUTO_MIN_T

    def forward(self, spikes, spikes_mask, spikes_timestamp, block_idx=None, day_idx=None,
                generator: Optional[torch.Generator] = None, neuron_regions_idx=None,
                masker_overrides: Optional[dict] = None):
        spikes = self.smooth_and_noise(spikes, generator)
        spikes, targets_mask = apply_maskers(
            self.masker_cfgs, spikes, generator, self.training,
            neuron_regions_idx=neuron_regions_idx, overrides=masker_overrides,
        )
        x, spikes_mask, spikes_timestamp = self.embedder(
            spikes, spikes_mask, spikes_timestamp, block_idx, day_idx, generator
        )
        Tn = x.shape[1]
        if self._use_flash_now(Tn):
            # The band + padding mask is evaluated inside the kernel.
            attn_mask = None
        else:
            if Tn <= self.context_mask_np.shape[0]:
                context_np = self.context_mask_np[:Tn, :Tn]
            else:
                c = self.config["context"]
                context_np = create_context_mask(c["forward"], c["backward"], Tn)
            attn_mask = make_attention_mask(
                spikes_mask, torch.from_numpy(context_np).to(x.device))
        for layer in self.layers:
            x = layer(x, attn_mask, spikes_mask, spikes_timestamp, generator)
        x = self.out_norm(x)
        # Drop the day / block prefix tokens, and their mask entries.
        n_prefix = int(self.embedder.day_token) + int(self.embedder.block_token)
        x, spikes_mask = x[:, n_prefix:], spikes_mask[:, n_prefix:]
        x = dropout(x, self.factors_dropout, self.training, generator)
        return x.float(), spikes_mask, targets_mask


# ---------------------------------------------------------------------------
# NDT1 with method heads
# ---------------------------------------------------------------------------


@register_model("NDT1")
class NDT1(nn.Module):
    """NDT1 with a method-specific decoder head and loss
    (``llm_bci_tpu/models/ndt1.py:761``). ``method_name`` is ``"mlm"``,
    ``"autoregressive"`` or ``"ctc"``."""

    def __init__(self, config: Dict[str, Any], method_name: str, loss: str = "poisson_nll",
                 log_input: bool = True, vocab_size: int = 41, blank_id: int = 0,
                 zero_infinity: bool = True):
        super().__init__()
        enc = config["encoder"]
        if method_name == "mlm":
            if not any(m.get("active", True) for m in enc["masker"].values()):
                raise ValueError("Can't pretrain with inactive masking")
            if enc["embedder"]["stack"]["active"]:
                raise ValueError("Can't pretrain with stacked inputs")
            n_outputs = enc["embedder"]["n_channels"]
        elif method_name == "autoregressive":
            if enc["context"]["forward"] != 0:
                raise ValueError("Autoregressive training requires context.forward == 0")
            if enc["embedder"]["stack"]["active"]:
                raise ValueError("Can't train autoregressive with stacked inputs")
            n_outputs = enc["embedder"]["n_channels"]
        elif method_name == "ctc":
            n_outputs = vocab_size
        elif method_name == "endtoend":
            raise not_ported("NDT1 method 'endtoend'", "Queue 1, slice 3, left")
        else:
            raise ValueError(f"Method {method_name} not implemented yet for NDT1")
        self.config = config
        self.method_name = method_name
        self.loss_name, self.log_input = loss, log_input
        self.blank_id, self.zero_infinity = blank_id, zero_infinity
        if enc.get("from_pt") or (config.get("decoder") or {}).get("from_pt"):
            raise not_ported("Warm start from_pt", "Queue 1, slice 3, left")
        self.encoder = NeuralEncoder(enc)
        self.decoder = _linear(enc["transformer"]["hidden_size"], n_outputs)

    @classmethod
    def from_config(cls, model_config, **method_kwargs) -> "NDT1":
        """Merge a trainer-style model config over ``configs/ndt1.yaml``."""
        cfg = update_config(resolve_path(DEFAULT_CONFIG), model_config)
        kwargs = {k: v for k, v in method_kwargs.items() if k in (
            "method_name", "loss", "log_input", "vocab_size", "blank_id", "zero_infinity"
        )}
        return cls(config=to_plain_dict(cfg), **kwargs)

    def _decode(self, x: torch.Tensor) -> torch.Tensor:
        """The head, in float32 outside autocast."""
        with torch.autocast(x.device.type, enabled=False):
            preds = self.decoder(x.float())
            if self.method_name in ("mlm", "autoregressive"):
                if self.loss_name == "mse" or not self.log_input:
                    preds = F.relu(preds)
            else:
                preds = F.log_softmax(preds, dim=-1)
        return preds

    def _ssl_loss(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if self.loss_name == "poisson_nll":
            return poisson_nll_loss(preds, targets, log_input=self.log_input)
        if self.loss_name == "mse":
            return mse_loss(preds, targets)
        raise ValueError(f"Loss {self.loss_name} not implemented yet for mlm")

    def forward(
        self,
        spikes: torch.Tensor,             # (B, T, N)
        spikes_mask: torch.Tensor,        # (B, T)
        spikes_timestamp: torch.Tensor,   # (B, T)
        spikes_lengths: torch.Tensor,     # (B,)
        targets: Optional[torch.Tensor] = None,
        targets_lengths: Optional[torch.Tensor] = None,
        block_idx: Optional[torch.Tensor] = None,
        day_idx: Optional[torch.Tensor] = None,
        neuron_regions_idx: Optional[torch.Tensor] = None,
        masker_overrides: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> NDT1Output:
        method = self.method_name
        if method in ("mlm", "autoregressive"):
            targets = spikes
        x, spikes_mask_out, targets_mask = self.encoder(
            spikes, spikes_mask, spikes_timestamp, block_idx, day_idx, generator,
            neuron_regions_idx=neuron_regions_idx, masker_overrides=masker_overrides,
        )
        preds = self._decode(x)

        if method == "mlm":
            tmask = targets_mask & spikes_mask_out[:, :, None].to(targets_mask.dtype)
            loss = (self._ssl_loss(preds, targets) * tmask).sum()
            return NDT1Output(loss=loss, n_examples=tmask.sum(), preds=preds,
                              targets=targets, mask=tmask)
        if method == "autoregressive":
            shift_mask = spikes_mask_out[:, :-1]
            loss = (
                self._ssl_loss(preds[:, :-1, :], targets[:, 1:, :]) * shift_mask[:, :, None]
            ).sum()
            return NDT1Output(loss=loss, n_examples=shift_mask.sum() * targets.shape[2],
                              preds=preds, targets=targets, mask=spikes_mask_out)

        stack = self.config["encoder"]["embedder"]["stack"]
        lens = stacked_lengths(spikes_lengths, stack["size"], stack["stride"], stack["active"])
        with torch.autocast(x.device.type, enabled=False):
            if stack["active"]:
                # Frames past the unpadded stacked length exist only for
                # pad_to_multiple; pin them to blank for decoding.
                L_valid = 1 + (spikes.shape[1] - stack["size"]) // stack["stride"]
                if preds.shape[1] > L_valid:
                    blank_row = torch.full_like(preds[:, L_valid:], -1e9)
                    blank_row[:, :, self.blank_id] = 0.0
                    preds = torch.cat([preds[:, :L_valid], blank_row], dim=1)
            loss = ctc_loss(preds, targets, lens, targets_lengths, self.blank_id,
                            self.zero_infinity).sum()
        return NDT1Output(
            loss=loss,
            n_examples=torch.tensor(spikes.shape[0], dtype=torch.int32),
            preds=preds,
            targets=targets,
        )

    # ------------------------------------------------------------ generation

    @torch.no_grad()
    def generate(
        self,
        spikes: torch.Tensor,             # (B, T0, N)
        spikes_mask: torch.Tensor,        # (B, T0)
        spikes_timestamp: torch.Tensor,   # (B, T0)
        spikes_lengths: Optional[torch.Tensor] = None,
        block_idx: Optional[torch.Tensor] = None,
        day_idx: Optional[torch.Tensor] = None,
        max_new_bins: int = 16,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:   # (B, max_new_bins, N) preds, sampled bins
        """Iterative spike-bin generation (``llm_bci_tpu/models/ndt1.py:936``)
        over a fixed ``(B, T0 + max_new_bins, N)`` buffer with a validity
        mask, one eval-mode forward per new bin. ``autoregressive`` predicts
        the next bin from the last valid one; ``mlm`` appends a zeroed bin
        and reconstructs it. With ``poisson_nll`` the new bin is sampled from
        the predicted rates with ``generator``."""
        if self.method_name not in ("mlm", "autoregressive"):
            raise ValueError(f"generate not supported for method {self.method_name}")
        was_training = self.training
        self.eval()
        B, T0, N = spikes.shape
        buf = torch.cat([spikes, spikes.new_zeros((B, max_new_bins, N))], dim=1)
        mask = torch.cat([spikes_mask, spikes_mask.new_zeros((B, max_new_bins))], dim=1)
        new_ts = spikes_timestamp[:, -1:] + torch.arange(
            1, max_new_bins + 1, device=spikes.device)[None, :]
        ts = torch.cat([spikes_timestamp, new_ts.to(spikes_timestamp.dtype)], dim=1)
        preds_out, bins_out = [], []
        mlm = self.method_name == "mlm"
        for t_new in range(T0, T0 + max_new_bins):
            if mlm:
                mask[:, t_new] = 1
            x, _, _ = self.encoder(buf, mask, ts, block_idx, day_idx, generator)
            preds = self._decode(x)
            new_preds = preds[:, t_new if mlm else t_new - 1, :]
            new_bins = new_preds
            if self.loss_name == "poisson_nll":
                if self.log_input:
                    new_preds = torch.exp(new_preds)
                new_bins = torch.poisson(new_preds, generator=generator).to(buf.dtype)
            buf[:, t_new, :] = new_bins
            if not mlm:
                mask[:, t_new] = 1
            preds_out.append(new_preds)
            bins_out.append(new_bins)
        self.train(was_training)
        return torch.stack(preds_out, dim=1), torch.stack(bins_out, dim=1)
