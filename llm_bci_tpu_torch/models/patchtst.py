"""PatchTST for spiking activity: patches of each channel's time series
through a channel-independent transformer, with the ``mlm`` (reconstruct
masked patches) and ``ctc`` heads (counterpart of
``llm_bci_tpu/models/patchtst.py``).

* :func:`patchify` is ``unfold(T, patch_length, patch_stride)``, channels
  first: ``(B, C, P, patch_length)``;
* random masking keeps ``int(P * (1 - ratio))`` patches of each (example,
  channel), ranked by uniform noise drawn from the ``generator`` (the same
  noise for every channel with ``channel_consistent_masking``), and fills the
  others with ``mask_value``; it runs only in training;
* the encoder: ``std`` / ``mean`` scaling over time (``std`` with ddof=0),
  a shared patch embedding, the normalised sincos table, pre- or post-norm
  layers with BatchNorm or LayerNorm over ``d_model``, attention over the
  patches of one channel (channels folded into the batch); float32 out;
* :class:`FlaxBatchNorm` keeps flax's convention: the running averages move
  by ``1 - momentum`` = 0.01 a training step and take the *biased* batch
  variance (``torch.nn.BatchNorm1d`` moves by 0.1 and takes the unbiased one);
* the heads run in float32 outside autocast, with shared projections or one
  per channel (a stacked parameter and an einsum).

Dropout and masking draw from the ``generator`` passed in; ``from_pt`` warm
start raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from llm_bci_tpu_torch import not_ported
from llm_bci_tpu_torch.config import resolve_path, to_plain_dict, update_config
from llm_bci_tpu_torch.model_output import ModelOutput
from llm_bci_tpu_torch.models.ndt1 import ACT2FN
from llm_bci_tpu_torch.ops.attention import dot_product_attention, dropout
from llm_bci_tpu_torch.ops.ctc import ctc_loss
from llm_bci_tpu_torch.ops.losses import mse_loss, poisson_nll_loss
from llm_bci_tpu_torch.registry import register_model

DEFAULT_CONFIG = "configs/patchtst.yaml"
METHOD_KWARGS = ("method_name", "loss", "log_input", "vocab_size", "blank_id",
                 "zero_infinity")


@dataclasses.dataclass
class PatchTSTOutput(ModelOutput):
    patch_input: Optional[torch.Tensor] = None


def patchify(x: torch.Tensor, patch_length: int, patch_stride: int) -> torch.Tensor:
    """(B, T, C) -> (B, C, num_patches, patch_length)."""
    return x.unfold(1, patch_length, patch_stride).permute(0, 2, 1, 3)


def num_patches(T: int, patch_length: int, patch_stride: int) -> int:
    return 1 + (T - patch_length) // patch_stride


def patch_noise(shape: Tuple[int, int, int], channel_consistent: bool,
                generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform noise ``(B, C, P)`` that ranks the patches for masking, one row
    for all channels of an example when ``channel_consistent``."""
    B, C, P = shape
    noise = torch.rand((B, 1 if channel_consistent else C, P), generator=generator,
                       device=device)
    return noise.expand(B, C, P)


def random_patch_masking(patches: torch.Tensor, noise: torch.Tensor, mask_ratio: float,
                         mask_value: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask the patches whose noise ranks at or past ``int(P * (1 - ratio))``
    among their (example, channel)'s; returns (masked patches, mask), the
    mask True on masked patches."""
    P = patches.shape[2]
    len_keep = int(P * (1 - mask_ratio))
    ranks = noise.argsort(dim=-1, stable=True).argsort(dim=-1, stable=True)
    mask = ranks >= len_keep
    masked = torch.where(mask[..., None], torch.full_like(patches, mask_value), patches)
    return masked, mask


@functools.lru_cache(maxsize=8)
def sincos_position_encoding(P: int, d_model: int) -> np.ndarray:
    """The sincos table, mean-centred and scaled by ``1 / (std * 10)`` with
    the unbiased std (ddof=1), as Hugging Face PatchTST normalises it."""
    pos = np.arange(P, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((P, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    pe = pe - pe.mean()
    return pe / (pe.std(ddof=1) * 10)


class FlaxBatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's running averages:
    ``running = MOMENTUM * running + (1 - MOMENTUM) * batch`` with the biased
    batch variance. In training the batch statistics normalise and the running
    averages move; in eval the running averages normalise."""

    MOMENTUM = 0.99        # flax nn.BatchNorm's default

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2d = x.float().reshape(-1, shape[-1])
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x2d, dim=0, unbiased=False)
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
            out = F.batch_norm(x2d, None, None, self.weight, self.bias, True, 0.0, self.eps)
        else:
            out = F.batch_norm(x2d, self.running_mean, self.running_var, self.weight,
                               self.bias, False, 0.0, self.eps)
        return out.reshape(shape)


class PatchTSTNorm(nn.Module):
    """``batchnorm`` (:class:`FlaxBatchNorm` over ``d_model``) or ``layernorm``,
    in float32."""

    def __init__(self, norm_type: str, d_model: int, eps: float = 1e-5):
        super().__init__()
        if norm_type == "batchnorm":
            self.bn = FlaxBatchNorm(d_model, eps)
        else:
            self.ln = nn.LayerNorm(d_model, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return self.bn(x) if hasattr(self, "bn") else self.ln(x.float())


class PatchTSTEncoderLayer(nn.Module):
    """Attention and FFN blocks over ``(B*C, P, D)``, pre- or post-norm, each
    block's output through drop-path (element dropout at ``path_dropout``)."""

    def __init__(self, c: Dict[str, Any]):
        super().__init__()
        D, bias = c["d_model"], c.get("bias", True)
        self.n_heads = c["num_attention_heads"]
        self.act = ACT2FN[c["activation_function"]]
        self.pre_norm = bool(c.get("pre_norm", True))
        self.attn_drop = float(c.get("attention_dropout", 0.0))
        self.ff_drop = float(c.get("ff_dropout", 0.0))
        self.path_drop = float(c.get("path_dropout", 0.0))
        self.qkv = nn.Linear(D, 3 * D, bias=bias)
        self.attn_out = nn.Linear(D, D, bias=bias)
        self.ff1 = nn.Linear(D, c["ffn_dim"], bias=bias)
        self.ff2 = nn.Linear(c["ffn_dim"], D, bias=bias)
        norm = (c.get("norm_type", "batchnorm"), D, c.get("norm_eps", 1e-5))
        self.norm1 = PatchTSTNorm(*norm)
        self.norm2 = PatchTSTNorm(*norm)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = lambda t, rate: dropout(t, rate, self.training, generator)

        def attn_block(h):
            BC, P, D = h.shape
            shape = (BC, P, self.n_heads, D // self.n_heads)
            q, k, v = (t.reshape(shape) for t in self.qkv(h).chunk(3, dim=-1))
            out = dot_product_attention(q, k, v).reshape(BC, P, D)
            return self.attn_out(drop(out, self.attn_drop))

        def ff_block(h):
            return self.ff2(drop(self.act(self.ff1(h)), self.ff_drop))

        if self.pre_norm:
            x = x + drop(attn_block(self.norm1(x)), self.path_drop)
            return x + drop(ff_block(self.norm2(x)), self.path_drop)
        x = self.norm1(x + drop(attn_block(x), self.path_drop))
        return self.norm2(x + drop(ff_block(x), self.path_drop))


class PatchTSTEncoder(nn.Module):
    """Scaling -> patchify -> random masking (training only) -> embedding +
    sincos -> the layers. Returns ``(hidden (B, C, P, D) float32, mask (B, C,
    P) or None, the patches before masking)``."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        c = config
        if c.get("do_mask_input") and c.get("mask_type", "random") != "random":
            raise ValueError("Only random patch masking is implemented")
        self.config = c
        self.patch_embed = nn.Linear(c["patch_length"], c["d_model"], bias=c.get("bias", True))
        self.layers = nn.ModuleList(
            PatchTSTEncoderLayer(c) for _ in range(c["num_hidden_layers"]))

    def forward(self, spikes: torch.Tensor, generator: Optional[torch.Generator] = None):
        c = self.config
        B, T, C = spikes.shape
        scaling = c.get("scaling")
        if scaling == "std":
            std, mean = torch.std_mean(spikes, dim=1, keepdim=True, correction=0)
            spikes = (spikes - mean) / (std + 1e-5)
        elif scaling == "mean":
            spikes = spikes / (spikes.abs().mean(dim=1, keepdim=True) + 1e-5)

        patches = patchify(spikes, c["patch_length"], c["patch_stride"])   # (B, C, P, L)
        patch_input = patches
        mask = None
        if c.get("do_mask_input"):
            if self.training:
                noise = patch_noise(patches.shape[:3],
                                    bool(c.get("channel_consistent_masking", False)),
                                    generator, spikes.device)
                patches, mask = random_patch_masking(
                    patches, noise, float(c["random_mask_ratio"]), float(c.get("mask_value", 0)))
            else:
                mask = torch.zeros(patches.shape[:3], dtype=torch.bool, device=spikes.device)

        x = self.patch_embed(patches)
        P, D = x.shape[2], x.shape[3]
        pe = torch.tensor(sincos_position_encoding(P, D), device=x.device)
        x = dropout(x + pe, float(c.get("positional_dropout", 0.0)), self.training, generator)
        x = x.reshape(B * C, P, D)
        for layer in self.layers:
            x = layer(x, generator)
        return x.reshape(B, C, P, D).float(), mask, patch_input


def _per_channel(C: int, d_in: int, d_out: int) -> Tuple[nn.Parameter, nn.Parameter]:
    """A stacked weight ``(C, d_in, d_out)`` (LeCun normal) and bias ``(C, d_out)``."""
    return (nn.Parameter(torch.randn(C, d_in, d_out) / d_in ** 0.5),
            nn.Parameter(torch.zeros(C, d_out)))


class PretrainHead(nn.Module):
    """Each patch's bins from its embedding: shared projections, or one per
    channel; ReLU when the loss does not take log-rates."""

    def __init__(self, c: Dict[str, Any], num_input_channels: int, d_model: int,
                 patch_length: int, log_input: bool):
        super().__init__()
        self.head_dropout = float(c.get("head_dropout", 0.0))
        self.share = bool(c.get("share_projection", True))
        self.mlp = bool(c.get("mlp_decoder"))
        self.act = ACT2FN[c.get("mlp_activation", "gelu")]
        self.log_input = log_input
        if self.share:
            if self.mlp:
                self.proj_hidden = nn.Linear(d_model, d_model)
            self.proj_out = nn.Linear(d_model, patch_length)
        else:
            if self.mlp:
                self.proj_hidden_w, self.proj_hidden_b = _per_channel(
                    num_input_channels, d_model, d_model)
            self.proj_out_w, self.proj_out_b = _per_channel(
                num_input_channels, d_model, patch_length)

    def forward(self, embedding: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:                       # (B, C, P, patch_length)
        x = dropout(embedding, self.head_dropout, self.training, generator)
        if self.share:
            if self.mlp:
                x = self.act(self.proj_hidden(x))
            out = self.proj_out(x)
        else:
            if self.mlp:
                x = self.act(torch.einsum("bcpd,cde->bcpe", x, self.proj_hidden_w)
                             + self.proj_hidden_b[None, :, None, :])
            out = (torch.einsum("bcpd,cdl->bcpl", x, self.proj_out_w)
                   + self.proj_out_b[None, :, None, :])
        return out if self.log_input else F.relu(out)


class PredictHead(nn.Module):
    """CTC log-probs ``(B, P, vocab)``: the channels pooled (mean or max)
    before shared projections, or one projection per channel averaged
    after."""

    def __init__(self, c: Dict[str, Any], num_input_channels: int, d_model: int,
                 vocab_size: int):
        super().__init__()
        self.head_dropout = float(c.get("head_dropout", 0.0))
        self.share = bool(c.get("share_projection", True))
        self.pooling = c.get("pooling_type", "mean")
        self.mlp = bool(c.get("mlp_decoder"))
        self.act = ACT2FN[c.get("mlp_activation", "gelu")]
        if self.share:
            if self.pooling not in ("mean", "max"):
                raise ValueError(f"Unknown pooling {self.pooling!r}")
            if self.mlp:
                self.proj_hidden = nn.Linear(d_model, d_model)
            self.proj_out = nn.Linear(d_model, vocab_size)
        else:
            self.proj_out_w, self.proj_out_b = _per_channel(num_input_channels, d_model,
                                                            vocab_size)

    def forward(self, embedding: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = lambda t: dropout(t, self.head_dropout, self.training, generator)
        if self.share:
            pooled = embedding.mean(dim=1) if self.pooling == "mean" else embedding.amax(dim=1)
            x = drop(pooled)
            if self.mlp:
                x = self.act(self.proj_hidden(x))
            out = self.proj_out(x)
        else:
            per_channel = (torch.einsum("bcpd,cdv->bcpv", drop(embedding), self.proj_out_w)
                           + self.proj_out_b[None, :, None, :])
            out = per_channel.mean(dim=1)
        return F.log_softmax(out, dim=-1)


@register_model("PatchTST")
class PatchTSTForSpikingActivity(nn.Module):
    """PatchTST with the ``mlm`` or ``ctc`` head. ``mlm`` scores masked
    patches whose bins are all valid; ``ctc`` runs over ``1 + (len -
    patch_length) // patch_stride`` patches an example."""

    def __init__(self, config: Dict[str, Any], method_name: str, loss: str = "poisson_nll",
                 log_input: bool = True, vocab_size: int = 41, blank_id: int = 0,
                 zero_infinity: bool = True):
        super().__init__()
        enc, dec = config["encoder"], config["decoder"]
        if enc.get("from_pt") or dec.get("from_pt"):
            raise not_ported("Warm start from_pt", "Queue 1, slice 3, left")
        if method_name == "mlm" and not enc.get("do_mask_input"):
            raise ValueError("Can't pretrain with inactive masking")
        self.config = config
        self.method_name = method_name
        self.loss_name, self.log_input = loss, log_input
        self.blank_id, self.zero_infinity = blank_id, zero_infinity
        self.encoder = PatchTSTEncoder(enc)
        C, D = enc["num_input_channels"], enc["d_model"]
        if method_name == "mlm":
            self.decoder = PretrainHead(dec, C, D, enc["patch_length"], log_input)
        elif method_name == "ctc":
            self.decoder = PredictHead(dec, C, D, vocab_size)
        else:
            raise ValueError(f"Method {method_name} not implemented yet for PatchTST")

    @classmethod
    def from_config(cls, model_config, **method_kwargs) -> "PatchTSTForSpikingActivity":
        """Merge a trainer-style model config over ``configs/patchtst.yaml``."""
        cfg = update_config(resolve_path(DEFAULT_CONFIG), model_config)
        kwargs = {k: v for k, v in method_kwargs.items() if k in METHOD_KWARGS}
        return cls(config=to_plain_dict(cfg), **kwargs)

    def forward(
        self,
        spikes: torch.Tensor,                    # (B, T, C)
        spikes_mask: torch.Tensor,               # (B, T)
        spikes_lengths: Optional[torch.Tensor] = None,
        targets: Optional[torch.Tensor] = None,
        targets_lengths: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> PatchTSTOutput:
        enc = self.config["encoder"]
        pl, ps = enc["patch_length"], enc["patch_stride"]
        embedding, mask, patch_input = self.encoder(spikes, generator)
        with torch.autocast(spikes.device.type, enabled=False):
            preds = self.decoder(embedding, generator)
            if self.method_name == "mlm":
                # a patch is valid when all its bins are
                pm = patchify(spikes_mask[:, :, None].float(), pl, ps)[:, 0].prod(-1) > 0
                full_mask = mask & pm[:, None, :]                      # (B, C, P)
                if self.loss_name == "poisson_nll":
                    losses = poisson_nll_loss(preds, patch_input, log_input=self.log_input)
                elif self.loss_name == "mse":
                    losses = mse_loss(preds, patch_input)
                else:
                    raise ValueError(f"Loss {self.loss_name} not implemented yet for mlm")
                return PatchTSTOutput(
                    loss=(losses * full_mask[..., None]).sum(), n_examples=full_mask.sum(),
                    mask=full_mask.int(), preds=preds, targets=patch_input,
                    patch_input=patch_input)
            lens = torch.div(spikes_lengths - pl, ps, rounding_mode="floor") + 1
            loss = ctc_loss(preds, targets, lens, targets_lengths, self.blank_id,
                            self.zero_infinity).sum()
        return PatchTSTOutput(
            loss=loss, n_examples=torch.tensor(spikes.shape[0], dtype=torch.int32),
            preds=preds, targets=targets)
