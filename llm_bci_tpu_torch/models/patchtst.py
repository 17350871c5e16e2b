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

Dropout and masking draw from the ``generator`` passed in.

Sequence parallelism (``seq_shard``, :func:`patch_layout`): the patches are
split over ``sp`` in near-even parts, and a rank reads the bins of its
patches (at stride = length no bin twice). ``std`` / ``mean`` scaling takes
each series' statistics over the bins the ranks own, summed over ``sp``;
BatchNorm in training normalises by the batch statistics summed over the
ranks that hold the global batch (``batch_group``: ``data x sp``, ``sp`` or,
without a time shard, ``data``), with a gradient through them, and its
running averages move alike on every rank. The sincos rows are
the rank's patches', attention reads K / V gathered over ``sp``, the masking
noise and every dropout mask are drawn whole and sliced. The ``mlm`` head
gives the rank's part of the loss, its outputs holding its patches on dim 2;
``ctc`` gathers the log-probs over the patches and runs the CTC loss on all
of them on every rank.

Checkpoints (``models/components.py``): ``encoder.pt`` (with BatchNorm's
running averages), ``decoder.pt`` and both components' configs;
``encoder.from_pt`` and ``decoder.from_pt`` each warm-start their component.
A reference-format directory (``encoder.bin``: a Hugging Face
``PatchTSTModel`` state dict, q / k / v split where the port fuses ``qkv``,
``norm_sublayer{1,3}.batchnorm`` with its running statistics, the sincos
table as ``position_enc``; ``decoder.bin``: ``projection`` or
``projections.{c}``; the configs torch-pickled under ``.yaml`` names) is
imported by ``interop/torch_import.py``. The running averages are carried as
they are: the reference's BatchNorm moves them by 0.1 and the port's by 0.01.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from llm_bci_tpu_torch.config import resolve_path, to_plain_dict, update_config
from llm_bci_tpu_torch.interop.torch_import import patchtst_state_dict_from_reference
from llm_bci_tpu_torch.model_output import ModelOutput
from llm_bci_tpu_torch.models.components import ComponentCheckpoints, remerge_saved_configs
from llm_bci_tpu_torch.models.ndt1 import ACT2FN
from llm_bci_tpu_torch.ops.attention import TimeSlice, dot_product_attention, dropout
from llm_bci_tpu_torch.ops.ctc import ctc_loss
from llm_bci_tpu_torch.ops.losses import mse_loss, poisson_nll_loss
from llm_bci_tpu_torch.parallel.mesh import split_range
from llm_bci_tpu_torch.parallel.sequence import (
    SequenceShard,
    all_reduce_sum,
    gather_time,
    synced_batch_norm,
    synced_mean_var,
)
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


def patch_layout(T: int, n_sp: int, index: int, patch_length: int,
                 patch_stride: int) -> SequenceShard:
    """What ``sp`` rank ``index`` of ``n_sp`` computes of a sequence of ``T``
    bins (a pure function; the group is added by the caller): its patches,
    a near-even part of ``num_patches``; the bins it owns for the scaling
    statistics (``computed``: from its first patch's first bin to the next
    rank's, the last rank's to ``T``, so that the ranks' bins partition the
    sequence); and the bins it reads of each time-dim key, its patches' and
    its own."""
    P = num_patches(T, patch_length, patch_stride)
    if P < n_sp:
        raise ValueError(f"sequence parallelism: sp={n_sp} leaves a rank no patch of the {P} "
                         f"that T={T} bins give")
    bounds = tuple(split_range(P, n_sp, r)[0] for r in range(n_sp)) + (P,)
    p0, p1 = bounds[index], bounds[index + 1]
    own = (p0 * patch_stride, T if index == n_sp - 1 else p1 * patch_stride)
    read = (own[0], max(own[1], (p1 - 1) * patch_stride + patch_length))
    return SequenceShard(n_sp=n_sp, index=index, bins=T, tokens=P, real_tokens=P,
                         bounds=bounds, computed=own,
                         slices={"spikes": read, "spikes_mask": read, "spikes_timestamp": read})


def patch_noise(shape: Tuple[int, int, int], channel_consistent: bool,
                generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform noise ``(B, C, P)`` that ranks the patches for masking, one row
    for all channels of an example when ``channel_consistent``."""
    B, C, P = shape
    noise = torch.rand((B, 1 if channel_consistent else C, P), generator=generator,
                       device=device)
    return noise.expand(B, C, P)


def random_patch_masking(patches: torch.Tensor, noise: torch.Tensor, mask_ratio: float,
                         mask_value: float, start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask the patches whose noise ranks at or past ``int(P * (1 - ratio))``
    among their (example, channel)'s; returns (masked patches, mask), the
    mask True on masked patches. ``noise`` covers all P patches; ``patches``
    may be a part of them that starts at patch ``start``."""
    P = noise.shape[2]
    len_keep = int(P * (1 - mask_ratio))
    ranks = noise.argsort(dim=-1, stable=True).argsort(dim=-1, stable=True)
    mask = (ranks >= len_keep)[:, :, start:start + patches.shape[2]]
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

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """With ``group`` in training, the batch statistics are those of the
        rows of every rank of the group (their rows and patches make up the
        global batch); the running averages move by them alike on every
        rank."""
        shape = x.shape
        x2d = x.float().reshape(-1, shape[-1])
        if self.training and group is not None:
            out, mean, var = synced_batch_norm(x2d, self.weight, self.bias, self.eps, group)
            self._move_averages(mean, var)
        elif self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x2d, dim=0, unbiased=False)
            self._move_averages(mean, var)
            out = F.batch_norm(x2d, None, None, self.weight, self.bias, True, 0.0, self.eps)
        else:
            out = F.batch_norm(x2d, self.running_mean, self.running_var, self.weight,
                               self.bias, False, 0.0, self.eps)
        return out.reshape(shape)

    @torch.no_grad()
    def _move_averages(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.MOMENTUM
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)


class PatchTSTNorm(nn.Module):
    """``batchnorm`` (:class:`FlaxBatchNorm` over ``d_model``) or ``layernorm``,
    in float32."""

    def __init__(self, norm_type: str, d_model: int, eps: float = 1e-5):
        super().__init__()
        if norm_type == "batchnorm":
            self.bn = FlaxBatchNorm(d_model, eps)
        else:
            self.ln = nn.LayerNorm(d_model, eps=eps)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return self.bn(x, group) if hasattr(self, "bn") else self.ln(x.float())


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

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                seq_shard: Optional[SequenceShard] = None, batch_group=None) -> torch.Tensor:
        """With ``seq_shard`` ``x`` holds the rank's patches (dim 1); the
        norms' batch statistics are taken over ``batch_group``."""
        time = None if seq_shard is None else seq_shard.token_time
        drop = lambda t, rate: dropout(t, rate, self.training, generator, time)
        norm1 = lambda h: self.norm1(h, batch_group)
        norm2 = lambda h: self.norm2(h, batch_group)

        def attn_block(h):
            BC, P, D = h.shape
            shape = (BC, P, self.n_heads, D // self.n_heads)
            q, k, v = (t.reshape(shape) for t in self.qkv(h).chunk(3, dim=-1))
            if seq_shard is not None:
                k, v = gather_time(k, seq_shard), gather_time(v, seq_shard)
            out = dot_product_attention(q, k, v).reshape(BC, P, D)
            return self.attn_out(drop(out, self.attn_drop))

        def ff_block(h):
            return self.ff2(drop(self.act(self.ff1(h)), self.ff_drop))

        if self.pre_norm:
            x = x + drop(attn_block(norm1(x)), self.path_drop)
            return x + drop(ff_block(norm2(x)), self.path_drop)
        x = norm1(x + drop(attn_block(x), self.path_drop))
        return norm2(x + drop(ff_block(x), self.path_drop))


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
        self._pe_on_device: Dict[tuple, torch.Tensor] = {}
        self.patch_embed = nn.Linear(c["patch_length"], c["d_model"], bias=c.get("bias", True))
        self.layers = nn.ModuleList(
            PatchTSTEncoderLayer(c) for _ in range(c["num_hidden_layers"]))

    def _scale(self, spikes: torch.Tensor, seq_shard: Optional[SequenceShard]
               ) -> torch.Tensor:
        """``std`` / ``mean`` scaling over time; with ``seq_shard`` each
        series' statistics over the bins the ranks own, summed over ``sp``."""
        scaling = self.config.get("scaling")
        if scaling not in ("std", "mean"):
            return spikes
        if seq_shard is None:
            if scaling == "std":
                std, mean = torch.std_mean(spikes, dim=1, keepdim=True, correction=0)
                return (spikes - mean) / (std + 1e-5)
            return spikes / (spikes.abs().mean(dim=1, keepdim=True) + 1e-5)
        lo = seq_shard.slices["spikes"][0]
        own = spikes[:, seq_shard.computed[0] - lo:seq_shard.computed[1] - lo]
        if scaling == "std":
            mean, var, _ = synced_mean_var(own, (1,), seq_shard.group)
            return (spikes - mean) / (var.sqrt() + 1e-5)
        total = all_reduce_sum(own.abs().sum(dim=1, keepdim=True), seq_shard.group)
        return spikes / (total / seq_shard.bins + 1e-5)

    def _position_encoding(self, P: int, D: int, p0: int, Pr: int, like: torch.Tensor
                           ) -> torch.Tensor:
        """Rows ``p0:p0 + Pr`` of the sincos table on ``like``'s device,
        copied there once a shape: a train step that a CUDA graph holds
        copies nothing from the host. A trace (``torch.export``'s fake
        tensors) makes its own copy."""
        table = lambda: torch.tensor(sincos_position_encoding(P, D)[p0:p0 + Pr],
                                     device=like.device)
        if type(like) is not torch.Tensor:
            return table()
        key = (P, D, p0, Pr, str(like.device))
        if key not in self._pe_on_device:
            self._pe_on_device[key] = table()
        return self._pe_on_device[key]

    def forward(self, spikes: torch.Tensor, generator: Optional[torch.Generator] = None,
                seq_shard: Optional[SequenceShard] = None, batch_group=None):
        """With ``seq_shard`` ``spikes`` holds the bins of
        ``seq_shard.slices["spikes"]``, and out come the rank's patches;
        ``batch_group``: see :meth:`PatchTSTForSpikingActivity.forward`."""
        c = self.config
        B, T, C = spikes.shape
        spikes = self._scale(spikes, seq_shard)
        patches = patchify(spikes, c["patch_length"], c["patch_stride"])   # (B, C, P, L)
        P, p0 = patches.shape[2], 0
        if seq_shard is not None:
            (p0, p1), P = seq_shard.token_range, seq_shard.tokens
            patches = patches[:, :, :p1 - p0]
        patch_input = patches
        mask = None
        if c.get("do_mask_input"):
            if self.training:
                noise = patch_noise((B, C, P), bool(c.get("channel_consistent_masking", False)),
                                    generator, spikes.device)
                patches, mask = random_patch_masking(
                    patches, noise, float(c["random_mask_ratio"]), float(c.get("mask_value", 0)),
                    start=p0)
            else:
                mask = torch.zeros(patches.shape[:3], dtype=torch.bool, device=spikes.device)

        x = self.patch_embed(patches)
        Pr, D = x.shape[2], x.shape[3]
        pe = self._position_encoding(P, D, p0, Pr, x)
        x = dropout(x + pe, float(c.get("positional_dropout", 0.0)), self.training, generator,
                    None if seq_shard is None else seq_shard.token_time, dim=2)
        x = x.reshape(B * C, Pr, D)
        for layer in self.layers:
            x = layer(x, generator, seq_shard, batch_group)
        return x.reshape(B, C, Pr, D).float(), mask, patch_input


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

    def forward(self, embedding: torch.Tensor, generator: Optional[torch.Generator] = None,
                time: Optional[TimeSlice] = None) -> torch.Tensor:   # (B, C, P, patch_length)
        x = dropout(embedding, self.head_dropout, self.training, generator, time, dim=2)
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

    def forward(self, embedding: torch.Tensor, generator: Optional[torch.Generator] = None,
                time: Optional[TimeSlice] = None) -> torch.Tensor:
        drop = lambda t, dim: dropout(t, self.head_dropout, self.training, generator, time, dim)
        if self.share:
            pooled = embedding.mean(dim=1) if self.pooling == "mean" else embedding.amax(dim=1)
            x = drop(pooled, 1)
            if self.mlp:
                x = self.act(self.proj_hidden(x))
            out = self.proj_out(x)
        else:
            per_channel = (torch.einsum("bcpd,cdv->bcpv", drop(embedding, 2), self.proj_out_w)
                           + self.proj_out_b[None, :, None, :])
            out = per_channel.mean(dim=1)
        return F.log_softmax(out, dim=-1)


@register_model("PatchTST")
class PatchTSTForSpikingActivity(ComponentCheckpoints, nn.Module):
    """PatchTST with the ``mlm`` or ``ctc`` head. ``mlm`` scores masked
    patches whose bins are all valid; ``ctc`` runs over ``1 + (len -
    patch_length) // patch_stride`` patches an example."""

    def __init__(self, config: Dict[str, Any], method_name: str, loss: str = "poisson_nll",
                 log_input: bool = True, vocab_size: int = 41, blank_id: int = 0,
                 zero_infinity: bool = True):
        super().__init__()
        enc, dec = config["encoder"], config["decoder"]
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
        """Merge a trainer-style model config over ``configs/patchtst.yaml``,
        and the config saved beside each component's ``from_pt`` over that."""
        cfg = update_config(resolve_path(DEFAULT_CONFIG), model_config)
        remerge_saved_configs(cfg, ("encoder", "decoder"))
        kwargs = {k: v for k, v in method_kwargs.items() if k in METHOD_KWARGS}
        return cls(config=to_plain_dict(cfg), **kwargs)

    def reference_state(self, load_dir, components):
        return patchtst_state_dict_from_reference(load_dir, self, components)

    def sequence_layout(self, T: int, n_sp: int, index: int) -> SequenceShard:
        """What ``sp`` rank ``index`` of ``n_sp`` computes of a batch of ``T``
        bins (:func:`patch_layout` at this model's patch length and stride)."""
        enc = self.config["encoder"]
        return patch_layout(T, n_sp, index, enc["patch_length"], enc["patch_stride"])

    def sequence_outputs(self) -> Tuple[Dict[str, int], bool]:
        """``mlm``: the rank's patches of ``preds`` / ``targets`` / ``mask`` /
        ``patch_input`` (dim 2) and its part of the loss; ``ctc``: the
        gathered log-probs and the whole loss on every rank."""
        if self.method_name == "mlm":
            return {"preds": 2, "targets": 2, "mask": 2, "patch_input": 2}, True
        return {}, False

    def forward(
        self,
        spikes: torch.Tensor,                    # (B, T, C)
        spikes_mask: torch.Tensor,               # (B, T)
        spikes_lengths: Optional[torch.Tensor] = None,
        targets: Optional[torch.Tensor] = None,
        targets_lengths: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        seq_shard: Optional[SequenceShard] = None,
        batch_group=None,
    ) -> PatchTSTOutput:
        """``batch_group``: the process group whose ranks' rows (and, with
        ``seq_shard``, time parts) make up the global batch; BatchNorm's
        training statistics are taken over it, as the JAX trainer's program
        takes them over the global batch (``None``: this rank holds it
        whole)."""
        enc = self.config["encoder"]
        pl, ps = enc["patch_length"], enc["patch_stride"]
        embedding, mask, patch_input = self.encoder(spikes, generator, seq_shard, batch_group)
        with torch.autocast(spikes.device.type, enabled=False):
            preds = self.decoder(embedding, generator,
                                 None if seq_shard is None else seq_shard.token_time)
            if self.method_name == "mlm":
                # a patch is valid when all its bins are
                pm = patchify(spikes_mask[:, :, None].float(), pl, ps)[:, 0].prod(-1) > 0
                full_mask = mask & pm[:, None, :embedding.shape[2]]    # (B, C, P)
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
            if seq_shard is not None:
                preds = gather_time(preds, seq_shard)
            lens = torch.div(spikes_lengths - pl, ps, rounding_mode="floor") + 1
            loss = ctc_loss(preds, targets, lens, targets_lengths, self.blank_id,
                            self.zero_infinity).sum()
        return PatchTSTOutput(
            loss=loss, n_examples=torch.tensor(spikes.shape[0], dtype=torch.int32),
            preds=preds, targets=targets)
