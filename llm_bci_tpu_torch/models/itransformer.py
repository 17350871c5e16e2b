"""iTransformer — channels as tokens over binned spikes, with the ``mlm``,
``ctc``, ``dyn_behaviour`` and ``stat_behaviour`` heads (counterpart of
``llm_bci_tpu/models/itransformer.py``).

Each channel's time series is one token: an MLP over the (padded) time axis
(``embedder.mode: mlp``) or a per-channel transformer with a CLS readout
(``mode: transformer``, the channels folded into the batch), plus
LayerNorm'd channel, region and depth embeddings, an optional CLS token and
the post-LN stack of :mod:`llm_bci_tpu_torch.models.layers`. Region names
never reach the device: :func:`region_names_to_idx` adds integer columns on
the host, and the CLI's region vocabulary also feeds the maskers.

The encoder returns float32; the heads run in float32 outside autocast, so
the ``ctc`` head hands the CTC kernels float32 log-probs of its own. Maskers,
dropout and noise draw from the ``generator`` passed in. ``from_pt`` warm
start raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from llm_bci_tpu_torch import not_ported
from llm_bci_tpu_torch.config import resolve_path, to_plain_dict, update_config
from llm_bci_tpu_torch.model_output import ModelOutput
from llm_bci_tpu_torch.models.layers import LN_EPS, MLPStack, TorchEncoderStack
from llm_bci_tpu_torch.models.masker import MaskerConfig, apply_maskers
from llm_bci_tpu_torch.models.ndt1 import ACT2FN
from llm_bci_tpu_torch.ops.attention import dropout
from llm_bci_tpu_torch.ops.ctc import ctc_loss
from llm_bci_tpu_torch.ops.losses import cross_entropy_loss, mse_loss, poisson_nll_loss
from llm_bci_tpu_torch.registry import register_model

DEFAULT_CONFIG = "configs/itransformer.yaml"
METHOD_KWARGS = ("method_name", "loss", "log_input", "vocab_size", "blank_id",
                 "zero_infinity", "n_labels")


class iTransformerOutput(ModelOutput):
    pass


def region_names_to_idx(rows: List[Dict[str, Any]], regions: List[str]) -> None:
    """Add an int32 ``neuron_regions_idx`` column, the index in ``regions`` of
    each channel's region name, to every row that has ``neuron_regions``."""
    r_to_i = {r: i for i, r in enumerate(regions)}
    for row in rows:
        if "neuron_regions" in row and "neuron_regions_idx" not in row:
            row["neuron_regions_idx"] = np.asarray(
                [r_to_i[str(r)] for r in row["neuron_regions"]], dtype=np.int32
            )


def _normal_param(*shape: int) -> nn.Parameter:
    """A table drawn from N(0, 1) (flax ``normal(1.0)``)."""
    return nn.Parameter(torch.randn(*shape))


class UnivariateTransformer(nn.Module):
    """Per-channel time-series transformer with a CLS readout: B*N sequences
    of 1 + T tokens, the CLS output of each."""

    def __init__(self, hidden_size: int, n_heads: int, n_layers: int, act_name: str,
                 dropout: float, max_n_bins: int):
        super().__init__()
        self.act = ACT2FN[act_name]
        self.embed_in = nn.Linear(1, hidden_size)
        self.embed_out = nn.Linear(hidden_size, hidden_size)
        self.embed_pos = _normal_param(max_n_bins, hidden_size)
        self.cls_embed = _normal_param(1, hidden_size)
        self.transformer = TorchEncoderStack(hidden_size, n_heads, n_layers, self.act, dropout)

    def forward(self, spikes: torch.Tensor, spikes_timestamp: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, N = spikes.shape
        H = self.embed_pos.shape[1]
        h = self.embed_out(self.act(self.embed_in(spikes[..., None])))      # (B, T, N, H)
        if spikes_timestamp is None:
            spikes_timestamp = torch.arange(T, device=spikes.device).expand(B, T)
        h = h + self.embed_pos[spikes_timestamp.long()][:, :, None, :]
        h = h.permute(0, 2, 1, 3)                                           # (B, N, T, H)
        cls = self.cls_embed.to(h.dtype).expand(B, N, 1, H)
        h = torch.cat([cls, h], dim=2).reshape(B * N, T + 1, H)
        h = self.transformer(h, generator=generator)
        return h.reshape(B, N, T + 1, H)[:, :, 0, :]


class iTransformerEncoder(nn.Module):
    """Per-channel embedding, the channel / region / depth embeddings, an
    optional CLS token and the transformer; returns float32
    ``(B, [1+]N, hidden)``."""

    def __init__(self, config: Dict[str, Any], use_cls: bool):
        super().__init__()
        emb = config["embedder"]
        H = config["hidden_size"]
        self.mode = emb["mode"]
        self.act = ACT2FN[config["activation"]]
        self.embed_dropout = emb["dropout"]
        self.use_cls = use_cls
        if self.mode == "mlp":
            # over the time axis, padded to max_n_bins
            self.embed_mlp = MLPStack(emb["max_n_bins"], (H, H), self.act, emb["dropout"],
                                      use_bias=config["bias"])
            self.embed_norm = nn.LayerNorm(H, eps=LN_EPS)
        elif self.mode == "transformer":
            self.embed_univariate = UnivariateTransformer(
                emb["hidden_size"], emb["n_heads"], emb["n_layers"], emb["activation"],
                emb["dropout"], emb["max_n_bins"],
            )
            self.embed_proj = nn.Linear(emb["hidden_size"], H)
            self.embed_proj_norm = nn.LayerNorm(H, eps=LN_EPS)
        else:
            raise ValueError(f"Unknown embedder mode {self.mode!r}")
        self.channel_embeddings = None
        if config["max_n_channels"] != 0:
            self.channel_embeddings = _normal_param(config["max_n_channels"], H)
            self.channel_norm = nn.LayerNorm(H, eps=LN_EPS)
        self.region_embeddings = None
        if config["embed_region"]:
            self.region_embeddings = _normal_param(max(len(config["regions"] or []), 1), H)
            self.region_norm = nn.LayerNorm(H, eps=LN_EPS)
        self.embed_depth = bool(config["embed_depth"])
        if self.embed_depth:
            self.depth_in = nn.Linear(1, H)
            self.depth_out = nn.Linear(H, H)
            self.depth_norm = nn.LayerNorm(H, eps=LN_EPS)
        if use_cls:
            self.cls_embed = _normal_param(1, H)
        self.transformer = TorchEncoderStack(H, config["n_heads"], config["n_layers"], self.act,
                                             config["dropout"])

    def forward(self, spikes: torch.Tensor, spikes_timestamp: Optional[torch.Tensor],
                spikes_spacestamp: Optional[torch.Tensor],
                neuron_regions_idx: Optional[torch.Tensor],
                neuron_depths: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, N = spikes.shape
        if self.mode == "mlp":
            tokens = self.embed_norm(self.embed_mlp(spikes.transpose(1, 2), generator))
        else:
            u = self.embed_univariate(spikes, spikes_timestamp, generator)
            tokens = self.embed_proj_norm(self.embed_proj(u))
        if self.channel_embeddings is not None:
            if spikes_spacestamp is None:
                spikes_spacestamp = torch.arange(N, device=spikes.device)[None, :]
            tokens = tokens + self.channel_norm(self.channel_embeddings[spikes_spacestamp.long()])
        if self.region_embeddings is not None:
            if neuron_regions_idx is None:
                raise ValueError("embed_region needs a neuron_regions_idx batch column")
            tokens = tokens + self.region_norm(self.region_embeddings[neuron_regions_idx.long()])
        if self.embed_depth:
            if neuron_depths is None:
                raise ValueError("embed_depth needs a neuron_depths batch column")
            d = self.depth_out(self.act(self.depth_in(neuron_depths[..., None].float())))
            tokens = tokens + self.depth_norm(d)
        if self.use_cls:
            cls = self.cls_embed.to(tokens.dtype).expand(B, 1, -1)
            tokens = torch.cat([cls, tokens], dim=1)
        tokens = dropout(tokens, self.embed_dropout, self.training, generator)
        return self.transformer(tokens, generator=generator).float()


@register_model("iTransformer")
class iTransformer(nn.Module):
    """iTransformer with a method head: ``mlm`` (reconstruct each channel's
    bins), ``ctc`` (one Linear to ``vocab * max_n_bins`` outputs, reshaped,
    log-softmax), ``dyn_behaviour`` (a trace of ``max_n_bins``) or
    ``stat_behaviour`` (``n_labels`` logits under ``xent``, else one value).
    Without CLS the behaviour and ``ctc`` heads read the sum over channel
    tokens."""

    def __init__(self, config: Dict[str, Any], method_name: str, loss: str = "poisson_nll",
                 log_input: bool = True, vocab_size: int = 41, blank_id: int = 0,
                 zero_infinity: bool = True, n_labels: int = 2):
        super().__init__()
        enc, dec = config["encoder"], config["decoder"]
        if enc.get("from_pt") or dec.get("from_pt"):
            raise not_ported("Warm start from_pt", "Queue 1, slice 3, left")
        self.config = config
        self.method_name = method_name
        self.loss_name, self.log_input = loss, log_input
        self.blank_id, self.zero_infinity = blank_id, zero_infinity
        self.vocab_size, self.n_labels = vocab_size, n_labels
        regions = enc.get("regions") or []
        r_to_i = {r: i for i, r in enumerate(regions)}
        self.masker_cfgs = tuple(
            MaskerConfig.from_config(m, region_to_id=r_to_i)
            for m in (config.get("masker") or {}).values()
        )
        self.use_cls = dec["use_cls"]
        self.encoder = iTransformerEncoder(enc, self.use_cls)

        max_n_bins = enc["embedder"]["max_n_bins"]
        if method_name in ("mlm", "dyn_behaviour"):
            n_outputs = max_n_bins
        elif method_name == "ctc":
            n_outputs = vocab_size * max_n_bins
        elif method_name == "stat_behaviour":
            n_outputs = n_labels if loss == "xent" else 1
        else:
            raise ValueError(f"Method {method_name} not implemented")
        self.max_n_bins = max_n_bins
        H = enc["hidden_size"]
        self.decoder_act = ACT2FN[dec["activation"]]
        self.decoder_hidden = nn.Linear(H, H) if dec["mlp_decoder"] else None
        self.decoder_out = nn.Linear(H, n_outputs)

    @classmethod
    def from_config(cls, model_config, **method_kwargs) -> "iTransformer":
        """Merge a trainer-style model config over ``configs/itransformer.yaml``."""
        cfg = update_config(resolve_path(DEFAULT_CONFIG), model_config)
        kwargs = {k: v for k, v in method_kwargs.items() if k in METHOD_KWARGS}
        return cls(config=to_plain_dict(cfg), **kwargs)

    def _decode(self, x: torch.Tensor) -> torch.Tensor:
        """The head, in float32 outside autocast."""
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            if self.method_name != "mlm" and not self.use_cls:
                x = x.sum(dim=1)          # AverageTokens: the sum over channel tokens
            if self.decoder_hidden is not None:
                x = self.decoder_act(self.decoder_hidden(x))
            preds = self.decoder_out(x)
            if self.method_name == "mlm" and not self.log_input:
                preds = F.relu(preds)
            if self.method_name == "ctc":
                preds = preds.reshape(*preds.shape[:-1], self.max_n_bins, self.vocab_size)
                preds = F.log_softmax(preds, dim=-1)
        return preds

    def forward(
        self,
        spikes: torch.Tensor,                     # (B, T, N)
        spikes_mask: torch.Tensor,                # (B, T)
        spikes_timestamp: torch.Tensor,           # (B, T)
        spikes_spacestamp: Optional[torch.Tensor] = None,   # (B, N)
        spikes_lengths: Optional[torch.Tensor] = None,      # (B,)
        targets: Optional[torch.Tensor] = None,
        targets_lengths: Optional[torch.Tensor] = None,
        neuron_regions_idx: Optional[torch.Tensor] = None,  # (B, N)
        neuron_depths: Optional[torch.Tensor] = None,       # (B, N)
        masker_overrides: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> iTransformerOutput:
        method = self.method_name
        if method == "mlm":
            targets = spikes
        spikes, targets_mask = apply_maskers(
            self.masker_cfgs, spikes, generator, self.training,
            neuron_regions_idx=neuron_regions_idx, overrides=masker_overrides,
        )
        x = self.encoder(spikes, spikes_timestamp, spikes_spacestamp, neuron_regions_idx,
                         neuron_depths, generator)
        if self.use_cls:
            x = x[:, 1:, :] if method == "mlm" else x[:, 0, :]
        preds = self._decode(x)

        if method == "mlm":
            preds = preds.transpose(1, 2)                       # (B, T, N)
            tmask = targets_mask & spikes_mask[:, :, None].to(targets_mask.dtype)
            if self.loss_name == "poisson_nll":
                losses = poisson_nll_loss(preds, targets, log_input=self.log_input)
            elif self.loss_name == "mse":
                losses = mse_loss(preds, targets)
            else:
                raise ValueError(f"Loss {self.loss_name} not implemented yet for mlm")
            return iTransformerOutput(loss=(losses * tmask).sum(), n_examples=tmask.sum(),
                                      preds=preds, targets=targets, mask=tmask)
        if method == "dyn_behaviour":
            loss = (mse_loss(preds, targets) * spikes_mask).sum()
            return iTransformerOutput(loss=loss, n_examples=spikes_mask.sum(), preds=preds,
                                      targets=targets, mask=spikes_mask)
        if method == "stat_behaviour":
            if self.loss_name == "xent":
                loss = cross_entropy_loss(preds, targets[:, 0].long()).sum()
            else:
                loss = mse_loss(preds[:, 0], targets[:, 0]).sum()
            return iTransformerOutput(
                loss=loss, n_examples=torch.tensor(targets.shape[0], dtype=torch.int32),
                preds=preds, targets=targets)
        # ctc: preds (B, max_n_bins, vocab); the input lengths are the
        # unpadded spike lengths, as in the JAX package
        with torch.autocast(preds.device.type, enabled=False):
            loss = ctc_loss(preds, targets, spikes_lengths, targets_lengths, self.blank_id,
                            self.zero_infinity).sum()
        return iTransformerOutput(loss=loss, n_examples=targets_lengths.sum(), preds=preds,
                                  targets=targets)
