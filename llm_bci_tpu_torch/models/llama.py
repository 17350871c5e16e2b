"""Llama decoder stack — the BCI workload's LLM trunk (counterpart of
``llm_bci_tpu/models/llama.py``).

* Module and parameter names are Hugging Face's (``model.embed_tokens``,
  ``model.layers.{i}.self_attn.q_proj`` ..., ``model.norm``, ``lm_head``), so
  a HF checkpoint's ``state_dict`` loads by name (:func:`load_hf_llama_params`).
* LoRA is a pair of factored parameters on selected projections
  (:class:`LoRADense`, ``lora_A`` (in, r) and ``lora_B`` (r, out) as in the
  JAX package). The frozen / trainable split is ``requires_grad``: with LoRA
  or ``freeze_base`` every base leaf is frozen and **stored in the compute
  dtype** (no float32 master copy, no per-step cast); without, base leaves
  are float32 parameters cast to the compute dtype at use.
* ``quant="int8"`` (or ``"int8_xla"``: same storage, same path here) stores a
  frozen projection as the buffers ``kernel`` int8 (in, out) and
  ``kernel_scale`` float32 (out,); every product with it goes through
  :func:`llm_bci_tpu_torch.ops.quant.int8_matmul`, which launches the
  hand-written CUDA kernel on a CUDA tensor.
* Grouped-query attention through ``ops.attention.dot_product_attention``;
  RMSNorm computes in float32; logits leave as float32.
* The KV cache is a tuple of ``{"k", "v"}`` buffers a layer, **updated in
  place** at ``cache_index`` and handed back for the JAX package's call shape.
  ``cache_index`` is a Python int (prefill, training, every eager caller) or a
  0-dim int64 tensor on the model's device (a decode token step, the JAX
  package's traced index): then the KV write is an ``index_copy_`` at
  ``cache_index + arange(T)`` and positions and mask are built on the device,
  so nothing reads the position back and a CUDA graph of the step replays at
  whatever position the tensor holds (``models/decode_graph.py``).
* Every leaf is created directly on ``device`` in its storage dtype, drawn
  from ``generator``: a 7B base never exists in float32 or on the host.
* Tensor parallelism (``parallel/tensor_parallel.py::apply_tp_plan``) cuts
  the projections to a rank's share in place: a ``LoRADense`` then holds its
  ``tp`` role, an attention layer its local head counts, and the KV cache of
  :meth:`LlamaForCausalLM.init_cache` this rank's key/value heads.
* ``remat=True`` recomputes each decoder layer in the backward
  (``models/remat.py``), LoRA dropout drawn again from the same generator
  state; a forward without autograd (eval, decoding) runs the layers plainly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from llm_bci_tpu_torch.models.remat import remat_call
from llm_bci_tpu_torch.ops.attention import TimeSlice, dot_product_attention, dropout
from llm_bci_tpu_torch.ops.quant import (
    QUANT_MODES,
    dequantize_int8,
    int8_matmul,
    quantize_int8,
)
from llm_bci_tpu_torch.ops.rotary import apply_rotary_pos_emb, rope_cos_sin
from llm_bci_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp,
    reduce_from_tp,
    sum_grad_over_tp,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @property
    def n_kv(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def debug(cls) -> "LlamaConfig":
        """Tiny config: 2 layers / 32 hidden / 4 heads."""
        return cls(vocab_size=32000, hidden_size=32, intermediate_size=32,
                   num_hidden_layers=2, num_attention_heads=4)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LlamaConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# Scale of an int8 layer initialized from scratch: +-4 sigma of the
# normal(0.02) init maps onto the int8 range.
_INT8_INIT_SCALE = 0.02 * 4.0 / 127.0


def _normal(shape, std: float, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """float32 normal(0, std) on ``device`` from ``generator`` (drawn on the
    generator's own device when the two differ)."""
    draw_on = generator.device if generator is not None else device
    return (torch.randn(shape, generator=generator, device=draw_on) * std).to(device)


class RMSNorm(nn.Module):
    """``w * x / sqrt(mean(x^2) + eps)`` in float32, returned in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, trainable: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device), requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * h).to(x.dtype)


class LoRADense(nn.Module):
    """Dense with optional LoRA adapter: ``y = xW + (alpha / r) * drop(x) A B``.

    The base is ``weight`` (out, in), or with ``quant`` the int8 buffers
    ``kernel`` (in, out) + ``kernel_scale`` (out,). A base under LoRA or
    ``freeze_base`` takes no gradient and is stored in ``dtype``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False, r: int = 0,
                 alpha: float = 32.0, lora_dropout: float = 0.0, freeze_base: bool = False,
                 dtype: torch.dtype = torch.bfloat16, quant: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.r, self.alpha, self.lora_dropout = r, alpha, lora_dropout
        self.dtype, self.quant = dtype, quant
        frozen = r > 0 or freeze_base
        store = dtype if frozen else torch.float32
        if quant is not None:
            if quant not in QUANT_MODES:
                raise ValueError(f"unknown quant mode {quant!r}")
            if not frozen:
                raise ValueError("quant='int8' requires a frozen base (LoRA or freeze)")
            w = _normal((in_features, features), 0.02 / _INT8_INIT_SCALE, device, generator)
            self.register_buffer("kernel", w.round_().clamp_(-127, 127).to(torch.int8))
            self.register_buffer(
                "kernel_scale",
                torch.full((features,), _INT8_INIT_SCALE, dtype=torch.float32, device=device))
        else:
            w = _normal((features, in_features), 0.02, device, generator)
            self.weight = nn.Parameter(w.to(store), requires_grad=not frozen)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features, dtype=store, device=device),
                                     requires_grad=not frozen)
        else:
            self.bias = None
        if r > 0:
            self.lora_A = nn.Parameter(_normal((in_features, r), 1.0 / r, device, generator))
            self.lora_B = nn.Parameter(torch.zeros((r, features), device=device))
        # Set by parallel/tensor_parallel.py::shard_dense: this rank's share
        # of a column- or row-parallel projection.
        self.tp = None
        # Set by training/distributed.py when this module is an FSDP2 group
        # of its own: its forward's end frees its whole parameters, so the
        # factors it hands out deferred must be copies, not views.
        self.copy_deferred = False

    def lora_factors(self):
        """``(A, B)`` in the compute dtype; under tensor parallelism the
        slice of the whole factor that this rank's share uses (``B``'s
        columns of a column-parallel projection, ``A``'s rows of a
        row-parallel one), the gradient summed over ``tp``."""
        a, b = self.lora_A, self.lora_B
        if self.tp is not None:
            a, b = sum_grad_over_tp(a, self.tp.group), sum_grad_over_tp(b, self.tp.group)
            n = self.tp.stop - self.tp.start
            if self.tp.role == "column":
                b = b.narrow(1, self.tp.start, n)
            else:
                a = a.narrow(0, self.tp.start, n)
        return a.to(self.dtype), b.to(self.dtype)

    def forward(self, x: torch.Tensor, defer_lora: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.quant is not None:
            y = int8_matmul(x, self.kernel, self.kernel_scale, out_dtype=self.dtype)
        else:
            y = F.linear(x, self.weight.to(self.dtype))
        row = self.tp is not None and self.tp.role == "row"
        if self.bias is not None and not row:
            y = y + self.bias.to(self.dtype)
        if self.r > 0:
            a, b = self.lora_factors()
            if defer_lora:
                # The caller applies the adapter grouped with its siblings
                # (apply_lora_group); the parameters stay under this module.
                if self.copy_deferred:
                    a, b = a.clone(), b.clone()
                return y, a, b
            # a row-parallel share of the input features takes its part of
            # the whole input's keep mask, as one device draws it
            part = TimeSlice(self.in_features, self.tp.start) if row else None
            h = dropout(x, self.lora_dropout, self.training, generator, part, dim=-1)
            y = y + (self.alpha / self.r) * ((h @ a) @ b)
        if row:
            # the partial products of the rank's input features, summed
            y = reduce_from_tp(y, self.tp.group)
            if self.bias is not None:
                y = y + self.bias.to(self.dtype)
        if defer_lora:
            return y, None, None
        return y


def apply_lora_group(x: torch.Tensor, deferred: Sequence, *, alpha: float, r: int,
                     dropout_fn=None):
    """The LoRA deltas of several projections of one input as one pair of
    products: ``h = drop(x) @ [A_1 ... A_g]``, ``delta = h @ blockdiag(B_1 ...
    B_g)``, split back per projection. Under ``lora_dropout > 0`` in training
    the group shares one keep mask of the input (peft draws one per adapter:
    the JAX package's documented deviation, same marginal rate)."""
    loras = [(i, a, b) for i, (_, a, b) in enumerate(deferred) if a is not None]
    outs = [y for y, _, _ in deferred]
    if not loras:
        return outs
    h = x if dropout_fn is None else dropout_fn(x)
    if len(loras) == 1:
        i, a, b = loras[0]
        outs[i] = outs[i] + (alpha / r) * ((h @ a) @ b)
        return outs
    a_cat = torch.cat([a for _, a, _ in loras], dim=1)             # (H, g*r)
    b_bd = torch.block_diag(*[b for _, _, b in loras])             # (g*r, sum F)
    delta = (alpha / r) * ((h @ a_cat) @ b_bd)
    off = 0
    for i, _, b in loras:
        f = b.shape[1]
        outs[i] = outs[i] + delta[..., off:off + f]
        off += f
    return outs


def make_causal_padding_mask(
    attention_mask: torch.Tensor,    # (B, S) 1 = valid keys
    q_len: int,
    q_offset=0,                      # int, or a 0-dim int64 tensor on the mask's device
) -> torch.Tensor:                   # (B, 1, q_len, S) bool
    """Query at absolute position ``q_offset + i`` may attend to key ``j``
    iff ``j <= q_offset + i`` and key ``j`` is valid."""
    S = attention_mask.shape[1]
    dev = attention_mask.device
    j = torch.arange(S, device=dev)[None, :]
    i = torch.arange(q_len, device=dev)[:, None] + q_offset
    mask = (j <= i)[None, :, :] & attention_mask.bool()[:, None, :]
    return mask[:, None, :, :]


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What every projection of one model shares."""
    lora_r: int
    lora_alpha: float
    lora_dropout: float
    lora_targets: Tuple[str, ...]
    freeze_base: bool
    dtype: torch.dtype
    quant: Optional[str]
    device: Any
    generator: Optional[torch.Generator]

    def proj(self, name: str, n_in: int, n_out: int) -> LoRADense:
        return LoRADense(
            n_in, n_out, r=self.lora_r if name in self.lora_targets else 0,
            alpha=self.lora_alpha, lora_dropout=self.lora_dropout,
            freeze_base=self.freeze_base, dtype=self.dtype, quant=self.quant,
            device=self.device, generator=self.generator,
        )


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, spec: _Spec):
        super().__init__()
        self.config, self.spec = config, spec
        H, nH, nKV, hd = (config.hidden_size, config.num_attention_heads, config.n_kv,
                          config.head_dim)
        self.q_proj = spec.proj("q_proj", H, nH * hd)
        self.k_proj = spec.proj("k_proj", H, nKV * hd)
        self.v_proj = spec.proj("v_proj", H, nKV * hd)
        self.o_proj = spec.proj("o_proj", nH * hd, H)
        # this rank's heads and its tp group (parallel/tensor_parallel.py)
        self.n_heads, self.n_kv, self.tp_group = nH, nKV, None

    def forward(self, x, mask, positions, rope, cache=None, cache_index=None, generator=None):
        cfg, spec = self.config, self.spec
        B, T, _ = x.shape
        nH, nKV, hd = self.n_heads, self.n_kv, cfg.head_dim
        if self.tp_group is not None:
            x = copy_to_tp(x, self.tp_group)
        # q / k / v share their input: one grouped LoRA delta, one keep mask.
        q, k, v = apply_lora_group(
            x, [p(x, defer_lora=True) for p in (self.q_proj, self.k_proj, self.v_proj)],
            alpha=spec.lora_alpha, r=max(spec.lora_r, 1),
            dropout_fn=lambda t: dropout(t, spec.lora_dropout, self.training, generator),
        )
        q = q.view(B, T, nH, hd)
        k = k.view(B, T, nKV, hd)
        v = v.view(B, T, nKV, hd)
        qh, kh = apply_rotary_pos_emb(q.transpose(1, 2), k.transpose(1, 2), positions, *rope)
        q = qh.transpose(1, 2).to(spec.dtype)
        k = kh.transpose(1, 2).to(spec.dtype)
        if cache is not None:
            if torch.is_tensor(cache_index):
                at = cache_index + torch.arange(T, device=k.device)
                cache["k"].index_copy_(1, at, k)
                cache["v"].index_copy_(1, at, v)
            else:
                cache["k"][:, cache_index:cache_index + T] = k
                cache["v"][:, cache_index:cache_index + T] = v
            k, v = cache["k"], cache["v"]
        out = dot_product_attention(q, k, v, mask=mask).reshape(B, T, nH * hd)
        return self.o_proj(out, generator=generator)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, spec: _Spec):
        super().__init__()
        self.spec = spec
        H, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = spec.proj("gate_proj", H, inter)
        self.up_proj = spec.proj("up_proj", H, inter)
        self.down_proj = spec.proj("down_proj", inter, H)
        self.tp_group = None

    def forward(self, x, generator=None):
        spec = self.spec
        if self.tp_group is not None:
            x = copy_to_tp(x, self.tp_group)
        gate, up = apply_lora_group(
            x, [p(x, defer_lora=True) for p in (self.gate_proj, self.up_proj)],
            alpha=spec.lora_alpha, r=max(spec.lora_r, 1),
            dropout_fn=lambda t: dropout(t, spec.lora_dropout, self.training, generator),
        )
        return self.down_proj(F.silu(gate) * up, generator=generator)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, spec: _Spec):
        super().__init__()
        norm = lambda: RMSNorm(config.hidden_size, config.rms_norm_eps,
                               trainable=not spec.freeze_base, device=spec.device)
        self.self_attn = LlamaAttention(config, spec)
        self.mlp = LlamaMLP(config, spec)
        self.input_layernorm = norm()
        self.post_attention_layernorm = norm()

    def forward(self, x, mask, positions, rope, cache=None, cache_index=None, generator=None):
        x = x + self.self_attn(self.input_layernorm(x), mask, positions, rope, cache,
                               cache_index, generator)
        return x + self.mlp(self.post_attention_layernorm(x), generator)


class LlamaModel(nn.Module):
    """``model.*`` of the Hugging Face layout: embeddings, layers, final norm."""

    def __init__(self, config: LlamaConfig, spec: _Spec):
        super().__init__()
        table = _normal((config.vocab_size, config.hidden_size), 0.02, spec.device,
                        spec.generator)
        self.embed_tokens = nn.Embedding(
            config.vocab_size, config.hidden_size,
            _weight=table.to(spec.dtype if spec.freeze_base else torch.float32),
        )
        self.embed_tokens.weight.requires_grad_(not spec.freeze_base)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, spec) for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            trainable=not spec.freeze_base, device=spec.device)


class LlamaForCausalLM(nn.Module):
    """Causal LM over token ids or pre-spliced ``inputs_embeds`` (the BCI
    path always hands embeds). Train / eval follows ``Module.training``;
    LoRA dropout draws from ``generator``."""

    def __init__(self, config: LlamaConfig, lora_r: int = 0, lora_alpha: float = 32.0,
                 lora_dropout: float = 0.0, lora_targets: Sequence[str] = (),
                 freeze_base: bool = False, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, quant: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        if quant is not None and quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant!r}")
        self.config, self.dtype, self.freeze_base = config, dtype, freeze_base
        spec = _Spec(lora_r, lora_alpha, lora_dropout, tuple(lora_targets), freeze_base, dtype,
                     quant, device, generator)
        self.model = LlamaModel(config, spec)
        if not config.tie_word_embeddings:
            # r = 0: a plain Dense that honours freeze_base (stored in the
            # compute dtype, int8 with quant, no gradient).
            head = dataclasses.replace(spec, lora_r=0,
                                       quant=quant if freeze_base else None)
            self.lm_head = head.proj("lm_head", config.hidden_size, config.vocab_size)
        cos, sin = rope_cos_sin(config.head_dim, config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device), persistent=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(input_ids)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,        # (B, T)
        inputs_embeds: Optional[torch.Tensor] = None,    # (B, T, H)
        attention_mask: Optional[torch.Tensor] = None,   # (B, S) over keys
        positions: Optional[torch.Tensor] = None,        # (B, T)
        cache: Optional[Tuple[Dict[str, torch.Tensor], ...]] = None,
        cache_index=None,                                # int, or a 0-dim int64 tensor
        generator: Optional[torch.Generator] = None,
    ):
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = inputs_embeds.to(self.dtype)
        B, T, _ = x.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=x.device)
        # a tensor index stays on the device: no int() of it, no sync
        q_offset = 0 if cache_index is None else (
            cache_index if torch.is_tensor(cache_index) else int(cache_index))
        mask = make_causal_padding_mask(attention_mask, T, q_offset)
        if positions is None:
            positions = (torch.arange(T, device=x.device) + q_offset)[None, :].expand(B, T)
        rope = (self.rope_cos, self.rope_sin)
        for i, layer in enumerate(self.model.layers):
            layer_cache = cache[i] if cache is not None else None
            if self.remat and layer_cache is None:
                x = remat_call(layer, x, mask, positions, rope, None, q_offset,
                               generator=generator)
            else:
                x = layer(x, mask, positions, rope, layer_cache, q_offset, generator)
        x = self.model.norm(x)
        if self.config.tie_word_embeddings:
            logits = F.linear(x, self.model.embed_tokens.weight.to(self.dtype))
        else:
            logits = self.lm_head(x)
        return logits.float(), cache

    def init_cache(self, batch_size: int, max_len: int):
        cfg = self.config
        dev = self.rope_cos.device
        # this rank's key/value heads under tensor parallelism
        n_kv = self.model.layers[0].self_attn.n_kv if len(self.model.layers) else cfg.n_kv
        shape = (batch_size, max_len, n_kv, cfg.head_dim)
        return tuple({"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                      "v": torch.zeros(shape, dtype=self.dtype, device=dev)}
                     for _ in range(cfg.num_hidden_layers))


# ---------------------------------------------------------------------------
# HF weight import, quantization of a state dict
# ---------------------------------------------------------------------------

_QUANT_PROJ_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj", "lm_head",
)


def quantize_llama_params(state_dict: Dict[str, torch.Tensor], mode: str = "int8",
                          quant_lm_head: bool = True,
                          layers: Optional[set] = None) -> Dict[str, torch.Tensor]:
    """Quantize the projection weights (and ``lm_head``) of a Llama state
    dict: ``<proj>.weight`` (out, in) becomes ``<proj>.kernel`` int8 (in, out)
    and ``<proj>.kernel_scale`` (out,), the layout ``LoRADense(quant=...)``
    holds. Norms, embeddings, biases and LoRA factors pass through. With
    ``layers`` (a set of module names), those layers are quantized instead.
    Host-side numpy."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r}")
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        name = prefix.rpartition(".")[2]
        if layers is None:
            chosen = name in _QUANT_PROJ_NAMES and (quant_lm_head or name != "lm_head")
        else:
            chosen = prefix in layers
        if leaf == "weight" and chosen:
            q, scale = quantize_int8(value.detach().float().cpu().numpy().T, axis=0)
            out[prefix + ".kernel"] = torch.from_numpy(q)
            out[prefix + ".kernel_scale"] = torch.from_numpy(scale)
        else:
            out[key] = value
    return out


def load_hf_llama_params(model_dir: str, config: LlamaConfig,
                         quant: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a Hugging Face Llama checkpoint under the port's
    names (they are the same), quantized when ``quant`` is set. Load it with
    :func:`load_base_state_dict`. ``transformers`` is imported here only."""
    from transformers import AutoModelForCausalLM

    hf = AutoModelForCausalLM.from_pretrained(model_dir, torch_dtype=torch.float32)
    sd = {k: v for k, v in hf.state_dict().items() if not k.endswith("inv_freq")}
    if config.tie_word_embeddings:
        sd.pop("lm_head.weight", None)
    return quantize_llama_params(sd, quant) if quant else sd


def load_base_state_dict(llm: LlamaForCausalLM, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load base weights into ``llm`` by name: every key must exist in the
    model with the same shape, and the only leaves the checkpoint may lack
    are the LoRA factors."""
    result = llm.load_state_dict(state_dict, strict=False)
    missing = [k for k in result.missing_keys if ".lora_" not in k]
    if missing or result.unexpected_keys:
        raise RuntimeError(f"Llama base weights do not fit: missing {missing}, "
                           f"unexpected {list(result.unexpected_keys)}")


def adapt_state_dict_quantization(saved: Dict[str, torch.Tensor],
                                  target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``saved`` in the quantization layout of ``target`` (the ``state_dict``
    of the model it goes into), so that a checkpoint serves with another
    quantization than it was trained with, by the rules of the JAX package's
    checkpoint restore: a float ``<proj>.weight`` going into an int8 layer is
    quantized (:func:`quantize_llama_params`); an int8 ``kernel`` +
    ``kernel_scale`` going into a float layer becomes ``weight``, dequantized
    and cast to the layer's dtype. Every other leaf passes through."""
    layers = lambda leaf: {k.rpartition(".")[0] for k in target if k.endswith("." + leaf)}
    out = quantize_llama_params(saved, layers=layers("kernel"))
    for prefix in layers("weight"):
        if f"{prefix}.kernel" in out and f"{prefix}.kernel_scale" in out:
            w = dequantize_int8(out.pop(f"{prefix}.kernel").cpu().numpy(),
                                out.pop(f"{prefix}.kernel_scale").cpu().numpy())
            out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T)).to(
                target[f"{prefix}.weight"].dtype)
    return out


def load_llm_state(llm: LlamaForCausalLM, saved: Dict[str, torch.Tensor]) -> None:
    """Load a saved LLM blob into ``llm``, put into its quantization layout
    first (:func:`adapt_state_dict_quantization`). Every saved key must fit,
    and the blob may lack frozen leaves only."""
    result = llm.load_state_dict(adapt_state_dict_quantization(saved, llm.state_dict()),
                                 strict=False)
    trains = {k for k, p in llm.named_parameters() if p.requires_grad}
    missing = [k for k in result.missing_keys if k in trains]
    if missing or result.unexpected_keys:
        raise RuntimeError(f"llm.pt does not fit: missing trainable leaves {missing}, "
                           f"unexpected {list(result.unexpected_keys)}")
