"""Weights carried from the JAX package into the port.

:func:`ndt1_state_dict_from_jax` maps a flax NDT1 param tree, given as
numpy arrays (``jax.device_get(params)``), to the port's ``state_dict``.
It imports no JAX. The key names are the reference torch layout that
``llm_bci_tpu/interop/torch_export.py::_emit_ndt1_encoder`` emits, under
``encoder.``, plus ``decoder.`` for the head. Dense kernels ``(in, out)``
are transposed to Linear weights ``(out, in)``; the ``StackProjection``
kernel ``(size*D, H)`` becomes the Linear-layout weight ``(H, size*D)``
that the port's strided conv reads. Load the result with
``model.load_state_dict(sd, strict=True)``. An active factors projection's
``out_proj/proj`` becomes ``encoder.out_proj.proj.0``, the reference
layout's name.

:func:`llama_state_dict_from_jax`, :func:`bci_state_dict_from_jax` and
:func:`phoneme_llm_state_dict_from_jax` do the same for the Llama stack, the
BCI model and PhonemeLLM (whose coupler ``Dense`` kernels become ``Linear``
weights). The port's Llama names are
Hugging Face's (``model.layers.{i}.self_attn.q_proj`` ...). A float base
``kernel`` (in, out) becomes ``weight`` (out, in); an int8 ``kernel`` keeps
its (in, out) layout and its dtype beside ``kernel_scale``; ``lora_A`` /
``lora_B`` keep theirs.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


class _StateDict:
    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value: Any, dtype=np.float32) -> None:
        if key in self.sd:
            raise ValueError(f"duplicate state_dict key {key!r}")
        self.sd[key] = torch.from_numpy(np.array(value, dtype=dtype, copy=True))

    def linear(self, src: Mapping, prefix: str) -> None:
        self.put(prefix + ".weight", np.asarray(src["kernel"]).T)
        if "bias" in src:
            self.put(prefix + ".bias", src["bias"])

    def norm(self, src: Mapping, prefix: str) -> None:
        self.put(prefix + ".weight", src["scale"])
        self.put(prefix + ".bias", src["bias"])


def ndt1_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax NDT1 params ``{"encoder": ..., "decoder": ...}`` -> port state dict."""
    out = _StateDict()
    _put_encoder(out, params["encoder"], "encoder")
    if "decoder" in params:
        out.linear(params["decoder"], "decoder")
    return out.sd


def _put_encoder(out: _StateDict, enc: Mapping, prefix: str) -> None:
    """The NeuralEncoder subtree under ``prefix``."""
    emb = enc["embedder"]
    p = f"{prefix}.embedder"
    if "embed_spikes" in emb:
        out.linear(emb["embed_spikes"], f"{p}.embed_spikes")
    elif "embed_spikes_days" in emb:
        w = np.asarray(emb["embed_spikes_days"])          # (days, C, D)
        for d in range(w.shape[0]):
            out.put(f"{p}.embed_spikes.{d}.weight", w[d].T)
        if "embed_spikes_days_bias" in emb:
            b = np.asarray(emb["embed_spikes_days_bias"])  # (days, D)
            for d in range(b.shape[0]):
                out.put(f"{p}.embed_spikes.{d}.bias", b[d])
    else:
        raise ValueError("NDT1 params: no spike-embedding leaves")
    if "stack_projection" in emb:
        out.linear(emb["stack_projection"], f"{p}.stack_projection")
    if "projection" in emb:
        out.linear(emb["projection"], f"{p}.projection")
    for name in ("embed_pos", "block_embedding", "day_embedding"):
        if name in emb:
            out.put(f"{p}.{name}.weight", emb[name])

    i = 0
    while f"layer_{i}" in enc:
        src, dst = enc[f"layer_{i}"], f"{prefix}.layers.{i}"
        for name in ("query", "key", "value", "out_proj"):
            out.linear(src["attn"][name], f"{dst}.attn.{name}")
        for name in ("up_proj", "down_proj"):
            out.linear(src["mlp"][name], f"{dst}.mlp.{name}")
        out.norm(src["ln1"], f"{dst}.ln1")
        out.norm(src["ln2"], f"{dst}.ln2")
        i += 1
    out.norm(enc["out_norm"], f"{prefix}.out_norm")
    if "proj" in (enc.get("out_proj") or {}):
        out.linear(enc["out_proj"]["proj"], f"{prefix}.out_proj.proj.0")


def _put_lora_dense(out: _StateDict, src: Mapping, prefix: str) -> None:
    """One ``LoRADense``: a float or an int8 base, bias, LoRA factors."""
    kernel = np.asarray(src["kernel"])
    if kernel.dtype == np.int8:
        out.put(prefix + ".kernel", kernel, dtype=np.int8)
        out.put(prefix + ".kernel_scale", src["kernel_scale"])
    else:
        out.put(prefix + ".weight", kernel.T)
    for name in ("bias", "lora_A", "lora_B"):
        if name in src:
            out.put(f"{prefix}.{name}", src[name])


def _put_llama(out: _StateDict, params: Mapping, prefix: str) -> None:
    out.put(f"{prefix}model.embed_tokens.weight", params["embed_tokens"]["embedding"])
    out.put(f"{prefix}model.norm.weight", params["norm"]["weight"])
    if "lm_head" in params:
        _put_lora_dense(out, params["lm_head"], f"{prefix}lm_head")
    i = 0
    while f"layers_{i}" in params:
        src, dst = params[f"layers_{i}"], f"{prefix}model.layers.{i}"
        for name in ("input_layernorm", "post_attention_layernorm"):
            out.put(f"{dst}.{name}.weight", src[name]["weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _put_lora_dense(out, src["self_attn"][name], f"{dst}.self_attn.{name}")
        for name in ("gate_proj", "up_proj", "down_proj"):
            _put_lora_dense(out, src["mlp"][name], f"{dst}.mlp.{name}")
        i += 1


def llama_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``LlamaForCausalLM`` params -> the port's Llama state dict."""
    out = _StateDict()
    _put_llama(out, params, "")
    return out.sd


def bci_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``BCI`` params ``{"llm", "ndt1_encoder", "projector_in",
    "projector_out"}`` -> the port's BCI state dict."""
    out = _StateDict()
    _put_llama(out, params["llm"], "llm.")
    _put_encoder(out, params["ndt1_encoder"], "ndt1_encoder")
    for name in ("projector_in", "projector_out"):
        if name in params:
            out.linear(params[name], name)
    return out.sd


def phoneme_llm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``PhonemeLLM`` params ``{"llm", "coupler_in", "coupler_out"}`` ->
    the port's PhonemeLLM state dict."""
    out = _StateDict()
    _put_llama(out, params["llm"], "llm.")
    for name in ("coupler_in", "coupler_out"):
        out.linear(params[name], name)
    return out.sd


_LISTS = {"layer": "layers", "dense": "dense"}


def _torch_name(name: str) -> str:
    """``layer_3`` -> ``layers.3``, ``dense_0`` -> ``dense.0``; others as they are."""
    return re.sub(r"^(layer|dense)_(\d+)$", lambda m: f"{_LISTS[m[1]]}.{m[2]}", name)


def _put_tree(out: _StateDict, node: Mapping, prefix: str) -> None:
    """Every leaf of a flax subtree under the port's names."""
    for name, sub in node.items():
        path = f"{prefix}.{_torch_name(name)}" if prefix else _torch_name(name)
        if not isinstance(sub, Mapping):
            out.put(path, sub)
        elif "kernel" in sub:
            out.linear(sub, path)
        elif "scale" in sub:
            out.norm(sub, path)
        elif "mean" in sub and "var" in sub:
            out.put(path + ".running_mean", sub["mean"])
            out.put(path + ".running_var", sub["var"])
        else:
            _put_tree(out, sub, path)


def itransformer_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``iTransformer`` params ``{"encoder", "decoder_hidden",
    "decoder_out"}`` -> the port's iTransformer state dict."""
    out = _StateDict()
    _put_tree(out, params, "")
    return out.sd


def patchtst_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``PatchTSTForSpikingActivity`` variables ``{"params",
    "batch_stats"}`` (``batch_stats`` only with BatchNorm) -> the port's state
    dict, running averages included."""
    out = _StateDict()
    for collection in ("params", "batch_stats"):
        _put_tree(out, variables.get(collection, {}), "")
    return out.sd
