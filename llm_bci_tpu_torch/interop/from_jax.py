"""Weights carried from the JAX package into the port.

:func:`ndt1_state_dict_from_jax` maps a flax NDT1 param tree, given as
numpy arrays (``jax.device_get(params)``), to the port's ``state_dict``.
It imports no JAX. The key names are the reference torch layout that
``llm_bci_tpu/interop/torch_export.py::_emit_ndt1_encoder`` emits, under
``encoder.``, plus ``decoder.`` for the head. Dense kernels ``(in, out)``
are transposed to Linear weights ``(out, in)``; the ``StackProjection``
kernel ``(size*D, H)`` becomes the Linear-layout weight ``(H, size*D)``
that the port's strided conv reads. Load the result with
``model.load_state_dict(sd, strict=True)``. An active factors projection,
which the port's NDT1 does not build yet, raises.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


class _StateDict:
    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value: Any) -> None:
        if key in self.sd:
            raise ValueError(f"duplicate state_dict key {key!r}")
        self.sd[key] = torch.from_numpy(np.array(value, dtype=np.float32, copy=True))

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
    enc = params["encoder"]
    emb = enc["embedder"]
    p = "encoder.embedder"
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
        src, dst = enc[f"layer_{i}"], f"encoder.layers.{i}"
        for name in ("query", "key", "value", "out_proj"):
            out.linear(src["attn"][name], f"{dst}.attn.{name}")
        for name in ("up_proj", "down_proj"):
            out.linear(src["mlp"][name], f"{dst}.mlp.{name}")
        out.norm(src["ln1"], f"{dst}.ln1")
        out.norm(src["ln2"], f"{dst}.ln2")
        i += 1
    out.norm(enc["out_norm"], "encoder.out_norm")
    if "proj" in (enc.get("out_proj") or {}):
        raise ValueError("NDT1 params: an active factors projection is not ported yet")
    if "decoder" in params:
        out.linear(params["decoder"], "decoder")
    return out.sd
