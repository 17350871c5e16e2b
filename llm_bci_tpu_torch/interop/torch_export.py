"""Export of the port's models to the reference's PyTorch checkpoint format
(counterpart of ``llm_bci_tpu/interop/torch_export.py``).

The inverse of :mod:`llm_bci_tpu_torch.interop.torch_import`, over the same
key maps: each writes the component ``.bin`` state dicts and the
torch-pickled component configs as the reference's ``save_checkpoint``
methods lay them out, so that the reference code, or the JAX package's
importer, loads them strictly:

* NDT1: ``encoder.bin``, ``decoder.bin``, ``encoder_config.pth``;
* iTransformer: the same and ``decoder_config.pth`` (the decoder
  ``Sequential``'s indices follow the method and ``use_cls``);
* PatchTST: ``encoder.bin`` as a Hugging Face ``PatchTSTModel`` state dict
  (BatchNorm running statistics, ``num_batches_tracked``, the sincos table as
  ``position_enc``), ``decoder.bin``, the configs pickled under ``.yaml``
  names;
* BCI: the inner NDT1's ``encoder.bin`` and a zeroed vestigial
  ``decoder.bin``, ``projector.bin`` and ``projector_config.pth``, the LLM
  base as a Hugging Face directory (``config.json`` + ``model.safetensors``,
  :func:`save_hf_llama`) and the LoRA factors as a PEFT adapter
  (``adapter_model.safetensors`` + ``adapter_config.json``,
  :func:`save_peft_adapter`).

Tensors are written in float32, on the CPU. A port tensor that the target
layout has no slot for raises. Nothing here needs ``transformers`` or
``safetensors``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from llm_bci_tpu_torch.interop import safetensors
from llm_bci_tpu_torch.interop.torch_import import (
    Entry,
    component_keys,
    itransformer_decoder_map,
    itransformer_encoder_map,
    ndt1_decoder_map,
    ndt1_encoder_map,
    patchtst_decoder_map,
    patchtst_encoder_map,
)


def export_state(sd: Dict[str, torch.Tensor], entries: Sequence[Entry], what: str,
                 component: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """The reference state dict that ``entries`` make of the port's ``sd``.
    ``component``: the port keys the entries must cover."""
    if component is not None:
        left = sorted(set(component) - {e.port for e in entries})
        if left:
            raise ValueError(f"{what}: the reference layout has no slot for {left[:8]}")
    out: Dict[str, torch.Tensor] = {}
    for e in entries:
        v = sd[e.port].detach().cpu().float()
        if e.how == "same":
            parts: Sequence[torch.Tensor] = [v]
        elif e.how == "cat":
            parts = v.chunk(len(e.ref), dim=0)
        elif e.how == "stack":
            parts = v.unbind(0)
        else:
            parts = [p.t() for p in v.unbind(0)]
        for key, part in zip(e.ref, parts):
            if key in out:
                raise ValueError(f"{what}: duplicate export key {key!r}")
            out[key] = part.contiguous().clone()
    return out


def plain_config(cfg: Any, strip: Tuple[str, ...] = ()) -> Dict:
    """A deep copy of a config as plain containers without the port's keys
    beyond the reference's, and without ``from_pt`` (a stale path in a saved
    config would make the reference load from it again)."""
    drop = set(strip) | {"from_pt", "compute_dtype", "flash_attention", "remat"}

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items() if k not in drop}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return x

    return walk(dict(cfg))


def _save(obj: Any, save_dir: str, name: str) -> None:
    torch.save(obj, os.path.join(save_dir, name))


# ---------------------------------------------------------------------------
# NDT1, iTransformer, PatchTST
# ---------------------------------------------------------------------------


def ndt1_save_reference_checkpoint(model, save_dir: str) -> None:
    """A port NDT1 -> a reference-format checkpoint directory."""
    os.makedirs(save_dir, exist_ok=True)
    sd = model.state_dict()
    _save(export_state(sd, ndt1_encoder_map(sd, "encoder.").entries, "NDT1 encoder",
                       component_keys(sd, "encoder")), save_dir, "encoder.bin")
    _save(export_state(sd, ndt1_decoder_map(sd).entries, "NDT1 decoder",
                       component_keys(sd, "decoder")), save_dir, "decoder.bin")
    _save(plain_config(model.config["encoder"]), save_dir, "encoder_config.pth")


def itransformer_save_reference_checkpoint(model, save_dir: str) -> None:
    """A port iTransformer -> a reference-format checkpoint directory. The
    decoder ``Sequential`` starts with ``AverageTokens`` for a ctc or
    behaviour head without CLS, which shifts its Linears by one."""
    os.makedirs(save_dir, exist_ok=True)
    sd = model.state_dict()
    _save(export_state(sd, itransformer_encoder_map(sd).entries, "iTransformer encoder",
                       component_keys(sd, "encoder")), save_dir, "encoder.bin")
    averaged = model.method_name in ("ctc", "dyn_behaviour", "stat_behaviour")
    off = int(averaged and not model.use_cls)
    linears = [str(off), str(off + 2)] if model.decoder_hidden is not None else [str(off)]
    _save(export_state(sd, itransformer_decoder_map(sd, linears).entries, "iTransformer decoder",
                       component_keys(sd, "decoder")), save_dir, "decoder.bin")
    for comp in ("encoder", "decoder"):
        _save(plain_config(model.config[comp]), save_dir, f"{comp}_config.pth")


def patchtst_save_reference_checkpoint(model, save_dir: str) -> None:
    """A port PatchTST -> a reference-format checkpoint directory whose
    ``encoder.bin`` is a strict Hugging Face ``PatchTSTModel`` state dict."""
    from llm_bci_tpu_torch.models.patchtst import num_patches, sincos_position_encoding

    os.makedirs(save_dir, exist_ok=True)
    sd = model.state_dict()
    enc = export_state(sd, patchtst_encoder_map(sd).entries, "PatchTST encoder",
                       component_keys(sd, "encoder"))
    for key in [k for k in enc if k.endswith(".batchnorm.running_var")]:
        # unused by the reference's momentum-0.1 BatchNorm
        enc[key.replace("running_var", "num_batches_tracked")] = torch.zeros((), dtype=torch.int64)
    c = model.config["encoder"]
    seq = num_patches(int(c["context_length"]), int(c["patch_length"]),
                      int(c["patch_stride"])) + int(bool(c.get("use_cls_token", False)))
    enc["encoder.positional_encoder.position_enc"] = torch.from_numpy(
        sincos_position_encoding(seq, int(c["d_model"])).astype("float32"))
    _save(enc, save_dir, "encoder.bin")
    dec = patchtst_decoder_map(sd, int(c["num_input_channels"]))
    _save(export_state(sd, dec.entries, "PatchTST decoder", component_keys(sd, "decoder")),
          save_dir, "decoder.bin")
    # the reference torch.saves its configs under .yaml names
    for comp in ("encoder", "decoder"):
        _save(plain_config(model.config[comp]), save_dir, f"{comp}_config.yaml")


# ---------------------------------------------------------------------------
# Llama -> Hugging Face / PEFT
# ---------------------------------------------------------------------------


def hf_llama_state_dict(llm) -> Dict[str, torch.Tensor]:
    """The port Llama's base weights as a Hugging Face ``LlamaForCausalLM``
    state dict (the names are the same), float32. LoRA factors are left
    out (:func:`save_peft_adapter`); an int8 base raises."""
    out = {}
    for key, value in llm.state_dict().items():
        if ".lora_" in key:
            continue
        if key.endswith((".kernel", ".kernel_scale")):
            raise ValueError(
                "hf_llama_state_dict: int8-quantized kernel — export needs the bf16/f32 tree "
                "(dequantize_int8 / re-import the HF base first)")
        out[key] = value.detach().cpu().float().contiguous()
    return out


def save_hf_llama(llm, llama_config, save_dir: str) -> None:
    """A Hugging Face Llama directory: ``config.json`` and one
    ``model.safetensors``, loadable by ``AutoModelForCausalLM``."""
    os.makedirs(save_dir, exist_ok=True)
    cfg = llama_config
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_act": "silu",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.n_kv,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_word_embeddings, "torch_dtype": "float32",
        }, f, indent=2)
    safetensors.save_file(hf_llama_state_dict(llm), os.path.join(save_dir, "model.safetensors"),
                          metadata={"format": "pt"})


def save_peft_adapter(llm, save_dir: str, lora_alpha: Optional[float] = None) -> int:
    """The LoRA factors of the port Llama as a PEFT adapter directory
    (``adapter_model.safetensors`` + ``adapter_config.json``; PEFT stores
    ``lora_A`` (r, in) and ``lora_B`` (out, r), the port the transposes).
    Returns the number of adapted projections (0: nothing written).
    ``lora_alpha`` is the alpha the model was trained with: PEFT scales the
    deltas by alpha / r from the config, so it is required with factors."""
    tensors: Dict[str, torch.Tensor] = {}
    targets, ranks = set(), set()
    for key, value in llm.state_dict().items():
        if not key.endswith((".lora_A", ".lora_B")):
            continue
        module, _, leaf = key.rpartition(".")
        tensors[f"base_model.model.{module}.{leaf}.weight"] = (
            value.detach().cpu().float().t().contiguous())
        targets.add(module.rpartition(".")[2])
        if leaf == "lora_A":
            ranks.add(int(value.shape[1]))
    if not tensors:
        return 0
    if lora_alpha is None:
        raise ValueError(
            "save_peft_adapter: the model carries LoRA factors but no lora_alpha was given — "
            "pass the alpha the model was trained with (method.model_kwargs.lora.alpha); "
            "adapter_config.json must record it for peft to scale correctly")
    if len(ranks) != 1:
        raise ValueError(f"save_peft_adapter: projections have differing LoRA ranks "
                         f"{sorted(ranks)} — a peft adapter_config records one r")
    os.makedirs(save_dir, exist_ok=True)
    safetensors.save_file(tensors, os.path.join(save_dir, "adapter_model.safetensors"),
                          metadata={"format": "pt"})
    with open(os.path.join(save_dir, "adapter_config.json"), "w") as f:
        json.dump({
            "peft_type": "LORA", "task_type": "CAUSAL_LM", "r": ranks.pop(),
            "lora_alpha": float(lora_alpha), "lora_dropout": 0.0,
            "target_modules": sorted(targets), "bias": "none", "fan_in_fan_out": False,
            "inference_mode": True,
        }, f, indent=2)
    return len(tensors) // 2


# ---------------------------------------------------------------------------
# BCI
# ---------------------------------------------------------------------------


def bci_save_reference_checkpoint(model, save_dir: str, include_base: bool = True,
                                  vocab_size: Optional[int] = None) -> None:
    """A port BCI -> a reference BCI checkpoint directory: the inner NDT1's
    ``encoder.bin`` and a zeroed vestigial ``decoder.bin`` (the reference
    builds that head, its BCI forward never calls it), ``projector.bin``,
    the LLM base as Hugging Face weights (``include_base``; a frozen base
    usually reloads from the original directory instead, and the reference's
    PEFT ``save_pretrained`` writes the adapter alone) and the LoRA factors
    as a PEFT adapter."""
    os.makedirs(save_dir, exist_ok=True)
    sd = model.state_dict()
    enc = ndt1_encoder_map(sd, "ndt1_encoder.")
    _save(export_state(sd, enc.entries, "BCI ndt1 encoder",
                       [k for k in sd if k.startswith("ndt1_encoder.")]), save_dir, "encoder.bin")
    _save(plain_config(model.config["ndt1"]["encoder"]), save_dir, "encoder_config.pth")
    vs = int(vocab_size or 41)
    out_size = model.ndt1_encoder.out_size
    _save({"0.weight": torch.zeros(vs, out_size), "0.bias": torch.zeros(vs)},
          save_dir, "decoder.bin")

    proj = {k: v for k, v in sd.items() if k.startswith("projector")}
    if model.projector_in is None:
        out = {k[len("projector_out."):]: v for k, v in proj.items()}
    else:
        out = {("0." if k.startswith("projector_in.") else "2.") + k.rpartition(".")[2]: v
               for k, v in proj.items()}
    _save({k: v.detach().cpu().float().contiguous() for k, v in out.items()},
          save_dir, "projector.bin")
    _save(plain_config(model.config["projector"]), save_dir, "projector_config.pth")

    if include_base:
        save_hf_llama(model.llm, model.llama_config, save_dir)
    save_peft_adapter(model.llm, save_dir, lora_alpha=model.lora_alpha)
