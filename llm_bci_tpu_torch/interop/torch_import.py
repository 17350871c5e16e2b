"""Import of the reference's PyTorch checkpoint format into the port's
modules (counterpart of ``llm_bci_tpu/interop/torch_import.py``).

The reference saves one torch ``state_dict`` a component:

* NDT1: ``encoder.bin`` (the ``NeuralEncoder``) and ``decoder.bin`` (a
  ``Sequential`` whose ``0`` is the head's Linear), ``encoder_config.pth``;
* iTransformer: the same two bins, ``encoder_config.pth`` and
  ``decoder_config.pth``;
* PatchTST: ``encoder.bin``, a Hugging Face ``PatchTSTModel`` state dict
  (q / k / v split, ``ff.0`` / ``ff.3``, ``norm_sublayer{1,3}.batchnorm``
  with its running statistics, ``positional_encoder.position_enc``), and
  ``decoder.bin``; its configs are torch pickles under ``.yaml`` names;
* BCI: the inner NDT1's ``encoder.bin`` (and a vestigial ``decoder.bin``
  that its forward never calls), ``projector.bin`` with
  ``projector_config.pth``, and the LLM as full Hugging Face weights
  (``model*.safetensors`` or ``pytorch_model*.bin`` beside ``config.json``)
  and / or a PEFT LoRA adapter (``adapter_model.safetensors`` or ``.bin``
  beside ``adapter_config.json``).

Each family's layout is one list of :class:`Entry` (a port key, the
reference keys it comes from, and how: the same tensor, rows concatenated
for a fused ``qkv``, or per-channel Linears stacked); the import here and the
export of :mod:`llm_bci_tpu_torch.interop.torch_export` walk the same list
in the two directions. An import is strict, with the JAX package's
messages: every reference key is consumed or matches the ignore list
(``.*num_batches_tracked``, ``encoder\\.embedder\\.padding.*``), every tensor
is shape-checked against the model, and a checkpoint with more layers than
the model raises. Nothing here needs ``transformers`` or ``safetensors``.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from llm_bci_tpu_torch.interop import safetensors

PATCHTST_IGNORE = (r".*num_batches_tracked", r"encoder\.embedder\.padding.*")


def is_torch_checkpoint(load_dir: str, component: str = "encoder") -> bool:
    """True when ``load_dir`` holds the reference's ``{component}.bin`` and
    not the port's own ``{component}.pt`` beside it."""
    return (os.path.isfile(os.path.join(load_dir, f"{component}.bin"))
            and not os.path.isfile(os.path.join(load_dir, f"{component}.pt")))


def _torch_pickled_config(path: str) -> Dict:
    try:
        # the reference saves dict(config.<component>): plain containers
        cfg = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # a save may pickle the DictConfig subclass itself; unpickle it as a
        # plain dict without importing the reference package
        import pickle
        import types

        class _CfgUnpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if name == "DictConfig":
                    return dict
                return super().find_class(module, name)

        shim = types.ModuleType("plain_config_pickle")     # torch reads its __name__
        shim.Unpickler, shim.load = _CfgUnpickler, pickle.load
        cfg = torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x

    return plain(cfg)


def load_saved_component_config(load_dir: str, component: str) -> Optional[Dict]:
    """The component config saved beside a checkpoint: the port's
    ``{component}_config.yaml`` (real yaml), the reference's torch-pickled
    ``{component}_config.pth``, or a torch zip under the ``.yaml`` name (the
    reference PatchTST's). Raises ``FileNotFoundError`` when the directory
    holds the component's weights (``{component}.bin`` or ``.pt``) but no
    config: building from the live or default config is how a structurally
    different model loads shape-matching weights without an error. Warns
    and returns None when the directory holds neither."""
    ypath = os.path.join(load_dir, f"{component}_config.yaml")
    if os.path.isfile(ypath):
        with open(ypath, "rb") as f:
            head = f.read(2)
        if head == b"PK":      # a torch zip save wearing a .yaml name
            return _torch_pickled_config(ypath)
        import yaml

        with open(ypath) as f:
            return yaml.safe_load(f)
    ppath = os.path.join(load_dir, f"{component}_config.pth")
    if os.path.isfile(ppath):
        return _torch_pickled_config(ppath)
    if any(os.path.isfile(os.path.join(load_dir, f"{component}.{ext}")) for ext in ("bin", "pt")):
        raise FileNotFoundError(
            f"from_pt dir {load_dir!r} holds {component} weights but no saved "
            f"'{component}' config ({component}_config.yaml/.pth): refusing to graft "
            "trained weights onto the live/default config — shape-compatible architecture "
            "drift (e.g. a different n_heads) would load silently wrong. Copy the saved "
            "config next to the weights, or point from_pt at the full checkpoint dir.")
    warnings.warn(
        f"from_pt dir {load_dir!r} has no saved '{component}' config "
        f"({component}_config.yaml/.pth): the {component} config re-merge is skipped and "
        "the model is built from the live/default config. If this dir came from a "
        "checkpoint, copy the saved config next to the weights (or point from_pt at the "
        "full STEP dir).", stacklevel=3)
    return None


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.bin`` / ``.pt`` state dict or a ``.safetensors`` file, on the CPU."""
    if path.endswith(".safetensors"):
        return safetensors.load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# The key maps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Entry:
    """One tensor of the port's ``state_dict`` and the reference keys it is
    made of. ``how``: ``same`` (one key, the same tensor), ``cat`` (the
    reference tensors' rows concatenated: q / k / v into ``qkv``), ``stack``
    (per-channel tensors stacked on a new first axis) or ``stack_t`` (the
    same with each Linear weight transposed to the port's (in, out))."""

    port: str
    ref: Tuple[str, ...]
    how: str = "same"


class KeyMap:
    """Builds a list of entries for a module whose ``state_dict`` keys are
    ``keys`` (the port's names, with ``port`` prefixed)."""

    def __init__(self, keys: Iterable[str], port: str = ""):
        self.keys, self.port = set(keys), port
        self.entries: List[Entry] = []

    def has(self, port_key: str) -> bool:
        return self.port + port_key in self.keys

    def one(self, port_key: str, ref_key: str) -> None:
        self.entries.append(Entry(self.port + port_key, (ref_key,)))

    def lin(self, port_prefix: str, ref_prefix: str) -> None:
        """A Linear or a LayerNorm: ``weight``, and ``bias`` where the model has one."""
        self.one(port_prefix + ".weight", ref_prefix + ".weight")
        if self.has(port_prefix + ".bias"):
            self.one(port_prefix + ".bias", ref_prefix + ".bias")

    def joined(self, port_key: str, ref_keys: Sequence[str], how: str) -> None:
        self.entries.append(Entry(self.port + port_key, tuple(ref_keys), how))

    def n_layers(self, stem: str) -> int:
        """Layers of the model under ``stem`` (``stem.{i}.``)."""
        pat = re.compile(re.escape(self.port + stem) + r"\.(\d+)\.")
        found = {int(m.group(1)) for k in self.keys if (m := pat.match(k))}
        return max(found) + 1 if found else 0


class Graft:
    """Consumes a reference state dict into port tensors; raises on a
    missing key, a shape mismatch and leftover keys."""

    def __init__(self, sd: Dict[str, torch.Tensor], what: str):
        self.sd, self.what, self.used = dict(sd), what, set()

    def has(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"{self.what}: missing key {key!r} in torch checkpoint")
        self.used.add(key)
        return self.sd[key]

    def apply(self, entries: Sequence[Entry], template: Dict[str, torch.Tensor],
              out: Dict[str, torch.Tensor]) -> None:
        """Every entry's tensor, shape-checked against ``template`` (the
        model's ``state_dict``) and cast to its dtype, into ``out``."""
        for e in entries:
            parts = [self.take(k) for k in e.ref]
            if e.how == "same":
                (value,) = parts
            elif e.how == "cat":
                value = torch.cat(parts, dim=0)
            elif e.how == "stack":
                value = torch.stack(parts)
            else:
                value = torch.stack([p.t() for p in parts])
            self.put(out, template, e.port, value)

    def put(self, out: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor], name: str,
            value: torch.Tensor) -> None:
        if name not in template:
            raise KeyError(f"{self.what}: our model has no leaf {name!r}")
        want = template[name]
        if tuple(want.shape) != tuple(value.shape):
            raise ValueError(
                f"{self.what}: shape mismatch for {name!r}: checkpoint {tuple(value.shape)} "
                f"vs model {tuple(want.shape)} — the reference config this checkpoint was "
                "trained with does not match the model")
        if want.dtype == torch.int8 and value.dtype != torch.int8:
            raise ValueError(
                f"{self.what}.{name}: target model is int8-quantized — import the torch "
                "checkpoint into a bf16 model first, then apply quantize_llama_params")
        out[name] = value.detach().to(want.dtype).contiguous().clone()

    def finish(self, ignore: Tuple[str, ...] = ()) -> None:
        """Raise if any checkpoint key was neither consumed nor matches an
        ``ignore`` regex."""
        left = [k for k in self.sd
                if k not in self.used and not any(re.fullmatch(p, k) for p in ignore)]
        if left:
            raise ValueError(
                f"{self.what}: {len(left)} torch checkpoint key(s) were not imported: "
                f"{sorted(left)[:8]}{'…' if len(left) > 8 else ''} — unknown architecture "
                "variant; refusing a partial import")


def component_keys(keys: Iterable[str], component: str) -> List[str]:
    """The port keys of ``component``: those under ``encoder.``, or for
    ``decoder`` all the others."""
    under = [k for k in keys if k.startswith("encoder.")]
    return under if component == "encoder" else [k for k in keys if not k.startswith("encoder.")]


def seq_linear_prefixes(keys: Iterable[str], prefix: str) -> List[str]:
    """Linear prefixes (``<prefix><idx>``) inside a torch ``nn.Sequential``,
    in index order."""
    idxs = sorted(int(m.group(1)) for k in keys
                  if (m := re.fullmatch(re.escape(prefix) + r"(\d+)\.weight", k)))
    return [f"{prefix}{i}" for i in idxs]


# -- NDT1: the port's encoder keys are the reference's encoder.bin names ----


def ndt1_encoder_map(keys: Iterable[str], port: str) -> KeyMap:
    m = KeyMap(keys, port)
    for k in sorted(m.keys):
        if k.startswith(port):
            m.one(k[len(port):], k[len(port):])
    return m


def ndt1_decoder_map(keys: Iterable[str], port: str = "decoder") -> KeyMap:
    """The head's Linear is ``0`` of the reference's decoder ``Sequential``."""
    m = KeyMap(keys)
    m.lin(port, "0")
    return m


def _check_ndt1_depth(g: Graft, m: KeyMap, what: str = "NDT1") -> None:
    n = m.n_layers("layers")
    if g.has(f"layers.{n}.ln1.weight"):
        raise ValueError(f"{what}: checkpoint has ≥{n + 1} transformer layers, model has {n}")


def _graft_ndt1_encoder(load_dir: str, template: Dict[str, torch.Tensor], port: str,
                        out: Dict[str, torch.Tensor], what: str) -> None:
    g = Graft(load_state_dict_file(os.path.join(load_dir, "encoder.bin")), what)
    m = ndt1_encoder_map(template, port)
    _check_ndt1_depth(g, m)
    g.apply(m.entries, template, out)
    # RoPE tables and the context mask are non-persistent buffers: absent
    g.finish()


def ndt1_encoder_state_dict_from_reference(load_dir: str, model, port: str
                                           ) -> Dict[str, torch.Tensor]:
    """A reference ``encoder.bin`` -> the tensors of ``model``'s NDT1 trunk
    under ``port`` (``""`` for the trunk itself, ``encoder.`` of an NDT1)."""
    out: Dict[str, torch.Tensor] = {}
    _graft_ndt1_encoder(load_dir, model.state_dict(), port, out, "NDT1 encoder")
    return out


def ndt1_state_dict_from_reference(load_dir: str, model,
                                   components: Sequence[str] = ("encoder", "decoder")
                                   ) -> Dict[str, torch.Tensor]:
    """A reference NDT1 checkpoint directory -> the port NDT1's state dict
    for ``components`` (the decoder only when ``decoder.bin`` is there)."""
    template = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    if "encoder" in components:
        _graft_ndt1_encoder(load_dir, template, "encoder.", out, "NDT1 encoder")
    dec_path = os.path.join(load_dir, "decoder.bin")
    if "decoder" in components and os.path.isfile(dec_path):
        gd = Graft(load_state_dict_file(dec_path), "NDT1 decoder")
        gd.apply(ndt1_decoder_map(template).entries, template, out)
        gd.finish()
    return out


# -- iTransformer ------------------------------------------------------------


def _torch_encoder_stack(m: KeyMap, port: str, ref: str) -> None:
    """The port's ``TorchEncoderStack`` <-> torch ``nn.TransformerEncoder``."""
    for i in range(m.n_layers(f"{port}.layers")):
        p, r = f"{port}.layers.{i}", f"{ref}.layers.{i}"
        m.one(f"{p}.attn.qkv.weight", f"{r}.self_attn.in_proj_weight")
        m.one(f"{p}.attn.qkv.bias", f"{r}.self_attn.in_proj_bias")
        m.lin(f"{p}.attn.out_proj", f"{r}.self_attn.out_proj")
        for name in ("linear1", "linear2", "norm1", "norm2"):
            m.lin(f"{p}.{name}", f"{r}.{name}")
    m.lin(f"{port}.norm", f"{ref}.norm")


def itransformer_encoder_map(keys: Iterable[str], embed_linears: Sequence[str] = ("embed.0.0",
                                                                                 "embed.0.3")
                             ) -> KeyMap:
    """``embed_linears``: the reference's MLP embedder Linears inside
    ``embed.0`` (torchvision's ``MLP`` puts them at 0 and 3)."""
    m = KeyMap(keys, "encoder.")
    if m.has("embed_mlp.dense.0.weight"):            # embedder mode "mlp"
        if len(embed_linears) != 2:
            raise ValueError(
                f"iTransformer: expected 2 embed MLP linears, found {len(embed_linears)}")
        m.lin("embed_mlp.dense.0", embed_linears[0])
        m.lin("embed_mlp.dense.1", embed_linears[1])
        m.lin("embed_norm", "embed.1")
    elif m.has("embed_univariate.embed_pos"):        # embedder mode "transformer"
        m.lin("embed_univariate.embed_in", "embed.embed_spikes.0")
        m.lin("embed_univariate.embed_out", "embed.embed_spikes.2")
        m.one("embed_univariate.embed_pos", "embed.embed_pos.weight")
        m.one("embed_univariate.cls_embed", "embed.cls_embed.weight")
        _torch_encoder_stack(m, "embed_univariate.transformer", "embed.transformer")
        m.lin("embed_proj", "embed_proj.0")
        m.lin("embed_proj_norm", "embed_proj.1")
    else:
        raise ValueError("iTransformer: unknown embedder layout in our params")
    for name in ("channel", "region"):
        if m.has(f"{name}_embeddings"):
            m.one(f"{name}_embeddings", f"{name}_embeddings.0.weight")
            m.lin(f"{name}_norm", f"{name}_embeddings.1")
    if m.has("depth_in.weight"):
        # Sequential(Linear, act, Linear, LayerNorm)
        m.lin("depth_in", "depth_embeddings.0")
        m.lin("depth_out", "depth_embeddings.2")
        m.lin("depth_norm", "depth_embeddings.3")
    if m.has("cls_embed"):
        m.one("cls_embed", "cls_embed.weight")
    _torch_encoder_stack(m, "transformer", "transformer")
    return m


def itransformer_decoder_map(keys: Iterable[str], linears: Sequence[str]) -> KeyMap:
    """``linears``: the Linears of the reference's decoder ``Sequential`` in
    order (after its ``AverageTokens`` for a non-CLS ctc / behaviour head)."""
    m = KeyMap(keys)
    hidden = m.has("decoder_hidden.weight")
    if len(linears) != 1 + hidden:
        raise ValueError(
            f"iTransformer: decoder has {len(linears)} linears but model "
            f"{'has' if hidden else 'lacks'} a hidden layer — mlp_decoder mismatch between "
            "checkpoint and config")
    if hidden:
        m.lin("decoder_hidden", linears[0])
    m.lin("decoder_out", linears[-1])
    return m


def _check_stack_depth(g: Graft, m: KeyMap, port: str, ref: str) -> None:
    n = m.n_layers(f"{port}.layers")
    if g.has(f"{ref}.layers.{n}.norm1.weight"):
        raise ValueError(f"{g.what}: checkpoint has ≥{n + 1} layers, model has {n}")


def itransformer_state_dict_from_reference(load_dir: str, model,
                                           components: Sequence[str] = ("encoder", "decoder")
                                           ) -> Dict[str, torch.Tensor]:
    """A reference iTransformer checkpoint directory -> the port's state
    dict for ``components`` (the reference warm-starts the encoder and the
    decoder from separate directories)."""
    template = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    if "decoder" in components:
        gd = Graft(load_state_dict_file(os.path.join(load_dir, "decoder.bin")),
                   "iTransformer decoder")
        m = itransformer_decoder_map(template, seq_linear_prefixes(gd.sd, ""))
        gd.apply(m.entries, template, out)
        gd.finish()
    if "encoder" in components:
        g = Graft(load_state_dict_file(os.path.join(load_dir, "encoder.bin")),
                  "iTransformer encoder")
        m = itransformer_encoder_map(template, seq_linear_prefixes(g.sd, "embed.0."))
        for port, ref in (("transformer", "transformer"),
                          ("embed_univariate.transformer", "embed.transformer")):
            if m.n_layers(f"{port}.layers"):
                _check_stack_depth(g, m, port, ref)
        g.apply(m.entries, template, out)
        g.finish()
    return out


# -- PatchTST (encoder.bin is a Hugging Face PatchTSTModel state dict) -------


def patchtst_encoder_map(keys: Iterable[str]) -> KeyMap:
    m = KeyMap(keys, "encoder.")
    m.lin("patch_embed", "encoder.embedder.input_embedding")
    for i in range(m.n_layers("layers")):
        p, r = f"layers.{i}", f"encoder.layers.{i}"
        qkv = [f"{r}.self_attn.{n}_proj" for n in "qkv"]
        m.joined(f"{p}.qkv.weight", [f"{k}.weight" for k in qkv], "cat")
        if m.has(f"{p}.qkv.bias"):
            m.joined(f"{p}.qkv.bias", [f"{k}.bias" for k in qkv], "cat")
        m.lin(f"{p}.attn_out", f"{r}.self_attn.out_proj")
        m.lin(f"{p}.ff1", f"{r}.ff.0")
        m.lin(f"{p}.ff2", f"{r}.ff.3")
        for ours, hf in (("norm1", "norm_sublayer1"), ("norm2", "norm_sublayer3")):
            if m.has(f"{p}.{ours}.bn.weight"):
                for leaf in ("weight", "bias", "running_mean", "running_var"):
                    m.one(f"{p}.{ours}.bn.{leaf}", f"{r}.{hf}.batchnorm.{leaf}")
            else:
                m.lin(f"{p}.{ours}.ln", f"{r}.{hf}")
    return m


def patchtst_decoder_map(keys: Iterable[str], n_channels: int) -> KeyMap:
    """The heads' shared ``projection`` (a Linear, or ``0`` / ``2`` of the
    mlp ``Sequential``) or per-channel ``projections.{c}``, stacked here."""
    m = KeyMap(keys, "decoder.")
    if m.has("proj_out.weight"):
        if m.has("proj_hidden.weight"):
            m.lin("proj_hidden", "projection.0")
            m.lin("proj_out", "projection.2")
        else:
            m.lin("proj_out", "projection")
        return m
    mlp = m.has("proj_hidden_w")
    per = lambda stem, leaf: [f"projections.{c}{stem}.{leaf}" for c in range(n_channels)]
    if mlp:
        m.joined("proj_hidden_w", per(".0", "weight"), "stack_t")
        m.joined("proj_hidden_b", per(".0", "bias"), "stack")
    last = ".2" if mlp else ""
    m.joined("proj_out_w", per(last, "weight"), "stack_t")
    m.joined("proj_out_b", per(last, "bias"), "stack")
    return m


def _check_position_enc(g: Graft) -> None:
    """HF keeps the positional encoding as a parameter; the port's is the
    constant normalised sincos table. Accept it only while it is that table."""
    from llm_bci_tpu_torch.models.patchtst import sincos_position_encoding

    key = "encoder.positional_encoder.position_enc"
    if not g.has(key):
        return
    pe = g.take(key).float()
    ours = torch.from_numpy(sincos_position_encoding(pe.shape[0], pe.shape[1]))
    if not torch.allclose(pe, ours, atol=1e-4):
        raise ValueError(
            "PatchTST: the checkpoint's positional encoding differs from the sincos table "
            "(it was trained with positional_encoding_type != 'sincos' or updated in "
            "training) — not representable in this implementation")


def patchtst_state_dict_from_reference(load_dir: str, model,
                                       components: Sequence[str] = ("encoder", "decoder")
                                       ) -> Dict[str, torch.Tensor]:
    """A reference PatchTST checkpoint directory -> the port's state dict for
    ``components``, BatchNorm's running statistics included."""
    template = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    if "decoder" in components:
        gd = Graft(load_state_dict_file(os.path.join(load_dir, "decoder.bin")),
                   "PatchTST decoder")
        n_channels = model.config["encoder"]["num_input_channels"]
        gd.apply(patchtst_decoder_map(template, n_channels).entries, template, out)
        gd.finish()
    if "encoder" in components:
        g = Graft(load_state_dict_file(os.path.join(load_dir, "encoder.bin")),
                  "PatchTST encoder")
        g.apply(patchtst_encoder_map(template).entries, template, out)
        _check_position_enc(g)
        g.finish(ignore=PATCHTST_IGNORE)
    return out


# -- BCI: the inner NDT1, the projector, the LLM -----------------------------

_PEFT_LORA_RE = re.compile(
    r"base_model\.model\.model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+)\."
    r"lora_(A|B)(?:\.default)?\.weight")


def validate_peft_adapter_config(cfg_path: str, expect_r: Optional[int],
                                 expect_alpha: Optional[float]) -> None:
    """``adapter_config.json`` against the live model's LoRA: a uniform rank
    and scale alpha / r (no ``rank_pattern`` / ``alpha_pattern``, no
    ``use_rslora``), and ``r`` / ``lora_alpha`` equal to the model's."""
    if not os.path.isfile(cfg_path):
        return
    with open(cfg_path) as f:
        acfg = json.load(f)
    if acfg.get("rank_pattern") or acfg.get("alpha_pattern"):
        raise ValueError(
            f"peft adapter {cfg_path!r} uses per-module rank_pattern/alpha_pattern — our "
            "Llama applies one uniform lora_r/lora_alpha")
    if acfg.get("use_rslora"):
        raise ValueError(
            f"peft adapter {cfg_path!r} was trained with use_rslora (alpha/sqrt(r) scaling) "
            "— our Llama scales by alpha/r")
    a_r, a_alpha = acfg.get("r"), acfg.get("lora_alpha")
    if expect_r is not None and a_r is not None and int(a_r) != int(expect_r):
        raise ValueError(
            f"peft adapter was trained with r={a_r} but the model is configured with "
            f"lora.r={expect_r} — set method.model_kwargs.lora.r={a_r} to import it")
    if expect_alpha is not None and a_alpha is not None and float(a_alpha) != float(expect_alpha):
        raise ValueError(
            f"peft adapter was trained with lora_alpha={a_alpha} but the model is configured "
            f"with lora.alpha={expect_alpha}: the deltas would be mis-scaled by "
            f"{float(expect_alpha) / float(a_alpha):g}× — set "
            f"method.model_kwargs.lora.alpha={a_alpha} to import it")


def lora_state_dict_from_peft_adapter(adapter_path: str, template: Dict[str, torch.Tensor],
                                      prefix: str = "", expect_r: Optional[int] = None,
                                      expect_alpha: Optional[float] = None
                                      ) -> Dict[str, torch.Tensor]:
    """A PEFT LoRA adapter file -> the port Llama's ``lora_A`` (in, r) /
    ``lora_B`` (r, out) under ``prefix`` (PEFT stores the transposes). The
    adapter's ``adapter_config.json`` beside it is validated first."""
    validate_peft_adapter_config(
        os.path.join(os.path.dirname(adapter_path), "adapter_config.json"), expect_r,
        expect_alpha)
    g = Graft(load_state_dict_file(adapter_path), "peft LoRA adapter")
    out: Dict[str, torch.Tensor] = {}
    for key in list(g.sd):
        m = _PEFT_LORA_RE.fullmatch(key)
        if not m:
            raise ValueError(f"peft adapter: unrecognized key {key!r}")
        layer, block, proj, ab = m.groups()
        name = f"{prefix}model.layers.{layer}.{block}.{proj}.lora_{ab}"
        if name not in template:
            raise ValueError(
                f"peft adapter targets {block}.{proj} but the model was built without LoRA "
                "there (check lora target_modules / lora_r)")
        g.put(out, template, name, g.take(key).t())
    g.finish()
    if not out:
        raise ValueError(f"peft adapter {adapter_path!r} held no LoRA weights")
    return out


def find_peft_adapter(load_dir: str) -> Optional[str]:
    for name in ("adapter_model.safetensors", "adapter_model.bin"):
        path = os.path.join(load_dir, name)
        if os.path.isfile(path):
            return path
    return None


def hf_weight_files(load_dir: Optional[str]) -> List[str]:
    """The full Hugging Face weight files of ``load_dir`` beside its
    ``config.json`` (safetensors shards first), or none."""
    if not load_dir or not os.path.isfile(os.path.join(load_dir, "config.json")):
        return []
    for pattern in ("model*.safetensors", "pytorch_model*.bin"):
        files = sorted(glob.glob(os.path.join(load_dir, pattern)))
        if files:
            return files
    return []


def read_hf_llama_weights(load_dir: str, tie_word_embeddings: bool) -> Dict[str, torch.Tensor]:
    """A Hugging Face Llama directory's weights under their names, which are
    the port Llama's (``model.layers.{i}.self_attn.q_proj.weight`` ...)."""
    sd: Dict[str, torch.Tensor] = {}
    for path in hf_weight_files(load_dir):
        sd.update(load_state_dict_file(path))
    sd = {k: v for k, v in sd.items() if not k.endswith("inv_freq")}
    if tie_word_embeddings:
        sd.pop("lm_head.weight", None)
    return sd


def bci_state_dict_from_reference(load_dir: str, model) -> Dict[str, torch.Tensor]:
    """A reference BCI checkpoint directory -> the port BCI's state dict:

    * the inner NDT1's ``encoder.bin`` (its vestigial ``decoder.bin`` is
      skipped: the BCI forward never calls it);
    * ``projector.bin``, a single Linear or the ``0`` / ``2`` Sequential;
    * the LLM: full Hugging Face weights from the directory or else from the
      model's ``llm_path`` (a frozen base, put into the model's quantization
      layout first), and / or a PEFT adapter. Base leaves that neither
      provides keep their values."""
    from llm_bci_tpu_torch.models.llama import adapt_state_dict_quantization

    template = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    _graft_ndt1_encoder(load_dir, template, "ndt1_encoder.", out, "BCI ndt1")

    gp = Graft(load_state_dict_file(os.path.join(load_dir, "projector.bin")), "projector")
    m = KeyMap(template)
    if gp.has("weight"):       # a single Linear (inter_size: null)
        if model.projector_in is not None:
            raise ValueError("BCI: checkpoint projector is a single Linear but the model was "
                             "configured with projector.inter_size")
        m.one("projector_out.weight", "weight")
        if m.has("projector_out.bias"):
            m.one("projector_out.bias", "bias")
    else:
        m.lin("projector_in", "0")
        m.lin("projector_out", "2")
    gp.apply(m.entries, template, out)
    gp.finish()

    base_dir = next((d for d in (load_dir, model.config.get("llm_path")) if hf_weight_files(d)),
                    None)
    if base_dir is not None:
        hf = read_hf_llama_weights(base_dir, model.llama_config.tie_word_embeddings)
        hf = adapt_state_dict_quantization(hf, model.llm.state_dict())
        gl = Graft({f"llm.{k}": v for k, v in hf.items()}, "BCI llm")
        for key in list(gl.sd):
            gl.put(out, template, key, gl.take(key))
    adapter = find_peft_adapter(load_dir)
    if adapter is not None:
        lora = model.lora_r > 0
        out.update(lora_state_dict_from_peft_adapter(
            adapter, template, "llm.", expect_r=model.lora_r if lora else None,
            expect_alpha=model.lora_alpha if lora else None))
    if base_dir is None and adapter is None:
        raise ValueError(
            f"BCI: {load_dir!r} holds neither full HF weights nor a peft adapter — nothing to "
            "import for the LLM (pass llm_dir for the base)")
    return out
