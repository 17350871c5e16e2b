"""Serving export: the BCI decode and a model's inference forward as
``torch.export`` archives (counterpart of ``llm_bci_tpu/serving.py``).

A serving host needs only the archive (``.pt2``, written with
``package_pt2``), the weights and this package's ops: no model class, no
config. The weights stay **arguments** of the exported programs, as in the
JAX package: the archive holds the programs' graphs, their signatures and the
generation settings, never a weight and never the example inputs it was
traced with, so its size does not grow with the model (:func:`params_of`
gives the weights: the port's state dict, int8 codes and scales for an int8
base).

**Decode** (:func:`export_decode`). The JAX artifact is one program, a
``lax.scan`` over the whole decode. Here the decode loop stays host code
(``models/generation.py``) over four exported programs:

* ``prepare``: the batch -> the spliced prompt embeddings and mask;
* ``prefill``: the prompt through the LLM, the KV cache written in place;
* ``token_step``: one token at a 0-dim position tensor, the cache written in
  place; on the card the loader's decode captures it as one CUDA graph and
  replays it (``models/decode_graph.py``), as an in-process decode does;
* ``embed``: chosen ids -> embeddings.

Shapes are static, fixed by ``example_inputs`` and the generation settings.

**Forward** (:func:`export_forward`): ``training=False`` (eval mode), a plain
dict of the selected ``ModelOutput`` fields; ``const_inputs`` are baked into
the program, and the graph keeps only what the selected fields need (with
``outputs=("preds",)`` no CTC node is left). A forward that draws random
numbers (a ``force_active`` masker) draws them once at export from ``rngs``
(a ``torch.Generator`` or a seed) and the archive replays that one draw, as
the JAX artifact bakes its ``rngs`` key.

**Kernels.** The hand-written kernels are the ``torch.library`` custom ops
``llm_bci::{ctc_alpha,ctc_alpha_beta,flash_fwd,flash_bwd,int8_matmul}``. The
exported graph holds the op node and the op's dispatch key picks the
implementation when the program runs: on a CUDA tensor the kernel, on a CPU
tensor the plain version. So an archive exported on the CPU and moved to the
card (``device="cuda"``) runs the kernels there; the JAX package's CPU-host
exports embed the XLA fallbacks instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.overrides import TorchFunctionMode

from llm_bci_tpu_torch.models.generation import check_generation_args, decode

META_FILE = "serving.json"
# bytes a program may hold beside its graph (tables such as RoPE's): more
# means a weight was captured instead of taken as an argument
MAX_CONSTANT_BYTES = 16 << 20
_TRACE_META = ("stack_trace", "nn_module_stack", "source_fn_stack", "torch_fn", "from_node")


def params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The weights an archive of ``model`` takes: its state dict."""
    return dict(model.state_dict())


# ----------------------------------------------------------- fixed draws

# the draws of the port's forwards (maskers, noise, dropout, flash seeds, sampling)
_RANDOM = {torch.rand, torch.randn, torch.randint, torch.randperm, torch.poisson}


class FixedDraws(TorchFunctionMode):
    """Records every random draw of the code it runs (``draws=None``), or
    hands back the recorded draws in their order in place of new ones: a
    traced forward then holds the recorded tensors as constants."""

    def __init__(self, draws: Optional[Sequence[torch.Tensor]] = None):
        super().__init__()
        self.recording = draws is None
        self.draws = [] if draws is None else list(draws)
        self.used = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _RANDOM:
            return func(*args, **kwargs)
        if self.recording:
            out = func(*args, **kwargs)
            self.draws.append(out.detach().clone())
            return out
        if self.used >= len(self.draws):
            raise RuntimeError("export_forward: the traced forward draws more than the "
                               "recorded one")
        self.used += 1
        return self.draws[self.used - 1]


# ------------------------------------------------------------- programs

class _Call(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


class _Program(nn.Module):
    """``fn(model, *args)`` with ``model``'s tensors taken from ``params``
    (the first argument). The model is not a submodule of the program, so
    export lifts none of its tensors into the program."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        object.__setattr__(self, "_call", _Call(model, fn))

    def forward(self, params: Dict[str, torch.Tensor], *args):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self._call, named, args, strict=False)


def _export(model: nn.Module, fn: Callable, params: Dict[str, torch.Tensor], args: tuple,
            device, inline: bool = False) -> torch.export.ExportedProgram:
    ep = torch.export.export(_Program(model, fn), (params, *args), strict=False)
    if inline:
        # autocast and grad-mode regions become part of the one graph, so
        # that what the outputs do not need goes with the rest
        ep = ep.run_decompositions({})
    graph = ep.graph_module.graph
    graph.eliminate_dead_code()          # what the selected outputs do not need
    ep.graph_module.recompile()
    captured = sum(t.numel() * t.element_size()
                   for t in list(ep.state_dict.values()) + list(ep.constants.values())
                   if torch.is_tensor(t))
    if captured > MAX_CONSTANT_BYTES:
        raise RuntimeError(f"serving export: the program holds {captured} bytes of tensors "
                           "besides its arguments (a weight missing from params?)")
    ep.example_inputs = None             # the archive keeps no example input
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:  # where in Python each node was traced: half the bytes
                for key in _TRACE_META:
                    node.meta.pop(key, None)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, torch.device(device))
    return ep


def _spec(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch.")}


def _write(out_path: str, programs: Dict[str, torch.export.ExportedProgram], meta: dict) -> str:
    from torch.export.pt2_archive._package import package_pt2

    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    with warnings.catch_warnings():    # on its grouping of the (few) constant tables
        warnings.filterwarnings("ignore", message="No complete tensor found")
        package_pt2(out_path, exported_programs=programs,
                    extra_files={META_FILE: json.dumps(meta)})
    return out_path


def _under(fn: Callable, autocast: Optional[torch.dtype], device_type: str) -> Callable:
    """``fn`` traced inside ``torch.autocast(device_type, autocast)`` (an
    autocast around the export itself is not part of the program)."""
    if autocast is None:
        return fn

    def run(m, *args):
        with torch.autocast(device_type, dtype=autocast):
            return fn(m, *args)

    return run


def _inputs(example_inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in example_inputs.items() if v is not None}


def _select(params: Dict[str, torch.Tensor], keep: Callable[[str], bool]):
    return {k: v for k, v in params.items() if keep(k)}


def _prompt_key(key: str) -> bool:
    return not key.startswith("llm.") or key == "llm.model.embed_tokens.weight"


def export_decode(
    model,
    params: Dict[str, torch.Tensor],
    example_inputs: Dict[str, Any],
    out_path: str,
    *,
    max_new_tokens: int,
    num_beams: int = 1,
    num_return_sequences: int = 1,
    num_beam_groups: int = 1,
    diversity_penalty: float = 0.0,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
    eos_token_id: int = 2,
    pad_token_id: int = 0,
    device=None,
    autocast: Optional[torch.dtype] = None,
) -> str:
    """Export ``model``'s (a ``BCI``) decode as the programs ``prepare``,
    ``prefill``, ``token_step`` and ``embed`` into one ``.pt2`` archive at
    ``out_path``, with the generation settings and the signature of weights,
    inputs and cache beside them. ``example_inputs`` (the keys of
    ``BCI.generate``'s batch) fixes the shapes; the settings are baked in, one
    archive a serving configuration. ``device`` is where the archive's
    programs run (default: where they were traced); ``autocast`` (a dtype)
    traces each program under ``torch.autocast`` of the inputs' device type,
    as a decode served under autocast runs. Returns ``out_path``."""
    check_generation_args(num_beams, num_return_sequences, num_beam_groups)
    gen = dict(max_new_tokens=max_new_tokens, num_beams=num_beams,
               num_return_sequences=num_return_sequences, num_beam_groups=num_beam_groups,
               diversity_penalty=diversity_penalty, length_penalty=length_penalty,
               early_stopping=early_stopping, eos_token_id=eos_token_id,
               pad_token_id=pad_token_id)
    inputs = _inputs(example_inputs)
    prompt_params = _select(params, _prompt_key)
    llm_params = _select(params, lambda k: k.startswith("llm."))
    embed_params = _select(params, lambda k: k == "llm.model.embed_tokens.weight")
    dev_type = next(iter(inputs.values())).device.type
    export = lambda fn, p, args: _export(model, _under(fn, autocast, dev_type), p, args, device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), torch.autocast(dev_type, dtype=autocast or torch.bfloat16,
                                             enabled=autocast is not None):
            embeds, mask = model.prepare_generate(**inputs)
            B, P, _ = embeds.shape
            N = B * max(num_beams, 1)
            embeds = embeds.repeat_interleave(N // B, dim=0)
            key_mask = mask.new_zeros((N, P + max_new_tokens))
            cache = model.llm.init_cache(N, P + max_new_tokens)
            ids = torch.zeros((N, 1), dtype=torch.long, device=embeds.device)
            token = model.embed_tokens(ids)
            position = torch.zeros((), dtype=torch.long, device=embeds.device)
        with torch.no_grad():
            programs = {
                "prepare": export(lambda m, x: m.prepare_generate(**x), prompt_params,
                                  (inputs,)),
                "prefill": export(lambda m, e, k, c: m.decode_step(e, k, c, 0)[0], llm_params,
                                  (embeds, key_mask, cache)),
                "token_step": export(lambda m, e, k, c, i: m.decode_step(e, k, c, i)[0],
                                     llm_params, (token, key_mask, cache, position)),
                "embed": export(lambda m, i: m.embed_tokens(i), embed_params, (ids,)),
            }
    finally:
        model.train(was_training)
    meta = {
        "kind": "decode",
        "device": str(device if device is not None else embeds.device),
        "generation": gen,
        "autocast": str(autocast).removeprefix("torch.") if autocast else None,
        "params": {"prepare": list(prompt_params), "prefill": list(llm_params),
                   "token_step": list(llm_params), "embed": list(embed_params)},
        "param_specs": {k: _spec(v) for k, v in params.items()},
        "inputs": {k: _spec(v) for k, v in inputs.items()},
        "cache": {"layers": len(cache), "shape": list(cache[0]["k"].shape),
                  "dtype": str(cache[0]["k"].dtype).removeprefix("torch.")},
    }
    return _write(out_path, programs, meta)


def export_forward(
    model,
    params: Dict[str, torch.Tensor],
    example_inputs: Dict[str, Any],
    out_path: str,
    *,
    outputs: Sequence[str] = ("preds",),
    const_inputs: Optional[Dict[str, Any]] = None,
    rngs=None,
    device=None,
    autocast: Optional[torch.dtype] = None,
    **apply_kwargs,
) -> str:
    """Export ``model``'s inference forward (eval mode) as the program
    ``forward(params, inputs) -> {name: tensor}`` of the ``outputs`` fields.
    ``const_inputs`` and ``apply_kwargs`` are baked in; ``rngs`` (a
    ``torch.Generator`` or an int seed) fixes the forward's random draws at
    export; ``device`` and ``autocast`` as in :func:`export_decode`. Returns
    ``out_path``."""
    inputs = _inputs(example_inputs)
    const = dict(const_inputs or {})
    outputs = tuple(outputs)

    dev_type = next(iter(inputs.values())).device.type

    def forward(m, x):
        with torch.autocast(dev_type, dtype=autocast or torch.bfloat16,
                            enabled=autocast is not None):
            out = m(**x, **const, **apply_kwargs)
        return {k: getattr(out, k) for k in outputs}

    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            fn = forward
            if rngs is not None:
                generator = rngs
                if not isinstance(rngs, torch.Generator):
                    generator = torch.Generator(next(iter(inputs.values())).device)
                    generator.manual_seed(int(rngs))
                with FixedDraws() as recorder, torch.autocast(
                        dev_type, dtype=autocast or torch.bfloat16, enabled=autocast is not None):
                    model(**inputs, **const, **apply_kwargs, generator=generator)

                def fn(m, x):
                    with FixedDraws(recorder.draws):
                        return forward(m, x)

            ep = _export(model, fn, params, (inputs,), device, inline=True)
    finally:
        model.train(was_training)
    meta = {
        "kind": "forward",
        "device": str(device if device is not None else next(iter(inputs.values())).device),
        "outputs": list(outputs),
        "autocast": str(autocast).removeprefix("torch.") if autocast else None,
        "params": {"forward": list(params)},
        "param_specs": {k: _spec(v) for k, v in params.items()},
        "inputs": {k: _spec(v) for k, v in inputs.items()},
    }
    return _write(out_path, {"forward": ep}, meta)


@dataclasses.dataclass
class Archive:
    """A loaded archive: its programs (``ExportedProgram.module()``) and its
    ``serving.json``."""
    programs: Dict[str, nn.Module]
    meta: Dict[str, Any]
    exported: Dict[str, torch.export.ExportedProgram]

    def graph_targets(self, name: str) -> list:
        """The ops a program calls, as strings (``llm_bci.int8_matmul.default``)."""
        return [str(n.target) for gm in self.exported[name].graph_module.modules()
                if isinstance(gm, torch.fx.GraphModule)
                for n in gm.graph.nodes if n.op == "call_function"]


def load_archive(path: str, device=None) -> Archive:
    from torch.export.pt2_archive._package import load_pt2

    with warnings.catch_warnings():    # the read-only buffers of its constant tables
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        contents = load_pt2(path)
    meta = json.loads(contents.extra_files[META_FILE])
    exported = dict(contents.exported_programs)
    if device is not None and torch.device(device) != torch.device(meta["device"]):
        from torch.export.passes import move_to_device_pass

        exported = {k: move_to_device_pass(ep, torch.device(device))
                    for k, ep in exported.items()}
        meta["device"] = str(device)
    return Archive({k: _module(ep) for k, ep in exported.items()}, meta, exported)


def _module(ep: torch.export.ExportedProgram) -> nn.Module:
    """``ep.module()`` without its per-call check of every input against the
    graph's (some 14 ms a call over a 32-layer model's thousand weights, paid
    by each prefill and each eager token step): :func:`load_decode` checks
    the weights and inputs once a call against the archive's signature."""
    module = ep.module()
    for key, hook in list(module._forward_pre_hooks.items()):
        if getattr(hook, "__name__", "") == "_check_input_constraints_pre_hook":
            del module._forward_pre_hooks[key]
            module._forward_pre_hooks_with_kwargs.pop(key, None)
    return module


def _conform(specs: Dict[str, dict], tensors: Dict[str, torch.Tensor], what: str) -> None:
    for k, spec in specs.items():
        t = tensors[k]
        if list(t.shape) != spec["shape"] or str(t.dtype).removeprefix("torch.") != spec["dtype"]:
            raise ValueError(f"load_decode: {what} {k!r} is {tuple(t.shape)} {t.dtype}, the "
                             f"archive takes {tuple(spec['shape'])} {spec['dtype']}")


def load_decode(path: str, device=None):
    """Load an archive of :func:`export_decode` or :func:`export_forward`.

    Returns ``fn(params, inputs)``: a decode archive runs its programs
    through the port's ``greedy_decode`` / ``beam_search`` /
    ``diverse_beam_search`` (the token step captured as one CUDA graph on
    the card) and returns ``(B, max_new_tokens)`` ids, or a ``BeamResult``
    when exported with ``num_return_sequences > 1``; a forward archive
    returns its dict of outputs. No model class or config is needed.
    ``fn.signature`` holds the weights', inputs' (and cache's) shapes and
    dtypes, ``fn.device`` where the programs run (``device`` moves them), as
    the JAX loader exposes ``in_avals`` and ``platforms``; ``fn.archive`` the
    loaded programs; a decode archive's ``fn.parts(params, inputs)`` the
    pieces its decode runs (a caller's own loop over the token step)."""
    archive = load_archive(path, device)
    meta, programs = archive.meta, archive.programs
    dev = torch.device(meta["device"])

    used = {k for keys in meta["params"].values() for k in keys}
    pick = lambda name, params: {k: params[k] for k in meta["params"][name]}

    def batch(inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        got = _inputs(inputs)
        if set(got) != set(meta["inputs"]):
            raise KeyError(f"load_decode: inputs {sorted(got)}, the archive takes "
                           f"{sorted(meta['inputs'])}")
        _conform(meta["inputs"], got, "input")
        return {k: got[k] for k in meta["inputs"]}

    def weights(params: Dict[str, torch.Tensor]) -> None:
        missing = sorted(used - set(params))
        if missing:
            raise KeyError(f"load_decode: params lack {missing[:5]} ({len(missing)} keys)")
        _conform({k: meta["param_specs"][k] for k in used}, params, "weight")

    if meta["kind"] == "forward":
        def fn(params, inputs):
            weights(params)
            with torch.no_grad():
                return programs["forward"](pick("forward", params), batch(inputs))
    else:
        gen, cache_spec = meta["generation"], meta["cache"]

        def parts(params, inputs):
            """What ``fn`` hands to ``generation.decode``: ``(decode_step,
            embed_tokens, inputs_embeds, attention_mask, cache)`` over the
            loaded programs, the cache new and empty."""
            weights(params)
            embeds, mask = programs["prepare"](pick("prepare", params), batch(inputs))
            llm = pick("prefill", params)
            table = pick("embed", params)
            prefill, step, embed = programs["prefill"], programs["token_step"], programs["embed"]

            def decode_step(e, m, cache, cache_index):
                if torch.is_tensor(cache_index):
                    return step(llm, e, m, cache, cache_index), cache
                return prefill(llm, e, m, cache), cache

            dtype = getattr(torch, cache_spec["dtype"])
            cache = tuple({"k": torch.zeros(cache_spec["shape"], dtype=dtype, device=dev),
                           "v": torch.zeros(cache_spec["shape"], dtype=dtype, device=dev)}
                          for _ in range(cache_spec["layers"]))
            return decode_step, lambda ids: embed(table, ids), embeds, mask, cache

        @torch.no_grad()
        def fn(params, inputs):
            return decode(*parts(params, inputs), **gen)

        fn.parts = parts

    fn.signature = {k: meta[k] for k in ("param_specs", "inputs", "cache") if k in meta}
    fn.device = dev
    fn.archive = archive
    return fn
