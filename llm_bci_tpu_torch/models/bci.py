"""BCI — spike encoder -> projector -> prompt-spliced Llama LM (counterpart
of ``llm_bci_tpu/models/bci.py``).

The NDT1 trunk's stacked frames are projected to the LLM width and spliced
into the embedded prompt at ``input_split`` (:func:`splice_embeds`, one
gather); the LoRA-adapted Llama of :mod:`llm_bci_tpu_torch.models.llama`
emits the sentence. With ``quant="int8"`` every product with the frozen base
goes through the hand-written int8 kernel (``ops/quant.py``).

* The frozen / trainable split is ``requires_grad`` (the JAX package's
  ``trainable_mask``): with LoRA or ``freeze_llm`` only ``lora_A`` /
  ``lora_B`` train inside the LLM; the encoder and the projector always
  train.
* ``block_idx`` / ``day_idx`` go to the encoder by keyword, and only the
  encoder of NDT1 is built (no CTC head), as in the JAX package.
* The trunk's ``stack.pad_to_multiple`` is forced to 1: padded frames would
  occupy prompt positions and shift every later token.
* Checkpoints are the port's own: ``llm.pt``, ``encoder.pt`` and
  ``projector.pt`` (``state_dict``s) beside ``projector_config.yaml``,
  ``encoder_config.yaml`` and ``llama_config.yaml``; ``from_pt`` re-merges
  the saved projector and encoder configs, and refuses a directory that holds
  a component's weights without its config. A reference-format directory
  (the inner NDT1's ``encoder.bin``, ``projector.bin``, the LLM as Hugging
  Face weights and / or a PEFT adapter, the configs as ``.pth``) is imported
  by ``interop/torch_import.py``, the base weights put into this model's
  quantization layout first; ``interop/torch_export.py`` writes one.
* Every leaf of the LLM is created on ``device`` in its storage dtype.
* Sequence parallelism (``seq_shard``, :meth:`BCI.sequence_layout`): the
  NDT1 trunk runs on the rank's frames as NDT1 does under ``sp``; its output
  (the trunk's width, not the LLM's) and frame mask are gathered over the
  group, and the projector, the splice, the Llama and its LoRA factors run
  on the whole on every ``sp`` rank (the int8 base through its kernel on
  each). The loss is then the whole one on every rank, and the gather's
  backward sums the trunk's gradient over the group.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import yaml

from llm_bci_tpu_torch.config import resolve_path, to_plain_dict, update_config
from llm_bci_tpu_torch.interop.torch_import import (
    bci_state_dict_from_reference,
    hf_weight_files,
    is_torch_checkpoint,
    load_saved_component_config,
    ndt1_encoder_state_dict_from_reference,
)
from llm_bci_tpu_torch.model_output import ModelOutput
from llm_bci_tpu_torch.models.generation import check_generation_args, decode
from llm_bci_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    load_base_state_dict,
    load_hf_llama_params,
    load_llm_state,
)
from llm_bci_tpu_torch.models.ndt1 import ACT2FN, NeuralEncoder
from llm_bci_tpu_torch.ops.losses import cross_entropy_loss
from llm_bci_tpu_torch.parallel.sequence import SequenceShard, all_gather_time, gather_time
from llm_bci_tpu_torch.registry import register_model

DEFAULT_CONFIG = "configs/bci.yaml"
DTYPES = {None: torch.bfloat16, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "fp32": torch.float32,
          "float16": torch.float16, "fp16": torch.float16}


@dataclasses.dataclass
class BCIOutput(ModelOutput):
    pass


def splice_embeds(
    text: torch.Tensor,          # (B, L, H) or (B, L)
    spikes: torch.Tensor,        # (B, S, H) or (B, S)
    input_split: torch.Tensor,   # (B,) insertion offset d
) -> torch.Tensor:               # (B, L + S, ...)
    """Per-example insertion of ``spikes`` into ``text`` at position ``d``:
    ``out = [text[:d], spikes, text[d:]]``, as one gather."""
    B, L = text.shape[:2]
    S = spikes.shape[1]
    d = input_split.reshape(B, 1).long()
    j = torch.arange(L + S, device=text.device)[None, :]
    in_spike = (j >= d) & (j < d + S)                               # (B, L+S)
    text_idx = torch.where(j < d, j, j - S).clamp(0, L - 1)
    spike_idx = (j - d).clamp(0, S - 1)
    tail = text.shape[2:]
    widen = lambda idx: idx.reshape(idx.shape + (1,) * len(tail)).expand(-1, -1, *tail)
    t = torch.gather(text, 1, widen(text_idx))
    s = torch.gather(spikes, 1, widen(spike_idx))
    return torch.where(in_spike.reshape(in_spike.shape + (1,) * len(tail)), s, t)


@register_model("BCI")
class BCI(nn.Module):
    """End-to-end BCI model. ``config`` is a plain dict with the ``projector``
    and ``ndt1`` sub-configs (complete: :meth:`from_config` merges the
    defaults)."""

    def __init__(self, config: Dict[str, Any], llama_config: LlamaConfig,
                 method_name: str = "endtoend", lora_r: int = 0, lora_alpha: float = 32.0,
                 lora_dropout: float = 0.0, lora_targets: Sequence[str] = (),
                 freeze_llm: bool = False, dtype: torch.dtype = torch.bfloat16,
                 quant: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config, self.llama_config = config, llama_config
        self.method_name = method_name
        self.lora_r, self.lora_alpha, self.lora_dropout = lora_r, lora_alpha, lora_dropout
        self.lora_targets = tuple(lora_targets)
        self.freeze_llm, self.dtype, self.quant = freeze_llm, dtype, quant

        enc_cfg = dict(config["ndt1"]["encoder"])
        stack = enc_cfg.get("embedder", {}).get("stack", {})
        if stack.get("pad_to_multiple", 1) not in (None, 1):
            enc_cfg["embedder"] = {**enc_cfg["embedder"], "stack": {**stack, "pad_to_multiple": 1}}
        self.ndt1_encoder = NeuralEncoder(enc_cfg).to(device)
        self.llm = LlamaForCausalLM(
            llama_config, lora_r=lora_r, lora_alpha=lora_alpha, lora_dropout=lora_dropout,
            lora_targets=self.lora_targets, freeze_base=freeze_llm or lora_r > 0, dtype=dtype,
            remat=bool(config.get("llm_remat", False)), quant=quant, device=device,
            generator=generator,
        )
        proj = config["projector"]
        self.stacking = int(proj["stacking"])
        self._proj_act = proj["act"]
        n_in = self.ndt1_encoder.out_size * self.stacking
        if proj["inter_size"] is not None:
            self.projector_in = nn.Linear(n_in, proj["inter_size"], bias=proj["bias"],
                                          device=device)
            n_in = proj["inter_size"]
        else:
            self.projector_in = None
        self.projector_out = nn.Linear(n_in, llama_config.hidden_size, bias=proj["bias"],
                                       device=device)

    @classmethod
    def from_config(cls, model_config, **method_kwargs) -> "BCI":
        cfg = update_config(resolve_path(DEFAULT_CONFIG), model_config)
        cfg["ndt1"] = update_config(resolve_path("configs/ndt1.yaml"), cfg["ndt1"])
        pt_path = cfg.get("from_pt")
        ndt1_pt = pt_path or method_kwargs.get("load_ndt1_from_pt")
        if ndt1_pt:
            cfg["ndt1"]["encoder"]["from_pt"] = ndt1_pt
        if pt_path:
            # Re-merge the component configs saved with the checkpoint (the
            # port's yaml or the reference's .pth), so the reloaded model has
            # the structure of the trained one.
            saved = load_saved_component_config(pt_path, "projector")
            if saved is not None:
                cfg["projector"] = update_config(cfg["projector"], saved)
            saved = load_saved_component_config(pt_path, "encoder")
            if saved is not None:
                cfg["ndt1"]["encoder"] = update_config(cfg["ndt1"]["encoder"], saved)
                cfg["ndt1"]["encoder"]["from_pt"] = ndt1_pt

        saved_llama_cfg = os.path.join(pt_path, "llama_config.yaml") if pt_path else None
        if bool(method_kwargs.get("debug", False)):
            llama_config = LlamaConfig.debug()
        elif saved_llama_cfg and os.path.exists(saved_llama_cfg):
            with open(saved_llama_cfg) as f:
                llama_config = LlamaConfig(**yaml.safe_load(f))
        else:
            llm_path = method_kwargs.get("llm_path")
            with open(os.path.join(llm_path, "config.json")) as f:
                llama_config = LlamaConfig.from_dict(json.load(f))
            cfg["llm_path"] = llm_path

        lora = method_kwargs.get("lora")
        lora_kwargs = {}
        if lora is not None:
            lora_kwargs = dict(
                lora_r=int(lora["r"]), lora_alpha=float(lora["alpha"]),
                lora_dropout=float(lora["dropout"]), lora_targets=tuple(lora["target_modules"]),
            )
        return cls(
            config=to_plain_dict(cfg), llama_config=llama_config,
            method_name=method_kwargs.get("method_name", "endtoend"),
            freeze_llm=bool(method_kwargs.get("freeze_llm", False)),
            dtype=DTYPES[method_kwargs.get("compute_dtype")],
            quant=method_kwargs.get("quantize"), device=method_kwargs.get("device"),
            **lora_kwargs,
        )

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        if self.projector_in is not None:
            x = ACT2FN[self._proj_act](self.projector_in(x))
        return self.projector_out(x)

    def sequence_layout(self, T: int, n_sp: int, index: int) -> SequenceShard:
        """What ``sp`` rank ``index`` of ``n_sp`` computes of a batch of ``T``
        bins: the NDT1 trunk's layout (its frames, halo and prefix tokens)."""
        return self.ndt1_encoder.sequence_layout(T, n_sp, index)

    def sequence_outputs(self) -> Tuple[Dict[str, int], bool]:
        """Every output of a time-sharded forward is whole on every rank (the
        LLM runs on the gathered frames), the loss too."""
        return {}, False

    def prepare_embeds(self, input_ids, attention_mask, input_split, spikes, spikes_mask,
                       spikes_timestamp, block_idx=None, day_idx=None, targets=None,
                       generator: Optional[torch.Generator] = None,
                       seq_shard: Optional[SequenceShard] = None):
        """The spliced ``(inputs_embeds float32, attention_mask, targets)``;
        with ``seq_shard`` the trunk runs on the rank's frames and its output
        is gathered before the projector."""
        text_embeds = self.llm.embed(input_ids)                     # (B, L, H)
        spikes_embeds, sp_mask, _ = self.ndt1_encoder(
            spikes, spikes_mask, spikes_timestamp, block_idx=block_idx, day_idx=day_idx,
            generator=generator, seq_shard=seq_shard,
        )                                                           # (B, T', h)
        if seq_shard is not None:
            frames = seq_shard.body()
            spikes_embeds = gather_time(spikes_embeds, frames)
            sp_mask = all_gather_time(sp_mask, frames)
        B, T, H = spikes_embeds.shape
        if T % self.stacking != 0:
            pad = -(-T // self.stacking) * self.stacking - T
            spikes_embeds = nn.functional.pad(spikes_embeds, (0, 0, 0, pad))
            sp_mask = nn.functional.pad(sp_mask, (0, pad))
            T += pad
        spikes_embeds = self._project(
            spikes_embeds.reshape(B, T // self.stacking, H * self.stacking))
        sp_mask = sp_mask.reshape(B, T // self.stacking, self.stacking)
        sp_mask = (sp_mask.sum(-1) == self.stacking).to(attention_mask.dtype)

        input_split = input_split.reshape(B)
        inputs_embeds = splice_embeds(text_embeds.float(), spikes_embeds.float(), input_split)
        attention_mask = splice_embeds(attention_mask, sp_mask, input_split)
        if targets is not None:
            targets = splice_embeds(targets, torch.full_like(sp_mask, -100).to(targets.dtype),
                                    input_split)
        return inputs_embeds, attention_mask, targets

    def forward(
        self,
        input_ids: torch.Tensor,          # (B, L)
        attention_mask: torch.Tensor,     # (B, L)
        input_split: torch.Tensor,        # (B,) or (B, 1)
        spikes: torch.Tensor,             # (B, T, N)
        spikes_mask: torch.Tensor,        # (B, T)
        spikes_timestamp: torch.Tensor,   # (B, T)
        spikes_lengths: Optional[torch.Tensor] = None,   # (B,), unused
        block_idx: Optional[torch.Tensor] = None,
        day_idx: Optional[torch.Tensor] = None,
        targets: Optional[torch.Tensor] = None,   # (B, L) token ids, -100 on the prompt
        generator: Optional[torch.Generator] = None,
        seq_shard: Optional[SequenceShard] = None,
    ) -> BCIOutput:
        inputs_embeds, attention_mask, targets = self.prepare_embeds(
            input_ids, attention_mask, input_split, spikes, spikes_mask, spikes_timestamp,
            block_idx, day_idx, targets, generator, seq_shard,
        )
        logits, _ = self.llm(inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                             generator=generator)
        loss = n_examples = None
        if targets is not None:
            shift_targets = targets[:, 1:]
            loss = cross_entropy_loss(logits[:, :-1, :], shift_targets).sum()
            n_examples = (shift_targets != -100).sum()
        return BCIOutput(loss=loss, n_examples=n_examples, preds=logits, targets=targets)

    # ------------------------------------------------------------ generation

    def prepare_generate(self, input_ids, attention_mask, input_split, spikes, spikes_mask,
                         spikes_timestamp, spikes_lengths=None, block_idx=None, day_idx=None):
        """The decode's prompt: ``(inputs_embeds (B, P, H) float32,
        attention_mask (B, P))``, the spike frames spliced into the embedded
        text (a serving archive's ``prepare`` program)."""
        return self.prepare_embeds(input_ids, attention_mask, input_split, spikes, spikes_mask,
                                   spikes_timestamp, block_idx, day_idx)[:2]

    def decode_step(self, embeds, mask, cache, cache_index):
        """One model call of a decode, the cache written in place at
        ``cache_index``: the prefill (``cache_index`` 0) and the token step
        (a 0-dim int64 tensor). ``(logits float32, cache)``."""
        return self.llm(inputs_embeds=embeds, attention_mask=mask, cache=cache,
                        cache_index=cache_index)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """Chosen token ids -> their embeddings."""
        return self.llm.embed(ids)

    @torch.no_grad()
    def generate(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        input_split: torch.Tensor,
        spikes: torch.Tensor,
        spikes_mask: torch.Tensor,
        spikes_timestamp: torch.Tensor,
        spikes_lengths: Optional[torch.Tensor] = None,
        block_idx: Optional[torch.Tensor] = None,
        day_idx: Optional[torch.Tensor] = None,
        max_new_tokens: int = 20,
        num_beams: int = 1,
        pad_token_id: int = 0,
        eos_token_id: int = 2,
        length_penalty: float = 1.0,
        early_stopping: bool = False,
        num_return_sequences: int = 1,
        num_beam_groups: int = 1,
        diversity_penalty: float = 0.0,
    ):
        """Greedy (``num_beams=1``), beam-search or diverse-beam-search decode
        from the spliced prompt, in eval mode; only the new tokens are
        returned. ``(B, max_new_tokens)`` ids when ``num_return_sequences ==
        1``, else a :class:`BeamResult` with the hypotheses sorted
        best-first. ``num_beam_groups == num_beams > 1`` selects diverse beam
        search. Each decode captures its token step as one CUDA graph on the
        card and replays it (``models/decode_graph.py``). The pieces are
        :meth:`prepare_generate`, :meth:`decode_step`, :meth:`embed_tokens`
        and :func:`~llm_bci_tpu_torch.models.generation.decode`, which a
        serving archive exports and runs apart (``serving.py``). Under an
        ``sp`` trainer (an eval metric fn's decode) every rank decodes the
        whole batch that it is handed, time axis and all, as the JAX
        trainer's decode takes the whole batch: nothing of a decode is
        time-sharded."""
        check_generation_args(num_beams, num_return_sequences, num_beam_groups)
        was_training = self.training
        self.eval()
        inputs_embeds, attn_mask = self.prepare_generate(
            input_ids, attention_mask, input_split, spikes, spikes_mask, spikes_timestamp,
            block_idx=block_idx, day_idx=day_idx,
        )
        B, P, _ = inputs_embeds.shape
        cache = self.llm.init_cache(B * max(num_beams, 1), P + max_new_tokens)
        result = decode(self.decode_step, self.embed_tokens, inputs_embeds, attn_mask, cache,
                        max_new_tokens, num_beams, pad_token_id, eos_token_id, length_penalty,
                        early_stopping, num_return_sequences, num_beam_groups,
                        diversity_penalty)
        self.train(was_training)
        return result

    # ---------------------------------------------------------- checkpoints

    def _projector_state(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.state_dict().items() if k.startswith("projector")}

    def save_checkpoint(self, save_dir: str, include_frozen: bool = True,
                        state: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """``llm.pt`` / ``encoder.pt`` / ``projector.pt``. With
        ``include_frozen=False`` the LLM blob keeps only the leaves that
        train (the LoRA factors): a frozen 7B base is gigabytes a save, and
        it reloads from ``llm_path``. ``state`` is the model's ``state_dict``
        to write (a multi-device trainer hands in the gathered whole one)."""
        state = self.state_dict() if state is None else state
        part = lambda prefix: {k[len(prefix):]: v for k, v in state.items()
                               if k.startswith(prefix)}
        llm = part("llm.")
        if not include_frozen:
            trains = {k for k, p in self.llm.named_parameters() if p.requires_grad}
            llm = {k: v for k, v in llm.items() if k in trains}
        torch.save(llm, os.path.join(save_dir, "llm.pt"))
        torch.save(part("ndt1_encoder."), os.path.join(save_dir, "encoder.pt"))
        torch.save({k: v for k, v in state.items() if k.startswith("projector")},
                   os.path.join(save_dir, "projector.pt"))

    def save_config(self, save_dir: str) -> None:
        for name, node in (("projector", self.config["projector"]),
                           ("encoder", self.config["ndt1"]["encoder"]),
                           ("llama", dataclasses.asdict(self.llama_config))):
            with open(os.path.join(save_dir, f"{name}_config.yaml"), "w") as f:
                yaml.safe_dump(to_plain_dict(node), f)

    def load_checkpoint_params(self, load_dir: str) -> None:
        """Load what :meth:`save_checkpoint` wrote (each blob optional).
        Every saved key must exist here; the LLM blob may lack frozen leaves
        only, and is put into this model's quantization layout first: a
        checkpoint trained on a bf16 base serves with ``quantize: int8``, and
        the other way round (:func:`~llm_bci_tpu_torch.models.llama.load_llm_state`).
        A reference-format directory is imported instead
        (:func:`~llm_bci_tpu_torch.interop.torch_import.bci_state_dict_from_reference`)."""
        if is_torch_checkpoint(load_dir):
            self.load_state_dict(bci_state_dict_from_reference(load_dir, self), strict=False)
            return
        load = lambda name: torch.load(os.path.join(load_dir, name), map_location="cpu",
                                       weights_only=True)
        if os.path.exists(os.path.join(load_dir, "llm.pt")):
            load_llm_state(self.llm, load("llm.pt"))
        if os.path.exists(os.path.join(load_dir, "encoder.pt")):
            self.ndt1_encoder.load_state_dict(load("encoder.pt"), strict=True)
        if os.path.exists(os.path.join(load_dir, "projector.pt")):
            saved = load("projector.pt")
            if set(saved) != set(self._projector_state()):
                raise RuntimeError(f"projector.pt does not fit: keys {sorted(saved)}")
            self.load_state_dict(saved, strict=False)

    def warm_start(self) -> None:
        """``from_pt``: the whole checkpoint. Else the NDT1 encoder from
        ``load_ndt1_from_pt`` (an NDT1 or BCI checkpoint's ``encoder.pt``, a
        reference-format ``encoder.bin``, or an older NDT1 trainer
        checkpoint's ``model.pt``) and the Llama base from a Hugging Face
        checkpoint under ``llm_path``, quantized when ``quant`` is set."""
        pt_path = self.config.get("from_pt")
        if pt_path:
            self.load_checkpoint_params(pt_path)
            return
        enc_pt = self.config["ndt1"]["encoder"].get("from_pt")
        if enc_pt:
            if is_torch_checkpoint(enc_pt):
                sd = ndt1_encoder_state_dict_from_reference(enc_pt, self.ndt1_encoder, "")
            elif os.path.exists(os.path.join(enc_pt, "encoder.pt")):
                sd = torch.load(os.path.join(enc_pt, "encoder.pt"), map_location="cpu",
                                weights_only=True)
            else:
                full = torch.load(os.path.join(enc_pt, "model.pt"), map_location="cpu",
                                  weights_only=True)
                sd = {k[len("encoder."):]: v for k, v in full.items()
                      if k.startswith("encoder.")}
            self.ndt1_encoder.load_state_dict(sd, strict=True)
        llm_path = self.config.get("llm_path")
        if hf_weight_files(llm_path):
            load_base_state_dict(
                self.llm, load_hf_llama_params(llm_path, self.llama_config, self.quant))
