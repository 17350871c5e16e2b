"""PhonemeLLM — phoneme-probability sequences spliced into an LLM prompt
(counterpart of ``llm_bci_tpu/models/phoneme_llm.py``).

The two-stage alternative to the end-to-end BCI model: CTC phoneme
posteriors (from a pretrained NDT1-CTC) go through the coupler MLP
(``coupler_in`` -> activation -> ``coupler_out``, ``configs/phoneme_coupler.yaml``)
into the LLM's embedding space and are spliced into the embedded prompt at
``input_split`` (:func:`~llm_bci_tpu_torch.models.bci.splice_embeds`).

* The LLM is the port's LoRA Llama (:mod:`llm_bci_tpu_torch.models.llama`)
  in the compute dtype (bf16 unless ``compute_dtype`` says otherwise); as in
  the JAX package there is no ``quantize`` option. With LoRA or
  ``freeze_llm`` only ``lora_A`` / ``lora_B`` train inside the LLM; the
  coupler always trains (``requires_grad``, the JAX ``trainable_mask``).
* ``generate`` runs greedy or beam search through
  :mod:`llm_bci_tpu_torch.models.generation`, each token step replayed from
  one CUDA graph a decode on the card, as ``BCI.generate`` does.
* Checkpoints are the port's own: ``llm.pt`` and ``coupler.pt``
  (``state_dict``s) beside ``coupler_config.yaml``.
* Under sequence parallelism (``parallelism.sp > 1``) its batch has no
  time-dim ``sp_keys`` (the posteriors are ``phoneme_probs``): every ``sp``
  rank computes the whole batch, as the JAX trainer keeps it replicated, and
  the trainer scales nothing.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import yaml

from llm_bci_tpu_torch.config import resolve_path, to_plain_dict, update_config
from llm_bci_tpu_torch.model_output import ModelOutput
from llm_bci_tpu_torch.models.bci import DTYPES, splice_embeds
from llm_bci_tpu_torch.models.generation import BeamResult, beam_search, greedy_decode
from llm_bci_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, load_llm_state
from llm_bci_tpu_torch.models.ndt1 import ACT2FN
from llm_bci_tpu_torch.ops.losses import cross_entropy_loss
from llm_bci_tpu_torch.registry import register_model

DEFAULT_CONFIG = "configs/phoneme_coupler.yaml"


@dataclasses.dataclass
class PhonemeLLMOutput(ModelOutput):
    pass


@register_model("PhonemeLLM")
class PhonemeLLM(nn.Module):
    """Coupler MLP + Llama over prompt-spliced phoneme embeddings. ``config``
    is the coupler config, a plain dict (complete: :meth:`from_config` merges
    the defaults)."""

    def __init__(self, config: Dict[str, Any], llama_config: LlamaConfig, lora_r: int = 0,
                 lora_alpha: float = 32.0, lora_dropout: float = 0.0,
                 lora_targets: Sequence[str] = (), freeze_llm: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config, self.llama_config = config, llama_config
        self.lora_r, self.freeze_llm, self.dtype = lora_r, freeze_llm, dtype
        self.llm = LlamaForCausalLM(
            llama_config, lora_r=lora_r, lora_alpha=lora_alpha, lora_dropout=lora_dropout,
            lora_targets=tuple(lora_targets), freeze_base=freeze_llm or lora_r > 0, dtype=dtype,
            device=device, generator=generator,
        )
        self.coupler_in = nn.Linear(config["input_size"], config["inter_size"],
                                    bias=config["bias"], device=device)
        self.coupler_out = nn.Linear(config["inter_size"], llama_config.hidden_size,
                                     bias=config["bias"], device=device)

    @classmethod
    def from_config(cls, model_config, **method_kwargs) -> "PhonemeLLM":
        cfg = update_config(resolve_path(DEFAULT_CONFIG), model_config)
        if method_kwargs.get("debug"):
            llama_config = LlamaConfig.debug()
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
            freeze_llm=bool(method_kwargs.get("freeze_llm", False)),
            dtype=DTYPES[method_kwargs.get("compute_dtype")],
            device=method_kwargs.get("device"), **lora_kwargs,
        )

    def _couple(self, phoneme_probs: torch.Tensor) -> torch.Tensor:
        # float32 under any autocast, as the JAX coupler's Dense (no dtype)
        # computes in the float32 of its params and posteriors
        with torch.autocast(phoneme_probs.device.type, enabled=False):
            x = self.coupler_in(phoneme_probs.float())
            return self.coupler_out(ACT2FN[self.config["act"]](x))

    def prepare_embeds(self, input_ids, attention_mask, input_split, phoneme_probs,
                       phonemes_mask, targets=None):
        """The spliced ``(inputs_embeds float32, attention_mask, targets)``."""
        text_embeds = self.llm.embed(input_ids)
        ph_embeds = self._couple(phoneme_probs)
        B = text_embeds.shape[0]
        input_split = input_split.reshape(B)
        inputs_embeds = splice_embeds(text_embeds.float(), ph_embeds.float(), input_split)
        attention_mask = splice_embeds(attention_mask, phonemes_mask.to(attention_mask.dtype),
                                       input_split)
        if targets is not None:
            targets = splice_embeds(targets, torch.full_like(phonemes_mask, -100).to(targets.dtype),
                                    input_split)
        return inputs_embeds, attention_mask, targets

    def forward(
        self,
        input_ids: torch.Tensor,          # (B, L)
        attention_mask: torch.Tensor,     # (B, L)
        input_split: torch.Tensor,        # (B,) or (B, 1)
        phoneme_probs: torch.Tensor,      # (B, P, vocab) CTC posteriors
        phonemes_mask: torch.Tensor,      # (B, P)
        targets: Optional[torch.Tensor] = None,   # (B, L) token ids, -100 on the prompt
        generator: Optional[torch.Generator] = None,
    ) -> PhonemeLLMOutput:
        inputs_embeds, attention_mask, targets = self.prepare_embeds(
            input_ids, attention_mask, input_split, phoneme_probs, phonemes_mask, targets)
        logits, _ = self.llm(inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                             generator=generator)
        loss = n_examples = None
        if targets is not None:
            shift_targets = targets[:, 1:]
            losses = cross_entropy_loss(logits[:, :-1, :], shift_targets)
            n_examples = (shift_targets != -100).sum()
            if self.config.get("loss_reduction", "sum") == "mean":
                loss = losses.sum() / n_examples.clamp(min=1)
            else:
                loss = losses.sum()
        return PhonemeLLMOutput(loss=loss, n_examples=n_examples, preds=logits, targets=targets)

    @torch.no_grad()
    def generate(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        input_split: torch.Tensor,
        phoneme_probs: torch.Tensor,
        phonemes_mask: torch.Tensor,
        max_new_tokens: int = 20,
        num_beams: int = 1,
        pad_token_id: int = 0,
        eos_token_id: int = 2,
        length_penalty: float = 1.0,
        num_return_sequences: int = 1,
    ):
        """Greedy (``num_beams=1``) or beam-search decode from the spliced
        prompt, in eval mode; only the new tokens are returned: ``(B,
        max_new_tokens)`` ids (the best beam), or a :class:`BeamResult` sorted
        best-first when ``num_return_sequences > 1``."""
        if num_return_sequences > max(num_beams, 1):
            raise ValueError("num_return_sequences must be <= num_beams")
        was_training = self.training
        self.eval()
        inputs_embeds, attn_mask, _ = self.prepare_embeds(
            input_ids, attention_mask, input_split, phoneme_probs, phonemes_mask)

        def decode_step(embeds, mask, cache, cache_index):
            return self.llm(inputs_embeds=embeds, attention_mask=mask, cache=cache,
                            cache_index=cache_index)

        B, P, _ = inputs_embeds.shape
        cache = self.llm.init_cache(B * max(num_beams, 1), P + max_new_tokens)
        common = (decode_step, self.llm.embed, inputs_embeds, attn_mask, cache, max_new_tokens)
        if num_beams <= 1:
            result = greedy_decode(*common, eos_token_id, pad_token_id)
        else:
            result = beam_search(*common, num_beams, eos_token_id, pad_token_id, length_penalty)
        self.train(was_training)
        if num_beams <= 1:
            return result
        if num_return_sequences <= 1:
            return result.sequences[:, 0]
        return BeamResult(sequences=result.sequences[:, :num_return_sequences],
                          scores=result.scores[:, :num_return_sequences])

    # ---------------------------------------------------------- checkpoints

    def _coupler_state(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.state_dict().items() if k.startswith("coupler")}

    def save_checkpoint(self, save_dir: str, include_frozen: bool = True) -> None:
        """``llm.pt`` and ``coupler.pt``. With ``include_frozen=False`` the LLM
        blob keeps only the leaves that train."""
        llm = self.llm.state_dict()
        if not include_frozen:
            trains = {k for k, p in self.llm.named_parameters() if p.requires_grad}
            llm = {k: v for k, v in llm.items() if k in trains}
        torch.save(llm, os.path.join(save_dir, "llm.pt"))
        torch.save(self._coupler_state(), os.path.join(save_dir, "coupler.pt"))

    def save_config(self, save_dir: str) -> None:
        with open(os.path.join(save_dir, "coupler_config.yaml"), "w") as f:
            yaml.safe_dump(to_plain_dict(self.config), f)

    def load_checkpoint_params(self, load_dir: str) -> None:
        """Load what :meth:`save_checkpoint` wrote (each blob optional). Every
        saved key must exist here; the LLM blob may lack frozen leaves only."""
        load = lambda name: torch.load(os.path.join(load_dir, name), map_location="cpu",
                                       weights_only=True)
        if os.path.exists(os.path.join(load_dir, "llm.pt")):
            load_llm_state(self.llm, load("llm.pt"))
        if os.path.exists(os.path.join(load_dir, "coupler.pt")):
            saved = load("coupler.pt")
            if set(saved) != set(self._coupler_state()):
                raise RuntimeError(f"coupler.pt does not fit: keys {sorted(saved)}")
            self.load_state_dict(saved, strict=False)
