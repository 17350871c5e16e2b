"""Component checkpoints and ``from_pt`` warm start of NDT1, iTransformer
and PatchTST (counterpart of the JAX models' ``save_checkpoint`` /
``save_config`` / ``load_checkpoint_params`` / ``warm_start_params``).

The port's own format, a ``STEP{n}/`` directory of the trainer:

* ``encoder.pt``: the tensors under ``encoder.``, that prefix dropped (so a
  BCI reads an NDT1 trunk's blob as it is); ``decoder.pt``: every other
  tensor, under the model's own names; buffers included (PatchTST's BatchNorm
  running statistics);
* ``{component}_config.yaml`` for each component whose config is saved
  (NDT1: the encoder's; iTransformer and PatchTST: both).

A directory that holds the reference's ``{component}.bin`` and not the
port's ``.pt`` is imported through :mod:`llm_bci_tpu_torch.interop.torch_import`.
``from_config`` merges each ``from_pt`` directory's saved component config
over the live one and keeps the ``from_pt`` (:func:`remerge_saved_configs`),
so the warm-started model has the trained one's structure.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import yaml

from llm_bci_tpu_torch.config import to_plain_dict, update_config
from llm_bci_tpu_torch.interop.torch_import import (
    component_keys,
    is_torch_checkpoint,
    load_saved_component_config,
)

COMPONENTS = ("encoder", "decoder")


def remerge_saved_configs(cfg, components: Sequence[str]) -> None:
    """Merge the config saved beside each component's ``from_pt`` over
    ``cfg[component]`` in place, keeping that ``from_pt`` (the saved config
    may carry a stale one of its own pretraining)."""
    for comp in components:
        pt = (cfg.get(comp) or {}).get("from_pt")
        if pt:
            saved = load_saved_component_config(pt, comp)
            if saved is not None:
                cfg[comp] = update_config(cfg[comp], saved)
            cfg[comp]["from_pt"] = pt


class ComponentCheckpoints:
    """Mixin of an ``nn.Module`` with a ``config`` holding ``encoder`` (and
    ``decoder``) sections. A family supplies :meth:`reference_state`."""

    CONFIG_COMPONENTS: Sequence[str] = COMPONENTS

    def reference_state(self, load_dir: str, components: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The model's tensors of ``components`` from a reference-format directory."""
        raise NotImplementedError

    def save_checkpoint(self, save_dir: str, include_frozen: bool = True,
                        state: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """``encoder.pt`` and ``decoder.pt``. ``include_frozen`` is the
        trainer's ``component_blobs``; every tensor of these models trains, so
        both blobs are whole either way. ``state`` is the ``state_dict`` to
        write (a multi-device trainer hands in the gathered whole one)."""
        sd = self.state_dict() if state is None else state
        for comp in COMPONENTS:
            strip = len("encoder.") if comp == "encoder" else 0
            blob = {k[strip:]: sd[k] for k in component_keys(sd, comp)}
            torch.save(blob, os.path.join(save_dir, f"{comp}.pt"))

    def save_config(self, save_dir: str) -> None:
        for comp in self.CONFIG_COMPONENTS:
            with open(os.path.join(save_dir, f"{comp}_config.yaml"), "w") as f:
                yaml.safe_dump(to_plain_dict(self.config[comp]), f)

    def component_blob(self, load_dir: str, component: str) -> Optional[Dict[str, torch.Tensor]]:
        """``component``'s tensors in ``load_dir`` under the model's names: the
        reference's ``.bin`` imported, or the port's ``.pt``; None when the
        directory holds neither."""
        if is_torch_checkpoint(load_dir, component):
            return self.reference_state(load_dir, (component,))
        path = os.path.join(load_dir, f"{component}.pt")
        if not os.path.isfile(path):
            return None
        blob = torch.load(path, map_location="cpu", weights_only=True)
        prefix = "encoder." if component == "encoder" else ""
        return {prefix + k: v for k, v in blob.items()}

    def load_component(self, component: str, sd: Dict[str, torch.Tensor]) -> None:
        """Load ``sd``, which must hold exactly the model's tensors of
        ``component``, each of the model's shape."""
        want = set(component_keys(self.state_dict(), component))
        if set(sd) != want:
            raise RuntimeError(
                f"{component} blob does not fit the model: missing {sorted(want - set(sd))[:8]}, "
                f"unexpected {sorted(set(sd) - want)[:8]}")
        self.load_state_dict(sd, strict=False)

    def load_checkpoint_params(self, load_dir: str,
                               components: Sequence[str] = COMPONENTS) -> None:
        """Load each of ``components`` that ``load_dir`` holds."""
        for comp in components:
            sd = self.component_blob(load_dir, comp)
            if sd is not None:
                self.load_component(comp, sd)

    def warm_start(self) -> None:
        """``encoder.from_pt`` and ``decoder.from_pt``: that component from
        that directory, which must hold it."""
        for comp in COMPONENTS:
            pt = (self.config.get(comp) or {}).get("from_pt")
            if pt:
                sd = self.component_blob(pt, comp)
                if sd is None:
                    raise FileNotFoundError(f"from_pt dir {pt!r} holds no {comp}.pt or {comp}.bin")
                self.load_component(comp, sd)
