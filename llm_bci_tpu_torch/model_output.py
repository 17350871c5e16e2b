"""Model output contract (counterpart of ``llm_bci_tpu/model_output.py``).

Every model's ``forward`` returns a :class:`ModelOutput` carrying at least
``loss`` and ``n_examples``; the trainer averages ``sum(loss) /
sum(n_examples)`` over steps.

:class:`ModelOutput` and each subclass are pytree nodes, so that code which
walks a forward's output with ``torch.utils._pytree`` finds its tensors.
FSDP2 does: it hooks the root group's backward on the output's tensors, and
where it finds none (torch 2.11 flattens an unregistered dataclass to one
opaque leaf) the root group's gradients are never reduced into its
parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree


def _flatten(out: "ModelOutput"):
    names = tuple(f.name for f in dataclasses.fields(out))
    return [getattr(out, name) for name in names], names


def _register(cls: type) -> None:
    _pytree.register_pytree_node(
        cls, _flatten, lambda values, names: cls(**dict(zip(names, values))),
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")


@dataclasses.dataclass
class ModelOutput:
    loss: Optional[torch.Tensor] = None
    n_examples: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    preds: Optional[torch.Tensor] = None
    targets: Optional[torch.Tensor] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _register(cls)

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


_register(ModelOutput)
