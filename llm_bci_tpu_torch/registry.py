"""Model and dataset registries of the port (counterpart of
``llm_bci_tpu/registry.py``).

The port keeps its own ``NAME2MODEL`` and ``NAME2DATASET``: it imports
nothing of the JAX package, and a process that imports both packages (every
parity test does) must not have the two ``"NDT1"`` entries overwrite each
other in one table.
"""
from __future__ import annotations

from typing import Callable, Dict, Type

NAME2MODEL: Dict[str, Type] = {}
NAME2DATASET: Dict[str, Type] = {}


def register_model(name: str) -> Callable[[Type], Type]:
    def deco(cls: Type) -> Type:
        NAME2MODEL[name] = cls
        return cls

    return deco


def register_dataset(name: str) -> Callable[[Type], Type]:
    def deco(cls: Type) -> Type:
        NAME2DATASET[name] = cls
        return cls

    return deco
