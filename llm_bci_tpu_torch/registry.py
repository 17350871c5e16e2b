"""Model registry of the port.

The port keeps its own ``NAME2MODEL``: the JAX package's dict is one
process-global table, and a process that imports both packages (every
parity test does) would otherwise have the two ``"NDT1"`` entries overwrite
each other. Datasets are host-side numpy and shared, so ``NAME2DATASET`` is
the JAX package's own table.
"""
from __future__ import annotations

from typing import Callable, Dict, Type

from llm_bci_tpu.registry import NAME2DATASET  # noqa: F401  (shared)

NAME2MODEL: Dict[str, Type] = {}


def register_model(name: str) -> Callable[[Type], Type]:
    def deco(cls: Type) -> Type:
        NAME2MODEL[name] = cls
        return cls

    return deco
