"""Model output contract (counterpart of ``llm_bci_tpu/model_output.py``).

Every model's ``forward`` returns a :class:`ModelOutput` carrying at least
``loss`` and ``n_examples``; the trainer averages ``sum(loss) /
sum(n_examples)`` over steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class ModelOutput:
    loss: Optional[torch.Tensor] = None
    n_examples: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    preds: Optional[torch.Tensor] = None
    targets: Optional[torch.Tensor] = None

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
