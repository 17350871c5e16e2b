"""Behaviour-decoding evaluation: choice classification or wheel-speed
regression (counterpart of ``llm_bci_tpu/eval/behaviour_decoding.py``).

The test set goes through ``trainer.evaluate`` with one probe metric fn in
place of the trainer's own, which collects every batch's ``preds`` and
``targets`` on the host; then ``acc`` of the argmax (classification) or the
regression metrics (``r2`` by default; ``mse``, ``mae``) of
:func:`llm_bci_tpu_torch.eval.metrics.metrics_list`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from llm_bci_tpu_torch.eval.metrics import metrics_list


def behaviour_decoding_eval(
    trainer,
    is_cls: bool,
    regression_metrics: Optional[List[str]] = None,
) -> Dict[str, float]:
    regression_metrics = regression_metrics or ["r2"]
    all_batches = []

    def probe(model, model_inputs, unused_inputs, outputs, **kwargs):
        all_batches.append({
            k: v.detach().float().cpu().numpy() for k, v in outputs.items()
            if torch.is_tensor(v) and v.dim() > 0
        })
        return 0.0

    saved = trainer.metric_fns
    trainer.metric_fns = {"probe": probe}
    try:
        trainer.evaluate(eval_train_set=False)
    finally:
        trainer.metric_fns = saved

    preds = np.concatenate([b["preds"] for b in all_batches], axis=0)
    targets = np.concatenate([b["targets"] for b in all_batches], axis=0)
    if is_cls:
        return metrics_list(
            targets=targets.squeeze(-1) if targets.ndim > 1 else targets,
            preds=np.argmax(preds, axis=-1),
            metrics=["acc"],
        )
    return metrics_list(targets=targets, preds=preds, metrics=regression_metrics)
