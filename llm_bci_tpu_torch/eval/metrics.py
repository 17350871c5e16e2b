# Mirrors llm_bci_tpu/eval/metrics.py (host code that imports no JAX): the port keeps its own copy.
"""Shared eval metrics: Poisson NLL / bits-per-spike (NLB convention) and
regression/classification summaries.

Reimplements reference ``utils/eval_co_smoothing.py:245-316`` and
``utils/eval_behaviour_decoding.py:12-31``. Host-side numpy (eval only).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
from scipy.special import gammaln


def neg_log_likelihood(rates: np.ndarray, spikes: np.ndarray, zero_warning: bool = True) -> float:
    """Total Poisson NLL of ``spikes`` under predicted ``rates``:
    ``r - n*log(r) + log(n!)`` summed over all bins."""
    assert spikes.shape == rates.shape, (
        f"neg_log_likelihood: Rates and spikes should be of the same shape. "
        f"spikes: {spikes.shape}, rates: {rates.shape}"
    )
    rates = np.asarray(rates, dtype=np.float64).copy()
    spikes = np.asarray(spikes, dtype=np.float64)
    if np.any(np.isnan(spikes)):
        mask = np.isnan(spikes)
        rates = rates[~mask]
        spikes = spikes[~mask]
    assert not np.any(np.isnan(rates)), "neg_log_likelihood: NaN rate predictions found"
    assert np.all(rates >= 0), "neg_log_likelihood: Negative rate predictions found"
    if np.any(rates == 0):
        if zero_warning:
            warnings.warn("neg_log_likelihood: zero rate predictions; replacing with 1e-9")
        rates[rates == 0] = 1e-9
    return float(np.sum(rates - spikes * np.log(rates) + gammaln(spikes + 1.0)))


def bits_per_spike(rates: np.ndarray, spikes: np.ndarray) -> float:
    """Log-likelihood improvement (base 2) over the mean-rate null model,
    per spike (the NLB co-smoothing metric)."""
    nll_model = neg_log_likelihood(rates, spikes)
    null_rates = np.tile(
        np.nanmean(spikes, axis=tuple(range(spikes.ndim - 1)), keepdims=True),
        spikes.shape[:-1] + (1,),
    )
    nll_null = neg_log_likelihood(null_rates, spikes, zero_warning=False)
    if np.nanmean(spikes) == 0:
        return float("nan")
    return float((nll_null - nll_model) / np.nansum(spikes) / np.log(2))


def r2_score_np(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0


def metrics_list(
    targets: np.ndarray,
    preds: np.ndarray,
    metrics: Optional[List[str]] = None,
) -> Dict[str, float]:
    """Per-metric summary (reference ``utils/eval_behaviour_decoding.py:12-31``);
    ``r2`` averages per-trial R2 across the leading axis."""
    metrics = metrics or ["r2", "mse", "mae", "acc"]
    results: Dict[str, float] = {}
    if "r2" in metrics:
        results["r2"] = float(
            np.mean([r2_score_np(targets[i], preds[i]) for i in range(targets.shape[0])])
        )
    if "mse" in metrics:
        results["mse"] = float(np.mean((targets - preds) ** 2))
    if "mae" in metrics:
        results["mae"] = float(np.mean(np.abs(targets - preds)))
    if "acc" in metrics:
        results["acc"] = float(np.mean(np.asarray(targets).ravel() == np.asarray(preds).ravel()))
    return results
