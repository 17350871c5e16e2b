# Mirrors llm_bci_tpu/eval/viz_neuron_fit.py (host code that imports no JAX): the port keeps its own copy.
"""Single-neuron fit visualization: PSTH overlays, condition-averaged R²,
single-trial rasters with spectral clustering.

Functional port of reference ``utils/viz_neuron_fit.py`` (plot shapes and
R² definitions preserved); host-side numpy + matplotlib, eval only.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from llm_bci_tpu_torch.eval.metrics import r2_score_np


# ---------------------------------------------------------------- PSTH math

def compute_PSTH(X: np.ndarray, y: np.ndarray, axis, value) -> np.ndarray:
    """Mean activity over trials whose condition variables equal ``value``
    (reference ``viz_neuron_fit.py:313-315``)."""
    trials = np.all(X[:, 0, axis] == value, axis=-1)
    return y[trials].mean(0)


def compute_all_psth(X: np.ndarray, y: np.ndarray, idxs_psth) -> Dict[tuple, np.ndarray]:
    uni_vs = np.unique(X[:, 0, idxs_psth], axis=0)
    return {tuple(v): compute_PSTH(X, y, idxs_psth, v) for v in uni_vs}


def compute_R2_psth(psth_xy, psth_pred_xy, clip: bool = True):
    a = np.array([psth_xy[x] for x in psth_xy])
    b = np.array([psth_pred_xy[x] for x in psth_xy])
    K, T = a.shape[:2]
    a = a.reshape((K * T, -1))
    b = b.reshape((K * T, -1))
    r2s = np.array([r2_score_np(a[:, n], b[:, n]) for n in range(a.shape[1])])
    if clip:
        r2s = np.clip(r2s, 0.0, 1.0)
    return r2s[0] if len(r2s) == 1 else r2s


def compute_R2_main(y: np.ndarray, y_pred: np.ndarray, clip: bool = True):
    N = y.shape[-1]
    y = y.reshape((-1, N))
    y_pred = y_pred.reshape((-1, N))
    r2s = np.asarray([r2_score_np(y[:, n], y_pred[:, n]) for n in range(N)])
    return np.clip(r2s, 0.0, 1.0) if clip else r2s


def _cluster_sort(y: np.ndarray, n_clus: int = 8, n_neighbors: int = 5) -> np.ndarray:
    """Trial ordering by spectral clustering labels (reference
    ``viz_neuron_fit.py:135-145``); falls back to first-PC order when the
    trial count is too small for the clustering graph."""
    try:
        from sklearn.cluster import SpectralClustering

        clustering = SpectralClustering(
            n_clusters=min(n_clus, max(2, len(y) // 2)),
            n_neighbors=min(n_neighbors, max(2, len(y) - 1)),
            affinity="nearest_neighbors",
            assign_labels="discretize",
            random_state=0,
        ).fit(y)
        return np.argsort(clustering.labels_)
    except Exception:
        centered = y - y.mean(0)
        u, s, vt = np.linalg.svd(centered, full_matrices=False)
        return np.argsort(u[:, 0])


# ------------------------------------------------------------------- plots

def _add_baseline(ax, aligned_tbins=(40,)):
    for tbin in aligned_tbins:
        ax.axvline(x=tbin - 1, c="k", alpha=0.2)


def raster_plot(ts_, vmax, vmin, whether_cbar, ylabel, ax, cmap="bwr", aligned_tbins=(40,)):
    import matplotlib.pyplot as plt

    N, T = ts_.shape
    im = ax.imshow(ts_, aspect="auto", cmap=cmap, vmax=vmax, vmin=vmin)
    for tbin in aligned_tbins:
        ax.annotate(
            "", xy=(tbin - 1, N), xytext=(tbin - 1, N + 10),
            ha="center", va="center",
            arrowprops={"arrowstyle": "->", "color": "r"},
        )
    if whether_cbar:
        cbar = plt.colorbar(im, pad=0.01, shrink=0.6)
        cbar.ax.tick_params(rotation=90)
    if ylabel is not None:
        ax.set_ylabel(f"{ylabel}\n(#trials={N})")
        ax.set_xticks([])
        ax.set_yticks([])
        ax.spines[["left", "bottom", "right", "top"]].set_visible(False)
    else:
        ax.axis("off")


def plot_psth(
    X, y, y_pred, var_tasklist, var_name2idx, var_value2label,
    aligned_tbins=(), axes=None, legend=False, neuron_idx="", neuron_region="",
):
    import matplotlib.pyplot as plt

    if axes is None:
        _, axes = plt.subplots(1, len(var_tasklist), figsize=(3 * len(var_tasklist), 2))
    for ci, var in enumerate(var_tasklist):
        ax = axes[ci]
        psth_xy = compute_all_psth(X, y, var_name2idx[var])
        psth_pred_xy = compute_all_psth(X, y_pred, var_name2idx[var])
        for _i, _x in enumerate(psth_xy.keys()):
            ax.plot(
                psth_xy[_x], color=plt.get_cmap("tab10")(_i), linewidth=3, alpha=0.3,
                label=f"{var_value2label[var][tuple(_x)]}",
            )
            ax.plot(psth_pred_xy[_x], color=plt.get_cmap("tab10")(_i), linestyle="--")
            ax.set_xlabel("Time bin")
            if ci == 0:
                ax.set_ylabel("Neural activity")
            else:
                ax.sharey(axes[0])
        _add_baseline(ax, aligned_tbins=aligned_tbins)
        if legend:
            ax.legend()
            ax.set_title(f"{var}")

    idxs_psth = np.concatenate([var_name2idx[var] for var in var_tasklist])
    psth_xy = compute_all_psth(X, y, idxs_psth)
    psth_pred_xy = compute_all_psth(X, y_pred, idxs_psth)
    r2_psth = compute_R2_psth(psth_xy, psth_pred_xy, clip=False)
    r2_single_trial = compute_R2_main(
        y.reshape(-1, 1), y_pred.reshape(-1, 1), clip=False
    )[0]
    axes[0].set_ylabel(
        f"Neuron: #{str(neuron_idx)[:4]} \n PSTH R2: {r2_psth:.2f} "
        f"\n Avg_SingleTrial R2: {r2_single_trial:.2f}"
    )
    for ax in axes:
        ax.spines[["right", "top"]].set_visible(False)
    plt.tight_layout()
    return r2_psth, r2_single_trial


def plot_single_trial_activity(
    X, y, y_pred, var_name2idx, var_behlist, var_tasklist,
    subtract_psth="task", aligned_tbins=(), n_clus=8, n_neighbors=5,
    clusby="y_pred", cmap="bwr", vmax_perc=90, vmin_perc=10, axes=None,
):
    import matplotlib.pyplot as plt

    if axes is None:
        nrows = 2 + len(var_behlist) + 1 + 1
        _, axes = plt.subplots(nrows, 1, figsize=(8, 3 * nrows))

    if subtract_psth == "task":
        idxs_psth = np.concatenate([var_name2idx[var] for var in var_tasklist])
        psth_xy = compute_all_psth(X, y, idxs_psth)
        psth_pred_xy = compute_all_psth(X, y_pred, idxs_psth)
        y = y - np.asarray([psth_xy[tuple(x)] for x in X[:, 0, idxs_psth]])
        y_pred = y_pred - np.asarray([psth_pred_xy[tuple(x)] for x in X[:, 0, idxs_psth]])
    elif subtract_psth == "global":
        y = y - np.mean(y, 0)
        y_pred = y_pred - np.mean(y_pred, 0)
    elif subtract_psth is not None:
        raise ValueError("subtract_psth must be one of: task, global, None")
    y_residual = y_pred - y
    idxs_behavior = (
        np.concatenate([var_name2idx[var] for var in var_behlist]) if var_behlist else []
    )
    X_behs = X[:, :, idxs_behavior]

    t_sort = _cluster_sort(y_pred if clusby == "y_pred" else y, n_clus, n_neighbors)

    for ri, (toshow, label, ax) in enumerate(
        zip(
            [y, y_pred, X_behs, y_residual],
            [
                f"obs. act. \n (subtract_psth={subtract_psth})",
                f"pred. act. \n (subtract_psth={subtract_psth})",
                var_behlist,
                "residual act.",
            ],
            [axes[0], axes[1], axes[2:-2], axes[-2]],
        )
    ):
        if ri <= 1:
            vmax = np.percentile(y_pred, vmax_perc)
            vmin = np.percentile(y_pred, vmin_perc)
            raster_plot(toshow[t_sort], vmax, vmin, True, label, ax, cmap, aligned_tbins)
        elif ri == 2:
            for bi in range(len(var_behlist)):
                ts_ = toshow[:, :, bi][t_sort]
                raster_plot(
                    ts_, np.percentile(ts_, vmax_perc), np.percentile(ts_, vmin_perc),
                    True, label[bi], ax[bi], cmap, aligned_tbins,
                )
        else:
            vmax = np.percentile(toshow, vmax_perc)
            vmin = np.percentile(toshow, vmin_perc)
            raster_plot(toshow[t_sort], vmax, vmin, True, label, ax, cmap, aligned_tbins)

    t_sort_rd = _cluster_sort(y_residual, n_clus, n_neighbors)
    raster_plot(
        y_residual[t_sort_rd],
        np.percentile(y_residual, vmax_perc),
        np.percentile(y_residual, vmin_perc),
        True, "residual act. (re-clustered)", axes[-1],
    )
    plt.tight_layout()


def viz_single_cell(
    X, y, y_pred, var_name2idx, var_tasklist, var_value2label, var_behlist,
    subtract_psth="task", aligned_tbins=(), clusby="y_pred",
    neuron_idx="", neuron_region="", method="", mode="", save_path="figs",
):
    """PSTH + single-trial plots for one neuron; returns (r2_psth, r2_trial)
    (reference ``viz_neuron_fit.py:209-245``)."""
    import matplotlib.pyplot as plt

    nrows = 8
    plt.figure(figsize=(8, 2 * nrows))
    axes_psth = [plt.subplot(nrows, len(var_tasklist), k + 1) for k in range(len(var_tasklist))]
    r2_psth, r2_trial = plot_psth(
        X, y, y_pred, var_tasklist, var_name2idx, var_value2label,
        aligned_tbins, axes_psth, legend=True,
        neuron_idx=neuron_idx, neuron_region=neuron_region,
    )
    axes_single = [plt.subplot(nrows, 1, k) for k in range(2, 2 + 2 + len(var_behlist) + 2)]
    plot_single_trial_activity(
        X, y, y_pred, var_name2idx, var_behlist, var_tasklist,
        subtract_psth=subtract_psth, aligned_tbins=aligned_tbins,
        clusby=clusby, axes=axes_single,
    )
    os.makedirs(save_path, exist_ok=True)
    plt.savefig(
        os.path.join(
            save_path,
            f"{neuron_region}_{neuron_idx}_{r2_trial:.2f}_{method}_{mode}.png",
        )
    )
    plt.close()
    return r2_psth, r2_trial


def viz_single_cell_unaligned(
    gt, pred, neuron_idx, neuron_region, method, mode, save_path,
    n_clus=8, n_neighbors=5,
):
    """Raster triptych (obs/pred/residual) for unaligned sessions; returns
    R² (reference ``viz_neuron_fit.py:249-313``)."""
    import matplotlib.colors as colors
    import matplotlib.pyplot as plt

    r2 = r2_score_np(gt, pred)

    y = gt - gt.mean(0)
    y_pred = pred - pred.mean(0)
    y_resid = y - y_pred
    t_sort = _cluster_sort(y_pred, n_clus, n_neighbors)

    vmin_perc, vmax_perc = 10, 90
    vmax = np.percentile(y_pred, vmax_perc)
    vmin = np.percentile(y_pred, vmin_perc)
    resid_vmax = np.percentile([y, y_pred, y_resid], vmax_perc)
    resid_vmin = np.percentile([y, y_pred, y_resid], vmin_perc)

    N = len(y)
    fig, axes = plt.subplots(3, 1, figsize=(8, 7))
    for i, (mat, label, lo, hi) in enumerate(
        [
            (y, "obs.", vmin, vmax),
            (y_pred, "pred.", vmin, vmax),
            (y_resid, "resid.", resid_vmin, resid_vmax),
        ]
    ):
        lo, hi = (lo, hi) if lo < 0 < hi else (-1.0, 1.0)
        norm = colors.TwoSlopeNorm(vmin=lo, vcenter=0, vmax=hi)
        im = axes[i].imshow(mat[t_sort], aspect="auto", cmap="bwr", norm=norm)
        cbar = plt.colorbar(im, pad=0.02, shrink=0.6)
        cbar.ax.tick_params(rotation=90)
        if i == 0:
            axes[i].set_title(f" R2: {r2:.3f}")
        axes[i].set_ylabel(f"{label}\n(#trials={N})")
        axes[i].set_xticks([])
        axes[i].set_yticks([])
        axes[i].spines[["left", "bottom", "right", "top"]].set_visible(False)

    os.makedirs(save_path, exist_ok=True)
    plt.savefig(
        os.path.join(save_path, f"{neuron_region}_{neuron_idx}_{r2:.2f}_{method}_{mode}.png")
    )
    plt.close()
    return r2
