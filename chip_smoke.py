#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``llm_bci_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, a few lines each; any failure raises and the exit code is non-zero:

1. the card: ``torch.cuda.is_available()``, its name and power limit;
2. build the CUDA kernels from ``llm_bci_tpu_torch/csrc``, one ``nvcc`` a
   source, all started together;
3. kernels: the CTC kernels against the plain PyTorch version run in
   float64, on float32 log-probs: loss rtol 1e-4 / atol 1e-4, gradient atol
   1e-4 (the plain version's own float32 error over 121 sequential
   log-sum-exps is printed beside it). Every path: ``ctc_alpha_beta_kernel``
   (the forward with the gradient) with its lattice in shared memory at the
   NDT1-CTC flagship shapes (B=64, T'=121, V=41, S=64, partial input
   lengths, an empty and an infeasible target, repeated labels), with and
   without ``zero_infinity`` (the infeasible row: loss exactly 0 or the 1e30
   sentinel, gradient exactly 0), on a confident model (logits x 15) and with
   its lattice in a global scratch (B=8, T=1000); ``ctc_alpha_kernel`` (the
   forward without a gradient) on each, the same bits as the fused loss;
   torch's native CTC through the logits as an independent oracle; the
   launcher's refusal of a plan that differs in any field; device times from
   CUDA graphs of 20 launches (``graph_ms``), the eager calls, the float32
   plain version and ``torch.nn.functional.ctc_loss`` (eager; ``library_ms``,
   the port never calls it); the kernels' registers and stack as compiled;
4. kernels: the banded flash-attention forward, dQ and dK/dV kernels
   against the plain version on the card, in float32 (out atol 5e-5,
   gradients atol 2e-4 + rtol 2e-4: float32 sums in another order) and in
   bf16 against the float32 plain version of the same bf16 inputs (out atol
   2e-2, gradients atol 3e-2 + rtol 3e-2: p and ds are rounded to bf16
   before their products), over an unbounded band, narrow, causal and
   asymmetric bands with tiles inside and cut, right and left key padding,
   rows with no visible key (exactly 0, gradients 0), key tiles with no
   valid key, T one past a tile edge, a ragged T with small D, and dropout
   0.4 from a fixed seed (same keep mask as the plain version, kept
   fraction, same bits twice); ``flash_delta_kernel`` against its plain
   version in float32 (rtol 1e-6) and bf16 (rtol 1e-5); the backward
   launchers' refusal of a plan that differs from the kernels' own
   constants; then the NDT1-mlm
   shape (B=32, H=8, T=1024, D=128, bf16, dropout 0.4; the same bits twice
   for out, dq, dk, dv) with times from CUDA events, the bound of each
   kernel, the whole backward call (on a contiguous and on a strided
   ``dout``), and ``scaled_dot_product_attention`` and its one backward
   call timed beside them at T=1024 (also under a band of 128 / 128 and at
   D=64, H=16) and at T=128 (device times from a CUDA graph there), one
   ``einsum`` and one ``vecdot`` beside ``flash_delta_kernel``; the
   registers and stack of each kernel as compiled, which must not spill
   beyond what is known;
5. main path (NDT1-CTC): synthetic competition-format ``.mat`` files (64 train and
   64 test trials, 256 channels, 480-512 bins, real sentences for the G2P
   phoneme targets) through ``llm_bci_tpu_torch.main`` with
   ``configs/trainer_ctc_ndt1.yaml`` at full width (5 x 1024, bf16
   autocast): 4 training steps and one eval with the CER metric. The
   launch counters must show the CTC kernels ran (the fused kernel once a
   training step, the alpha kernel in the eval); the model's loss on a
   test batch must agree with the plain CTC on the same log-probs;
6. main path (NDT1-mlm): synthetic Poisson spikes (rate 1.0, 64 train and
   32 val trials of 896-1024 bins x 256 channels) in a pickle through
   ``llm_bci_tpu_torch.main`` with ``configs/trainer_ssl_ndt1.yaml`` at full
   width and depth (5 x 1024, 8 heads, D=128, B=32, T=1024, bf16 autocast,
   ``random`` masker ratio 0.3, left padding, ``flash_attention: auto``):
   4 training steps and one eval. The launch counters must show 5 forward
   launches a model call and 5 of each backward kernel (delta, dQ, dK/dV)
   a training step;
7. kernels: the int8 dequant-matmul kernels against ``int8_matmul_plain`` on
   the card: float32 ``x`` at small and ragged M, K, N (rtol 1e-4, atol
   1e-4 x max|out|); bf16 ``x`` at the four Llama-2-7B shapes x M in {1, 5,
   8, 40, 64, 137, 185, 685, 1480} (every M of phases 8, 9 and 12) and at
   ragged M, K, N (clusters of 1 to 8 ranks) against the
   plain version in float32 of the same bf16 inputs (rtol 2^-8: one bf16
   rounding of the output; atol 1e-4 x max|out|: the order of the float32
   sums), each call once more for the same bits; codes of +-127 with zero
   scale columns; ``dx`` through the autograd Function; the cluster
   launcher's refusal of a plan that differs from the kernel's in any field;
   then device times from CUDA graphs of 20 calls at M = 8, 40 and 1480 beside
   the bound, ``torch.matmul`` on a bf16 copy of the weight timed the same
   way (``library_ms``; the port never calls it so), the eager times with the
   host's enqueue, the plain version and convert + ``torch.matmul``;
8. main path (BCI serving): ``BCI`` (NDT1 trunk 5 x 1024 -> projector ->
   Llama with LoRA r=8 on all seven projections) at the Llama-2-7B widths,
   32 layers, int8 base, seeded random weights, B=8, 512 bins x 256
   channels, prompt of 185 tokens: ``generate`` greedy (32 new tokens) and
   diverse beam (5 groups), each token step replayed from one CUDA graph a
   decode. The int8 launches must reconcile with prefills, eager steps,
   captures and replays (225 a model call); the graph's greedy ids must equal
   the un-graphed step's fed the same tokens; a 2-layer copy of the model is
   first held against the same model with the plain product on the card.
   Tokens/s, the prefill, the capture and the token step apart, and the
   device time of replayed steps; the same greedy decode on a bf16 base;
9. main path (BCI fine-tune): the same model through the port's ``Trainer``
   with ``configs/trainer_bci.yaml`` on pre-tokenized synthetic trials: 4
   steps and one eval; finite losses, only LoRA / encoder / projector
   leaves change, the frozen leaves keep their bits, 225 launches a forward
   and none in the backward; the metric readback's batches;
10. co-smoothing (``llm_bci_tpu_torch.eval.co_smoothing``): at the IBL shape of
   ``bench.py::bench_cosmooth`` (NDT1 5 x 1024, seeded weights, 256 channels in
   4 regions, T=100, 64 trials in batches of 32, dense attention) every
   neuron of the ``neuron`` mode; then the mlm model of phase 6 at T=1024
   (B=32, the flash path) in all three modes with 16 neurons: 5 flash forward
   launches a folded pass of 8 sweep points, every bits-per-spike finite or
   NaN, and two neurons of a folded pass against a pass of each alone
   (log-rates atol 2e-2, bits-per-spike 1e-3); the flash forward kernel at
   the folded pass's own inputs (256 rows, the pickle's key padding, no
   dropout) against the plain version in float32 (out atol 2e-2); neurons/s
   of the sweep, the host's scoring not timed;
11. PhonemeLLM at 32 layers x Llama-2-7B width, bf16 base, LoRA r=8 on all
   seven projections, B=8, 121 x 41 CTC posteriors spliced into a 64-token
   prompt: a forward with the loss and one step of LoRA + coupler (the
   frozen leaves keep their bits), greedy (32 tokens) and beam 5 through the
   graphed token step, the graph's greedy ids against the un-graphed step's;
   tokens/s and peak memory;
12. ``llm_bci_tpu_torch.eval_phonemes``: first the quantization-layout repair
   of ``BCI.load_checkpoint_params``, 2 layers deep at the Llama-2-7B widths:
   a bf16 checkpoint with its base served int8 (every int8 leaf
   ``quantize_int8`` of the saved weight), saved and served on a bf16 base
   again, the int8 logits against the dequantized bf16 model's (max 2^-5,
   mean 2^-8 of the largest logit); then the BCI of phase 9 trained 1 step
   on a bf16 base, saved without its frozen base (``training.component_blobs:
   false``), and evaluated on 4 pre-tokenized trials with ``beams=1,5`` and
   ``quantize=int8`` through a stub tokenizer (``WordTokenizer``); the int8
   base there holds fresh seeded codes beside the trained LoRA, encoder and
   projector. The int8 launches reconcile with the forwards, prefills, eager
   steps and captures, every int8 product is at a shape phase 7 checks, one
   predictions pickle a beam size, a finite WER; seconds a trial;
13. iTransformer at ``configs/itransformer.yaml``'s widths (768 x 5, 8 heads,
   MLP embedder, 1500 channel embeddings, region embeddings) through
   ``llm_bci_tpu_torch.main``, 4 steps and one eval each: the IBL shape of
   phase 10 (256 neurons in 4 regions, T=100; 48 train and 16 val trials
   in a pickle, with a ``choice`` in {-1, 1} and a ``wheel-speed`` trace,
   normalised where the config says) under ``trainer_ssl_itransformer.yaml``,
   ``trainer_choice_itransformer.yaml`` and ``trainer_wheel_itransformer.yaml``
   at B=16 (``max_n_bins`` pinned to 100, 4 regions; accuracy in [0, 1] and a
   finite r2 from ``behaviour_decoding_eval``), then the ``ctc`` head with the
   data, method and optimizer of ``trainer_ctc_ndt1.yaml`` (the ``.mat`` files
   of phase 5, B=64, T'=512, region embeddings off: speechbci has no regions):
   ``ctc_alpha_beta_kernel`` once a step on the global-scratch plan,
   ``ctc_alpha_kernel`` once an eval batch, the kernels at the head's own
   float32 log-probs against the plain version in float64 (phase 3's gates),
   graph-timed beside ``F.ctc_loss``, a CER within what 512 frames can give;
14. PatchTST at ``configs/patchtst.yaml``'s widths (d_model 256, 4 layers, 8
   heads, FFN 1024, BatchNorm, patches 10 / 10, pre-norm): ``mlm`` at the IBL
   shape (B=16, context 100, 10 patches) and ``ctc`` at the speechbci shape
   (B=64, context 520, 52 patches: 16,384 sequences a batch; the
   shared-memory plan, feasible and infeasible rows counted), each with
   BatchNorm's running averages finite, moved by training and left by an
   eval, and the CTC checks of phase 13.

``--only ctc|flash|int8|ctc-main|mlm-main|bci-serve|bci-train|cosmooth|
phoneme-llm|eval-phonemes|itransformer|patchtst`` runs one phase (for
development); ``--profile PATH`` writes ``torch.profiler`` tables of the
NDT1-CTC and mlm train steps, the replayed BCI greedy token steps, the
fine-tune step, one folded co-smoothing pass at each shape and the
iTransformer and PatchTST ``ctc`` steps to ``PATH``.

The second-to-last line is a JSON object with the kernels' launches,
errors and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Flagship CTC shapes: B=64 trials, T'=(512-32)/4+1=121 stacked frames,
# 41 phoneme classes, targets padded to 64 labels.
B, T, V, S = 64, 121, 41, 64

SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "she sells sea shells by the sea shore every morning",
    "how are you doing today my friend",
    "i would like a glass of water please",
    "the weather was cold and windy all week long",
    "we walked to the store to buy some bread and milk",
    "please call me when you get home tonight",
    "my brother plays the piano in the evening",
]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def write_mat_dataset(root: str, n_train: int = 64, n_test: int = 64, n_holdout: int = 4,
                      bins=(480, 512), channels: int = 128, seed: int = 0) -> str:
    """Synthetic speechbci competition files: per split one ``.mat`` per
    day with ``tx1`` / ``spikePow`` cells of (T, channels), sentences and
    block ids. Two feature blocks of ``channels`` give 2*channels inputs.
    Every split needs at least 4 trials (2 per file)."""
    import scipy.io

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test), ("competitionHoldOut", n_holdout)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        per_day = [n - n // 2, n // 2]
        for day, k in enumerate(per_day):
            tx1 = np.empty((1, k), object)
            spow = np.empty((1, k), object)
            for i in range(k):
                # The first trial of each file has the longest length and the
                # second the shortest: the loader needs ragged trials per file.
                Ti = {0: bins[1], 1: bins[0]}.get(i) or int(rng.integers(bins[0], bins[1] + 1))
                tx1[0, i] = rng.poisson(1.0, size=(Ti, channels)).astype(np.float64)
                spow[0, i] = rng.normal(size=(Ti, channels)).astype(np.float64)
            sentences = np.array([SENTENCES[(day + i) % len(SENTENCES)] for i in range(k)])
            block = 1 + (np.arange(k) % 2)[:, None]
            scipy.io.savemat(
                os.path.join(root, split, f"t12.2022.{day + 5:02d}.10.mat"),
                {"tx1": tx1, "spikePow": spow, "sentenceText": sentences, "blockIdx": block},
            )
    return root


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls are captured into one
    CUDA graph and the graph is replayed, so the host's time to enqueue a call
    (tens of microseconds through an eager wrapper) is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The kernels that run at the main paths' shapes, by namespace and name in
# their sources (``KERNELS`` below).
FWD_WG = "fwd_wg::flash_fwd_wgmma_kernel"
DQ_WG = "bwd_wg::flash_dq_wgmma_kernel"
DKV_WG = "bwd_wg::flash_dkv_wgmma_kernel"
INT8_CLUSTER = "cluster::int8_cluster_kernel"
INT8_TILED = "tiled::int8_wgmma_kernel"


# Published dense peaks of one H100 SXM: operations a second by input type,
# and bytes a second of device memory.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound(ops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def ctc_case(device, n_batch: int = B, n_frames: int = T, scale: float = 1.0, seed: int = 0):
    """Flagship-shaped CTC inputs (logits) with the edge cases in the batch:
    an empty target, an infeasible one (64 labels in 40 frames), repeated
    labels, one label 30 times; ``scale`` multiplies the logits (15: a
    confident model, whose likeliest paths lie up to hundreds of nats below a
    frame's best slot)."""
    import torch

    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n_batch, n_frames, V)).astype(np.float32) * 2.0 * scale
    targets = rng.integers(1, V, size=(n_batch, S)).astype(np.int64)
    il = rng.integers(int(0.75 * n_frames), n_frames + 1, size=n_batch).astype(np.int64)
    il[0] = n_frames
    tl = rng.integers(20, S + 1, size=n_batch).astype(np.int64)
    tl[1] = 0                                  # empty target
    il[2], tl[2] = 40, S                       # infeasible: 64 labels in 40 frames
    targets[3, :12] = [5, 5, 5, 7, 7, 9, 9, 9, 9, 2, 2, 5]   # repeated labels
    tl[3] = 12
    targets[4] = 6                             # all one label, 30 repeats
    tl[4] = 30
    t = lambda a: torch.from_numpy(a).to(device)
    return t(logits), t(targets), t(il), t(tl)


CTC_INFEASIBLE = 2     # the row of ctc_case with no feasible alignment


def min_frames(targets, tl) -> "torch.Tensor":
    """Frames an alignment of each target needs: its labels and a blank
    between each pair of equal neighbours."""
    import torch

    S_ = targets.shape[1]
    live = torch.arange(1, S_, device=targets.device)[None, :] < tl[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & live).sum(1)
    return tl + repeats


def ctc_check(label: str, lp, targets, il, tl, zero_infinity: bool, lattice: str) -> dict:
    """One CTC path at log-probs ``lp`` against the plain version in float64:
    the loss and the gradient through ``ctc_loss_cuda`` with a gradient
    (``ctc_alpha_beta_kernel``, its lattice where ``lattice`` says) and the
    loss without one (``ctc_alpha_kernel``, the same bits). Gates on the rows
    with a feasible alignment: loss rtol 1e-4 / atol 1e-4, gradient atol 1e-4;
    on the infeasible rows (fewer input frames than ``min_frames``): loss
    exactly 0 under ``zero_infinity`` and the float32 sentinel 1e30 without it,
    gradient exactly 0 (the JAX package's convention; the plain version's
    autograd leaves -0.5 on such a row's last frame's terminal slots without
    ``zero_infinity``, so that row's gradient is held to 0 and not to the
    plain version). Returns the errors and the count of feasible rows."""
    import torch
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import NEG_INF, ctc_loss_plain

    lp = lp.detach().float().contiguous()
    Bx, Tx, Vx = lp.shape
    Sx = targets.shape[1]
    plan = ctc_cuda.ctc_plan(Tx, Sx, Vx, want_grad=True)
    if plan.lattice != lattice:
        raise AssertionError(f"CTC {label}: plan {plan}, expected the lattice in {lattice}")
    x = lp.clone().requires_grad_(True)
    fused0 = ctc_cuda.FUSED_LAUNCHES
    loss = ctc_cuda.ctc_loss_cuda(x, targets, il, tl, zero_infinity=zero_infinity)
    (grad,) = torch.autograd.grad(loss.sum(), x)
    fwd0 = ctc_cuda.FWD_LAUNCHES
    with torch.no_grad():
        loss_fwd = ctc_cuda.ctc_loss_cuda(lp, targets, il, tl, zero_infinity=zero_infinity)
    if (ctc_cuda.FUSED_LAUNCHES - fused0, ctc_cuda.FWD_LAUNCHES - fwd0) != (1, 1):
        raise AssertionError(f"CTC {label}: expected one fused and one forward-only launch")
    xr = lp.double().requires_grad_(True)
    ref = ctc_loss_plain(xr, targets, il, tl, zero_infinity=zero_infinity)
    (ref_grad,) = torch.autograd.grad(ref.sum(), xr)
    torch.cuda.synchronize()
    if not (torch.isfinite(loss).all() and torch.isfinite(grad).all()):
        raise AssertionError(f"CTC {label}: non-finite values")
    infeasible = il.long() < min_frames(targets.long(), tl.long())
    sentinel = 0.0 if zero_infinity else float(np.float32(-NEG_INF))
    if infeasible.any() and not (bool((loss[infeasible] == sentinel).all())
                                 and grad[infeasible].abs().max().item() == 0.0):
        raise AssertionError(f"CTC {label}: infeasible rows: loss {loss[infeasible].tolist()} "
                             f"(expected {sentinel}) or a non-zero gradient")
    if not torch.equal(loss, loss_fwd):
        raise AssertionError(f"CTC {label}: the forward without a gradient differs from the fused one")
    feasible = ~infeasible
    ref_loss = ref.detach().float()
    loss_err = (loss - ref_loss).abs().max().item()
    grad_err = (grad[feasible].double() - ref_grad[feasible]).abs().max().item()
    n_feasible = int(feasible.sum())
    say("kernels", f"CTC {label} (B={Bx} T={Tx} V={Vx} S={Sx}, zero_infinity={zero_infinity}, "
        f"lattice in {plan.lattice}, {plan.smem_bytes} B shared; {n_feasible} feasible rows, "
        f"{Bx - n_feasible} infeasible): against the plain version in float64: loss "
        f"max|err|={loss_err:.3e}, grad max|err|={grad_err:.3e}")
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grad[feasible].double(), ref_grad[feasible], rtol=0.0, atol=1e-4)
    return {"loss_err": loss_err, "grad_err": grad_err, "feasible": n_feasible,
            "infeasible": infeasible}


def kernel_phase(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain

    dev = torch.device("cuda")

    def case(label, zero_infinity, lattice, **kw):
        logits, targets, il, tl = ctc_case(dev, **kw)
        out = ctc_check(label, torch.log_softmax(logits, -1), targets, il, tl, zero_infinity,
                        lattice)
        if not out["infeasible"][CTC_INFEASIBLE]:
            raise AssertionError(f"CTC {label}: row {CTC_INFEASIBLE} counted feasible")
        return out

    flag = case("flagship", True, "shared")
    case("flagship", False, "shared")
    case("confident (logits x 15)", True, "shared", scale=15.0)
    case("confident (logits x 15)", False, "shared", scale=15.0)
    case("unstacked trials", True, "global", n_batch=8, n_frames=1000, seed=1)

    logits, targets, il, tl = ctc_case(dev)
    lp = torch.log_softmax(logits, -1).detach()
    xf = lp.clone().requires_grad_(True)
    f_loss = ctc_loss_plain(xf, targets, il, tl)
    (f_grad,) = torch.autograd.grad(f_loss.sum(), xf)
    xr = lp.double().requires_grad_(True)
    r_loss = ctc_loss_plain(xr, targets, il, tl)
    (r_grad,) = torch.autograd.grad(r_loss.sum(), xr)
    say("kernels", f"for scale, the plain version in float32 against float64: loss max|err|="
        f"{(f_loss.double() - r_loss).abs().max().item():.3e}, grad max|err|="
        f"{(f_grad.double() - r_grad).abs().max().item():.3e}")

    # Independent oracle: torch's native CTC in float64, compared through the
    # logits (its log_probs gradient assumes log-softmax's backward follows).
    grads = []
    for use_kernel in (True, False):
        x = logits.clone().requires_grad_(True)
        if use_kernel:
            loss = ctc_cuda.ctc_loss_cuda(torch.log_softmax(x, -1), targets, il, tl)
        else:
            loss = F.ctc_loss(torch.log_softmax(x.double(), -1).transpose(0, 1), targets, il,
                              tl, reduction="none", zero_infinity=True)
        (g,) = torch.autograd.grad(loss.sum(), x)
        grads.append((loss.detach().float(), g))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grads[0][1], grads[1][1].float(), rtol=0.0, atol=1e-4)
    say("kernels", "CTC kernel vs torch native CTC in float64 (through the logits): agree, "
        f"grad max|err|={(grads[0][1] - grads[1][1]).abs().max().item():.3e}")

    # The launcher refuses a plan that is not the kernel's, in any field.
    plan = ctc_cuda.ctc_plan(T, S, V, want_grad=True)
    args = (lp, targets.int(), il.int(), tl.int(), 0, True)
    loss_buf = torch.empty(B, device=dev)
    occ_buf = torch.empty_like(lp)
    for field, value in (("kernel", ctc_cuda.FWD_KERNEL), ("slots", plan.slots + 1),
                         ("threads", plan.threads + 32), ("smem_bytes", plan.smem_bytes + 16),
                         ("lattice", "global"), ("cluster", 1)):
        rc = ctc_cuda.raw_launch(plan._replace(**{field: value}), *args, loss_buf, occ_buf)
        if rc == 0:
            raise AssertionError(f"CTC launcher took a plan with {field}={value}")
    torch.cuda.synchronize()
    say("kernels", "CTC launcher refuses a plan that differs in kernel, slots, threads, shared "
        "memory, lattice or cluster")

    t = {**ctc_times(lp, targets.int(), il.int(), tl.int()),
         **ctc_eager_times(lp, targets.int(), il.int(), tl.int(), with_plain=True)}
    say("kernels", f"CTC device time (CUDA graphs of 20 launches): ctc_alpha_kernel "
        f"{t['fwd_ms']:.4f} ms ({t['fwd_ms'] * 1e3 / T:.3f} us a frame), "
        f"ctc_alpha_beta_kernel {t['fused_ms']:.4f} ms ({t['fused_ms'] * 1e3 / T:.3f} us a "
        f"frame), with the backward's multiply {t['pair_ms']:.4f} ms; eager, with the host's "
        f"enqueue: forward {t['fwd_eager_ms']:.4f} ms, forward with the gradient + backward "
        f"{t['pair_eager_ms']:.4f} ms; plain (float32) forward {t['plain_fwd_ms']:.3f} ms, "
        f"forward + backward {t['plain_pair_ms']:.3f} ms; F.ctc_loss (eager) forward "
        f"{t['lib_fwd_ms']:.4f} ms, forward + backward {t['lib_pair_ms']:.4f} ms")
    fwd_bound, fused_bound = ctc_bounds(lp, targets, il, tl)
    results["ctc_alpha_kernel"] = dict(
        max_abs_err=flag["loss_err"], ms=t["fwd_ms"], plain_ms=t["plain_fwd_ms"],
        library_ms=t["lib_fwd_ms"], **fwd_bound)
    results["ctc_alpha_beta_kernel"] = dict(
        max_abs_err=max(flag["loss_err"], flag["grad_err"]), ms=t["fused_ms"],
        plain_ms=t["plain_pair_ms"], library_ms=t["lib_pair_ms"], **fused_bound)

    found = _build_resources("ctc", ("ctc_",))
    say("kernels", "CTC kernels as compiled (registers a thread, stack bytes): " + ", ".join(
        f"{name} {reg}/{stack}" for name, (reg, stack) in sorted(found.items())))


def ctc_bounds(lp, targets, il, tl) -> tuple:
    """Bounds of the forward without and with the gradient at these inputs:
    the (B, T, V) float32 log-probs read once, int32 labels and lengths, the
    loss (and the (B, T, V) occupancy sums) written once; about 10 float
    operations a lattice slot and frame that the recursion visits, each
    example's input length x (2 x its target length + 1), twice with the
    gradient (alpha and beta)."""
    Bx, Tx, Vx = lp.shape
    slots = int((il.long() * (2 * tl.long() + 1)).sum())
    in_bytes = Bx * Tx * Vx * 4 + targets.numel() * 4 + 2 * Bx * 4
    return (bound(10 * slots, in_bytes + Bx * 4, "float32"),
            bound(20 * slots, in_bytes + Bx * 4 + Bx * Tx * Vx * 4, "float32"))


def ctc_times(lp, targets, il, tl) -> dict:
    """Device times of the CTC kernels at one shape, from CUDA graphs of 20
    launches on preallocated outputs (``graph_ms``): the forward without a
    gradient, the fused forward, and the pair a training step runs (the fused
    forward and the backward's multiply)."""
    import torch
    from llm_bci_tpu_torch.ops import ctc_cuda

    Bx, Tx, Vx = lp.shape
    Sx = targets.shape[1]
    dev = lp.device
    fwd_plan = ctc_cuda.ctc_plan(Tx, Sx, Vx, want_grad=False)
    fused_plan = ctc_cuda.ctc_plan(Tx, Sx, Vx, want_grad=True)
    loss = torch.empty(Bx, device=dev)
    occ = torch.empty_like(lp)
    grad = torch.empty_like(lp)
    neg_g = -torch.ones(Bx, 1, 1, device=dev)
    scratch = (torch.empty(ctc_cuda.scratch_shape(Bx, Tx, Sx), device=dev, dtype=torch.float64)
               if fused_plan.lattice == "global" else None)
    args = (lp, targets, il, tl, 0, True, loss)

    def pair():
        ctc_cuda.launch(fused_plan, *args, occ, scratch)
        torch.mul(occ, neg_g, out=grad)

    return {
        "fwd_ms": graph_ms(lambda: ctc_cuda.launch(fwd_plan, *args), 20),
        "fused_ms": graph_ms(lambda: ctc_cuda.launch(fused_plan, *args, occ, scratch), 20),
        "pair_ms": graph_ms(pair, 20),
    }


def ctc_eager_times(lp, targets, il, tl, with_plain: bool) -> dict:
    """Through autograd, one call at a time (CUDA events; the host's enqueue
    included): ``ctc_loss_cuda``'s forward and its forward + backward, the
    float32 plain version's (``with_plain``) and ``F.ctc_loss``'s on the same
    log-probs, time-major (eager: its CUDA-tensor lengths go to the host, so it
    cannot be captured; timed only, the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain

    ones = torch.ones(lp.shape[0], device=lp.device)

    def pair(fn, inp):
        x = inp.clone().requires_grad_(True)
        return lambda: torch.autograd.grad(fn(x), x, ones)

    t64, il64, tl64 = targets.long(), il.long(), tl.long()
    lib = lambda v: F.ctc_loss(v, t64, il64, tl64, reduction="none", zero_infinity=True)
    kernel = lambda v: ctc_cuda.ctc_loss_cuda(v, targets, il, tl)
    plain = lambda v: ctc_loss_plain(v, targets, il, tl)
    xt = lp.transpose(0, 1).contiguous()
    out = {}
    with torch.no_grad():
        out["fwd_eager_ms"] = cuda_ms(lambda: kernel(lp), 50)
        out["lib_fwd_ms"] = cuda_ms(lambda: lib(xt), 50)
        if with_plain:
            out["plain_fwd_ms"] = cuda_ms(lambda: plain(lp), 5)
    out["pair_eager_ms"] = cuda_ms(pair(kernel, lp), 50)
    out["lib_pair_ms"] = cuda_ms(pair(lib, xt), 50)
    if with_plain:
        out["plain_pair_ms"] = cuda_ms(pair(plain, lp), 5)
    return out


# ---------------------------------------------------------------------------
# Flash attention kernels
# ---------------------------------------------------------------------------

FLASH_TOL = {
    # (out atol, grad atol, grad rtol)
    "float32": (5e-5, 2e-4, 2e-4),
    "bfloat16": (2e-2, 3e-2, 3e-2),
}

FLASH_CASES = [
    # name, B, T, H, D, forward, backward, padding, dropout
    ("unbounded", 2, 200, 2, 64, None, None, "none", 0.0),
    ("band 3/5, right padding", 2, 200, 2, 64, 3, 5, "right", 0.0),
    ("causal, left padding", 2, 130, 2, 32, 0, None, "left", 0.0),
    ("band 70/90 over several tiles", 1, 300, 2, 128, 70, 90, "left", 0.0),
    ("rows with no visible key", 2, 100, 2, 64, 0, 2, "dead", 0.0),
    ("ragged T=77, D=16 (padded to 32)", 2, 77, 3, 16, None, None, "right", 0.0),
    ("dropout 0.4, band 40/None", 2, 150, 2, 64, 40, None, "right", 0.4),
    # the diagonal tiles lie wholly inside the band (no visibility test in the
    # forward), their neighbours are cut by it
    ("band 100/100, tiles inside and cut", 2, 320, 2, 64, 100, 100, "none", 0.0),
    ("band 100/100, tiles inside and cut, left padding", 2, 320, 2, 64, 100, 100, "left", 0.0),
    ("band 100/100, D=128, dropout 0.4, right padding", 2, 320, 2, 128, 100, 100, "right", 0.4),
    ("T=40, shorter than one tile", 2, 40, 2, 64, None, None, "right", 0.0),
    # what the wgmma backward kernels can get wrong (bf16; float32 runs them
    # through the mma kernels): query tiles wholly inside an asymmetric band
    # and cut by it, T one past a tile edge, dead rows at D=128, key tiles
    # with no valid key
    ("band 150/70, D=128, tiles inside and cut, left padding, dropout 0.4",
     2, 400, 2, 128, 150, 70, "left", 0.4),
    ("T=65, one past a tile edge, right padding", 2, 65, 2, 128, None, None, "right", 0.0),
    ("T=129, one past a tile edge, right padding, dropout 0.4",
     2, 129, 2, 64, None, None, "right", 0.4),
    ("rows with no visible key, D=128", 2, 200, 2, 128, 0, 2, "dead", 0.0),
    ("key_valid empties whole key tiles", 2, 300, 2, 128, None, None, "hole", 0.0),
    ("key_valid empties whole key tiles, band 80/40, D=64", 2, 300, 2, 64, 80, 40, "hole", 0.0),
]


def flash_inputs(B, T, H, D, pad, dtype, device, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    q, k, v, w = (torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
                  .to(device=device, dtype=dtype) for _ in range(4))
    valid = np.ones((B, T), np.int32)
    if pad == "right":
        valid[0, T - T // 5:] = 0
    elif pad == "left":
        valid[0, :T // 3] = 0
        if B > 1:
            valid[1, :5] = 0
    elif pad == "dead":
        valid[0, :] = 0           # a whole example without keys
        valid[1, :T // 2] = 0     # under a causal band: padded queries see nothing
    elif pad == "hole":
        valid[0, 64:192] = 0      # two whole 64-key tiles, halves of two 128-key tiles
        valid[1, 128:256] = 0     # one whole 128-key tile
    return q, k, v, w, torch.from_numpy(valid).to(device)


def flash_run(fn, q, k, v, w, valid, fwd, bwd, drop, seed, dtype=None):
    """out and the gradients of sum(out * w) w.r.t. q, k, v through ``fn``
    (the public function or the plain version), optionally in ``dtype``."""
    import torch

    q, k, v = (x.detach().to(dtype or x.dtype).requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, valid, fwd, bwd, drop, seed=seed)
    grads = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    return [out.detach().float()] + [g.float() for g in grads]


def flash_kernel_phase(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from llm_bci_tpu_torch.ops import flash_attention as fa
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    dev = torch.device("cuda")
    kernel = lambda q, k, v, valid, fwd, bwd, drop, seed: fa.banded_flash_attention(
        q, k, v, valid, fwd, bwd, dropout_rate=drop, seed=seed)
    plain = lambda q, k, v, valid, fwd, bwd, drop, seed: fa.banded_flash_attention_plain(
        q, k, v, valid, fwd, bwd, drop, seed)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        o_atol, g_atol, g_rtol = FLASH_TOL[name]
        for case, B, T, H, D, fwd, bwd, pad, drop in FLASH_CASES:
            q, k, v, w, valid = flash_inputs(B, T, H, D, pad, dtype, dev)
            seed = 1234 if drop else None
            got = flash_run(kernel, q, k, v, w, valid, fwd, bwd, drop, seed)
            ref = flash_run(plain, q, k, v, w, valid, fwd, bwd, drop, seed, torch.float32)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"flash {name} {case}: non-finite values")
            errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
            torch.testing.assert_close(got[0], ref[0], atol=o_atol, rtol=0.0,
                                       msg=lambda m: f"flash {name} {case}: out: {m}")
            for which, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
                torch.testing.assert_close(a, b, atol=g_atol, rtol=g_rtol,
                                           msg=lambda m: f"flash {name} {case}: {which}: {m}")
            if pad == "dead":
                dead = ~fa.visibility_mask(T, valid, *fa._band_bounds(fwd, bwd, T), dev).any(-1)
                dead = dead[:, 0].expand(B, T)                       # (B, T) queries
                if not dead.any() or any(t[dead].abs().max().item() != 0.0
                                         for t in (got[0], got[1])):
                    raise AssertionError(f"flash {name} {case}: dead rows are not exactly 0")
                if got[2][0].abs().max().item() != 0.0 or got[3][0].abs().max().item() != 0.0:
                    raise AssertionError(f"flash {name} {case}: dK/dV of a dead example not 0")
            if drop:
                again = flash_run(kernel, q, k, v, w, valid, fwd, bwd, drop, seed)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"flash {name} {case}: same seed, different bits")
                other = flash_run(kernel, q, k, v, w, valid, fwd, bwd, drop, seed + 1)
                if torch.equal(got[0], other[0]):
                    raise AssertionError(f"flash {name} {case}: the seed changes nothing")
            if dtype == torch.bfloat16:
                worst["fwd"] = max(worst["fwd"], errs[0])
                worst["dq"] = max(worst["dq"], errs[1])
                worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
            say("kernels", f"flash {name} {case}: max|err| out {errs[0]:.2e} dq {errs[1]:.2e} "
                f"dk {errs[2]:.2e} dv {errs[3]:.2e}")

    # Kept fraction, read from the kernel itself: with q = 0 the probabilities
    # are uniform and with v = 1 each output is kept_count / T / (1 - p).
    z = torch.zeros((4, 1024, 8, 32), device=dev)
    frac = fa.banded_flash_attention(z, z, torch.ones_like(z), dropout_rate=0.4, seed=99)
    frac = frac.mean().item() * 0.6
    if abs(frac - 0.6) > 0.006:
        raise AssertionError(f"flash dropout keeps {frac:.4f} of the entries, expected 0.6")
    say("kernels", f"flash dropout 0.4: kept fraction {frac:.4f} over 4*8*1024*1024 entries")

    # flash_delta_kernel against its plain version, in both dtypes. The sums
    # run in another order: rtol 1e-6 (float32) or 1e-5 (bf16 inputs, the same
    # float32 arithmetic on them) with atol the same share of the largest
    # sum of |dO * O| of a row, which is what a cancelling sum is held to.
    delta_err = 0.0
    for dtype, rtol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-5)):
        for Bd, Td, Hd, Dd in ((32, 1024, 8, 128), (3, 77, 3, 32), (2, 129, 5, 64)):
            o_, g_, _, _, _ = flash_inputs(Bd, Td, Hd, Dd, "none", dtype, dev, seed=5)
            got = fc.flash_delta(o_, g_)
            ref = fa.flash_delta_plain(o_, g_)
            torch.cuda.synchronize()
            atol = rtol * (o_.float() * g_.float()).abs().sum(-1).max().item()
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
            delta_err = max(delta_err, (got - ref).abs().max().item())
    say("kernels", f"flash_delta_kernel float32 and bfloat16 at D=128, 32, 64: "
        f"max|err| {delta_err:.2e}")

    # The backward launchers refuse a plan that differs from the kernel's own
    # constants in any field (the wgmma kernels and the mma kernels).
    real_plan, refused = fc.backward_plan, 0
    fields = fc.KernelPlan._fields[1:]
    try:
        for dtype, Dp in ((torch.bfloat16, 128), (torch.bfloat16, 64), (torch.float32, 32)):
            q, k, v, w, valid = flash_inputs(2, 128, 2, Dp, "none", dtype, dev)
            for field in fields:
                fc.backward_plan = lambda D_, bf16, f=field: fc.BackwardPlan(*(
                    one._replace(**{f: getattr(one, f) + 1}) for one in real_plan(D_, bf16)))
                before = (fc.BWD_DQ_LAUNCHES, fc.BWD_DKV_LAUNCHES)
                try:
                    flash_run(kernel, q, k, v, w, valid, None, None, 0.0, None)
                except RuntimeError:
                    refused += 1
                else:
                    raise AssertionError(f"flash D={Dp}: a plan with another {field} was launched")
                if before != (fc.BWD_DQ_LAUNCHES, fc.BWD_DKV_LAUNCHES):
                    raise AssertionError("flash: a refused launch was counted")
    finally:
        fc.backward_plan = real_plan
    flash_run(kernel, q, k, v, w, valid, None, None, 0.0, None)
    say("kernels", f"flash backward launchers refused {refused} plans that differ from the "
        f"kernels' own in one of {', '.join(fields)}")

    # The NDT1-mlm shape: one layer's attention at full width.
    B, T, H, D, drop, seed = 32, 1024, 8, 128, 0.4, 4321
    q, k, v, w, valid = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
    lengths = np.random.default_rng(2).integers(896, T + 1, size=B)
    lengths[0] = T
    valid = torch.from_numpy((np.arange(T)[None, :] >= (T - lengths)[:, None]).astype(np.int32))
    valid = valid.to(dev)                                   # left padding
    got = flash_run(kernel, q, k, v, w, valid, None, None, drop, seed)
    ref = flash_run(plain, q, k, v, w, valid, None, None, drop, seed, torch.float32)
    torch.cuda.synchronize()
    o_atol, g_atol, g_rtol = FLASH_TOL["bfloat16"]
    errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
    torch.testing.assert_close(got[0], ref[0], atol=o_atol, rtol=0.0)
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, atol=g_atol, rtol=g_rtol)
    del ref
    again = flash_run(kernel, q, k, v, w, valid, None, None, drop, seed)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("flash at the full-width shape: same seed, different bits")
    worst = {"fwd": max(worst["fwd"], errs[0]), "dq": max(worst["dq"], errs[1]),
             "dkv": max(worst["dkv"], errs[2], errs[3])}
    say("kernels", f"flash bfloat16 B={B} H={H} T={T} D={D} dropout {drop}, left padding: "
        f"max|err| out {errs[0]:.2e} dq {errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e}; "
        f"out, dq, dk, dv the same bits twice")
    del got, again

    e = 2                                                    # bytes of a bf16

    def timings(B, T, H, D, valid, drop, seed, band=None, with_plain=False):
        """Kernel and SDPA times at one bf16 shape, with each kernel's bound
        from this run's mask; ``band`` is the (forward, backward) context,
        unbounded when None. A (query, key) pair counts when the key is
        visible; 2*D operations a pair and product: 2 products forward, 3 for
        dQ (s, dp, ds.K), 4 for dK/dV (s, dp, p^T.dO, ds^T.Q)."""
        q, k, v, w, _ = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        seed_t = torch.tensor([seed], dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(D)
        fwd, bwd = band if band is not None else (T, T)
        args = (q, k, v, valid, seed_t, fwd, bwd, scale, drop)
        # one library call: SDPA on (B, H, T, D) with a boolean mask of the
        # same padding and band and the same dropout rate; its backward gives
        # dq, dk and dv in one call
        qh, kh, vh, wh = (x.detach().transpose(1, 2).contiguous() for x in (q, k, v, w))
        qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
        mask = fa.visibility_mask(T, valid, fwd, bwd, dev).expand(B, 1, T, T)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=drop)
        pairs = float(mask.sum().item()) * H
        qkv, small = B * T * H * D * e, B * H * T * 4
        t = {"bound_fwd": bound(2 * 2 * D * pairs, 4 * qkv + small + B * T * 4, "bfloat16"),
             "bound_dq": bound(3 * 2 * D * pairs, 5 * qkv + 2 * small + B * T * 4, "bfloat16"),
             "bound_dkv": bound(4 * 2 * D * pairs, 6 * qkv + 2 * small + B * T * 4, "bfloat16"),
             "bound_delta": bound(2 * B * T * H * D, 2 * qkv + small, "float32")}
        with torch.no_grad():
            t["fwd"] = cuda_ms(lambda: fc.FlashAttentionFunction.apply(*args), 20)
            t["sdpa_fwd"] = cuda_ms(sdpa, 20)
            if T <= 256:     # the host's enqueue time exceeds the kernel's
                t["fwd_device"] = graph_ms(lambda: fc.FlashAttentionFunction.apply(*args), 20)
                t["sdpa_fwd_device"] = graph_ms(sdpa, 20)
        out = fc.FlashAttentionFunction.apply(*args)
        # the whole backward call: delta and both kernels on a contiguous dout
        # of the kernels' dtype, which the cast passes on as it is, ...
        t["bwd"] = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), w, retain_graph=True), 20)
        # ... and on a dout that arrives strided (the (B, H, T, D) memory of a
        # transpose), which the call first copies
        w_t = w.transpose(1, 2).contiguous().transpose(1, 2)
        t["bwd_strided"] = cuda_ms(
            lambda: torch.autograd.grad(out, (q, k, v), w_t, retain_graph=True), 20)
        # the backward kernels alone, on the tensors the backward would get
        meta = fc.kernel_meta(q, fwd, bwd, scale, drop)
        with torch.no_grad():
            _, lse = fc.flash_fwd(q, k, v, valid, seed_t, meta)
            o = out.detach()
            delta = fc.flash_delta(o, w)
            back = (q, k, v, valid, seed_t, w, lse, delta, meta)
            t["delta"] = cuda_ms(lambda: fc.flash_delta(o, w), 20)
            t["plain_delta"] = cuda_ms(lambda: fa.flash_delta_plain(o, w), 20)
            # one library call for the same sums, einsum or vecdot (whose
            # (B, T, H) result is read as (B, H, T) through a view): in the
            # inputs' dtype (for bf16 it rounds the result to bf16, which the
            # kernel does not), and on float32 copies made outside the timing
            einsum = lambda a, b: torch.einsum("bthd,bthd->bht", a, b)
            vecdot = lambda a, b: torch.linalg.vecdot(a, b).transpose(1, 2)
            o32, w32 = o.float(), w.float()
            atol = 1e-4 * float((o32 * w32).abs().sum(-1).max())
            for call in (einsum, vecdot):
                torch.testing.assert_close(call(o32, w32), delta, rtol=1e-4, atol=atol)
            t["einsum_delta"] = cuda_ms(lambda: einsum(o, w), 20)
            t["vecdot_delta"] = cuda_ms(lambda: vecdot(o, w), 20)
            t["einsum_delta_f32"] = cuda_ms(lambda: einsum(o32, w32), 20)
            t["vecdot_delta_f32"] = cuda_ms(lambda: vecdot(o32, w32), 20)
            t["lib_delta"] = min(t["einsum_delta"], t["vecdot_delta"])
            del o32, w32
            t["dq"] = cuda_ms(lambda: fc.flash_dq(*back), 20)
            t["dkv"] = cuda_ms(lambda: fc.flash_dkv(*back), 20)
            if T <= 256:
                t["delta_device"] = graph_ms(lambda: fc.flash_delta(o, w), 20)
                t["dq_device"] = graph_ms(lambda: fc.flash_dq(*back), 20)
                t["dkv_device"] = graph_ms(lambda: fc.flash_dkv(*back), 20)
        del out
        if with_plain:
            p_out = fa.banded_flash_attention_plain(q, k, v, valid, fwd, bwd, drop, seed_t)
            with torch.no_grad():
                t["plain_fwd"] = cuda_ms(lambda: fa.banded_flash_attention_plain(
                    q, k, v, valid, fwd, bwd, drop, seed_t), 3)
            t["plain_dq"] = cuda_ms(
                lambda: torch.autograd.grad(p_out, q, w, retain_graph=True), 3)
            t["plain_dkv"] = cuda_ms(
                lambda: torch.autograd.grad(p_out, (k, v), w, retain_graph=True), 3)
            del p_out
        s_out = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(s_out, (qh, kh, vh), wh, retain_graph=True)
        t["sdpa_bwd"] = cuda_ms(sdpa_bwd, 20)   # autograd's engine cannot be captured: eager
        return t

    def backward_line(label, t):
        pair = t["dq"] + t["dkv"]
        say("kernels", f"flash backward at {label}: flash_dq_kernel {t['dq']:.3f} ms (bound "
            f"{t['bound_dq']['bound_ms']:.3f}, {t['bound_dq']['bound_by']}), flash_dkv_kernel "
            f"{t['dkv']:.3f} ms (bound {t['bound_dkv']['bound_ms']:.3f}, "
            f"{t['bound_dkv']['bound_by']}), the pair {pair:.3f} ms, the whole backward call "
            f"{t['bwd']:.3f} ms ({t['bwd_strided']:.3f} with the copy of a strided dout); one "
            f"SDPA backward (dq, dk, dv) {t['sdpa_bwd']:.3f} ms: the pair "
            f"{pair / t['sdpa_bwd']:.2f}x, the call {t['bwd'] / t['sdpa_bwd']:.2f}x "
            f"({t['bwd_strided'] / t['sdpa_bwd']:.2f}x) its time")

    t = timings(B, T, H, D, valid, drop, seed, with_plain=True)
    for key, label in (("fwd", FWD_WG), ("dq", DQ_WG), ("dkv", DKV_WG),
                       ("delta", "flash_delta_kernel")):
        # one SDPA backward gives dq, dk and dv: both backward kernels are
        # held against that one call; delta against the faster of one einsum
        # and one vecdot on the same bf16 tensors
        library = {"fwd": t["sdpa_fwd"], "dq": t["sdpa_bwd"], "dkv": t["sdpa_bwd"],
                   "delta": t["lib_delta"]}[key]
        err = delta_err if key == "delta" else worst[key]
        results[label] = dict(max_abs_err=err, ms=t[key], plain_ms=t[f"plain_{key}"],
                              library_ms=library, **t[f"bound_{key}"])
        say("kernels", f"{label} at B={B} H={H} T={T} D={D} bf16 dropout {drop}: "
            f"{t[key]:.4f} ms, bound {t['bound_' + key]['bound_ms']:.4f} ms "
            f"({t['bound_' + key]['bound_by']}), plain {t['plain_' + key]:.3f} ms, library "
            f"{library:.4f} ms")
    say("kernels", f"flash_delta_kernel's library calls on the bf16 tensors (bf16 result) and "
        f"on float32 copies: torch.einsum('bthd,bthd->bht') {t['einsum_delta']:.4f} and "
        f"{t['einsum_delta_f32']:.4f} ms, torch.linalg.vecdot {t['vecdot_delta']:.4f} and "
        f"{t['vecdot_delta_f32']:.4f} ms")
    backward_line(f"B={B} H={H} T={T} D={D} bf16 dropout {drop}", t)
    q0, k0, v0, _, _ = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
    with torch.no_grad():
        no_drop = cuda_ms(lambda: fc.FlashAttentionFunction.apply(
            q0, k0, v0, valid, None, T, T, 1.0 / math.sqrt(D), 0.0), 20)
    say("kernels", f"flash_fwd_kernel without dropout: {no_drop:.3f} ms "
        f"(the keep mask costs {t['fwd'] - no_drop:.3f} ms)")
    k_all = t["fwd"] + t["bwd"]
    s_all = t["sdpa_fwd"] + t["sdpa_bwd"]
    say("kernels", f"flash vs SDPA at T={T}: forward {t['fwd'] / t['sdpa_fwd']:.2f}x its time, "
        f"forward+backward {k_all:.3f} ms vs {s_all:.3f} ms ({k_all / s_all:.2f}x)")

    # Under a band and at D=64: the visible pairs of this run's mask give the
    # bounds, SDPA gets the same mask.
    for label, Bx, Hx, Dx, band in ((f"D={D} band 128/128", B, H, D, (128, 128)),
                                    ("D=64 unbounded", B, 2 * H, 64, None)):
        tx = timings(Bx, T, Hx, Dx, valid, drop, seed, band=band)
        bx = tx["bound_fwd"]
        say("kernels", f"flash_fwd_kernel at B={Bx} H={Hx} T={T}, {label}, bf16 dropout "
            f"{drop}: {tx['fwd']:.3f} ms, bound {bx['bound_ms']:.3f} ms ({bx['bound_by']}), "
            f"SDPA {tx['sdpa_fwd']:.3f} ms ({tx['fwd'] / tx['sdpa_fwd']:.2f}x)")
        backward_line(f"B={Bx} H={Hx} T={T}, {label}, bf16 dropout {drop}", tx)

    # The short length of the stacked CTC path, for the auto threshold.
    Bs, Ts = 64, 128
    valid_s = torch.ones((Bs, Ts), dtype=torch.int32, device=dev)
    ts = timings(Bs, Ts, H, D, valid_s, drop, seed, with_plain=True)
    k_all = ts["fwd"] + ts["bwd"]
    s_all = ts["sdpa_fwd"] + ts["sdpa_bwd"]
    say("kernels", f"flash vs SDPA at B={Bs} T={Ts}: forward {ts['fwd']:.3f} ms vs "
        f"{ts['sdpa_fwd']:.3f} ms ({ts['fwd'] / ts['sdpa_fwd']:.2f}x), forward+backward "
        f"{k_all:.3f} ms vs {s_all:.3f} ms ({k_all / s_all:.2f}x); plain forward "
        f"{ts['plain_fwd']:.3f} ms, plain backward {ts['plain_dq'] + ts['plain_dkv']:.3f} ms")
    say("kernels", f"at B={Bs} T={Ts}, device time from a CUDA graph of 20 launches: "
        f"flash_fwd_kernel {ts['fwd_device']:.4f} ms, SDPA forward {ts['sdpa_fwd_device']:.4f} "
        f"ms; flash_delta_kernel {ts['delta_device']:.4f}, flash_dq_kernel "
        f"{ts['dq_device']:.4f}, flash_dkv_kernel {ts['dkv_device']:.4f} ms (eager, with "
        f"the host's enqueue time: {ts['delta']:.4f}, {ts['dq']:.4f}, {ts['dkv']:.4f}, the "
        f"whole backward call {ts['bwd']:.4f}, one SDPA backward {ts['sdpa_bwd']:.4f} ms)")

    # Registers and spills of the kernels, as the compiler left them. A kernel
    # that spills is right and slow, so the stack is held to what is known:
    # none, but for 64 bytes in dK/dV at D=64 (two blocks an SM at 128
    # registers, which measured faster than one block without spills).
    found = _build_resources("flash_attention", ("wgmma", "flash_delta"))
    for kernel_name, (reg, stack) in sorted(found.items()):
        allowed = 64 if kernel_name == "flash_dkv_wgmma_kernelILi64" else 0
        say("kernels", f"{kernel_name}: {reg} registers a thread, {stack} bytes of stack "
            f"(at most {allowed})")
        if stack > allowed:
            raise AssertionError(f"{kernel_name} spills: {stack} bytes of stack, {allowed} allowed")
    wgmma = [n for n in found if "wgmma" in n]
    if len(wgmma) != 6 or not any("flash_delta" in n for n in found):
        raise AssertionError(f"resource usage: expected the six wgmma kernels and delta: {found}")


def _build_resources(name: str, patterns) -> dict:
    """``cuobjdump --dump-resource-usage`` of a built library: (registers a
    thread, stack bytes) of each kernel whose name holds one of ``patterns``,
    by the part of its mangled name that holds kernel, dtype and head size."""
    from llm_bci_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-resource-usage", _build.build(name)],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    found, current = {}, None
    for raw in out.splitlines():
        raw = raw.strip()
        if raw.startswith("Function "):
            current = raw[len("Function "):].rstrip(":")
        elif raw.startswith("REG:") and current and any(p in current for p in patterns):
            short = re.search(r"flash_(?:fwd|dq|dkv|delta)_\w*?kernelI\w*?Li\d+"
                              r"|ctc_alpha(?:_beta)?_kernel", current)
            reg, stack = re.search(r"REG:(\d+)", raw), re.search(r"STACK:(\d+)", raw)
            found[short.group(0) if short else current] = (int(reg.group(1)), int(stack.group(1)))
    return found


# ---------------------------------------------------------------------------
# Int8 dequant-matmul kernels
# ---------------------------------------------------------------------------

# (K, N) of the frozen Llama-2-7B base: q/k/v/o, gate/up, down, lm_head.
INT8_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# a token step at one row, 5 beams of one trial, greedy (B=8), 5 beams (B=8),
# the cluster kernel's largest M; the prefill of one trial, the forward of one
# trial (eval-phonemes), its prefill with 5 beams; prefill / fine-tune (B=8)
INT8_MS = (1, 5, 8, 40, 64, 137, 185, 685, 1480)
INT8_TIMED_MS = (8, 40, 1480)


def int8_inputs(M, K, N, dtype, device, seed=0):
    """x ~ N(0, 1), codes uniform in [-127, 127], scales around 0.02 * 4 / 127."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device, dtype=torch.float32).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8)
    scale = (0.5 + torch.rand((N,), generator=g, device=device)) * (0.02 * 4.0 / 127.0)
    return x, q, scale


def int8_plan_text(M, K, N, dtype) -> str:
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    import torch

    kind = ic.regime(M, dtype == torch.bfloat16)
    if kind == "f32":
        return "float32 128 x 128 tiles"
    if kind == "cluster":
        p = ic.cluster_plan(M, K, N)
        return (f"cluster C={p.cluster} x {p.grid[1]} column tiles, {p.k_per_rank // 64} k-tiles "
                f"a rank, {p.stages} stages, {p.m_tiles} x 8 rows, {p.threads} threads, "
                f"{p.smem_bytes} B")
    t = ic.tile_plan(M, K, N)
    return f"wgmma {t.tile_m} x 128 tiles, grid {t.grid}, {t.smem_bytes} B"


def raw_cluster_launch(x, q, scale, out, plan) -> int:
    """The cluster launcher's own return code for ``plan``, through its C
    entry point, with no check of the plan on this side (the wrapper checks
    first, so a refusal of the launcher is seen only from here)."""
    import torch
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    M, K = x.shape
    with torch.cuda.device(x.device):
        return ic._lib().int8_matmul_cluster_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, q.shape[1],
            int(out.dtype == torch.float32), plan.m_tiles, plan.cluster, plan.k_per_rank,
            plan.grid[1], plan.threads, plan.stages, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)


def int8_launches() -> dict:
    """The int8 wrapper's launches since its last reset, by the kernel of the
    regime each took; a float32 launch (no main path makes one) is in
    ``LAUNCHES`` only, so that it shows as a difference of the two."""
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    return {INT8_CLUSTER: ic.REGIME_LAUNCHES["cluster"], INT8_TILED: ic.REGIME_LAUNCHES["tiled"]}


def int8_kernel_phase(results: dict, power_line: str) -> None:
    import torch
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    from llm_bci_tpu_torch.ops import quant

    dev = torch.device("cuda")

    def reference(x, q, scale):
        """The plain version in float32 on the same inputs."""
        return quant.int8_matmul_plain(x.float(), q, scale, torch.float32)

    # float32 x: small and ragged M, small K / N (multiples of 16, not of the
    # tiles). rtol 1e-4 and atol 1e-4 * max|out|: float32 sums in another order.
    for M, K, N in [(1, 32, 32), (8, 48, 80), (40, 1024, 272), (185, 160, 4096),
                    (70, 4096, 144)]:
        x, q, scale = int8_inputs(M, K, N, torch.float32, dev, seed=M)
        got = quant.int8_matmul(x, q, scale)
        ref = reference(x, q, scale)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item(),
                                   msg=lambda m: f"int8 float32 M={M} K={K} N={N}: {m}")
        say("int8", f"float32 M={M} K={K} N={N}: max|err| {err:.2e} "
            f"(max|out| {ref.abs().max().item():.2e})")

    # bf16 x against the plain version in float32 of the same bf16 inputs.
    # rtol 2^-8: one bf16 rounding of the output (half an ulp is 2^-9 of the
    # value); atol 1e-4 * max|out|: float32 sums in another order, which matter
    # where the sum cancels to near zero. Every call twice: the same bits (the
    # cluster kernel adds its ranks' partials in rank order).
    worst = {"small": 0.0, "tiled": 0.0}

    def check_bf16(M, K, N, seed, what=""):
        x, q, scale = int8_inputs(M, K, N, torch.bfloat16, dev, seed=seed)
        before = ic.LAUNCHES
        got = quant.int8_matmul(x, q, scale).float()
        if ic.LAUNCHES != before + 1:
            raise AssertionError(f"int8 bf16 M={M} K={K} N={N}: {ic.LAUNCHES - before} launches")
        ref = reference(x, q, scale)
        torch.cuda.synchronize()
        top = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, rtol=2.0 ** -8, atol=1e-4 * top,
                                   msg=lambda m: f"int8 bf16 M={M} K={K} N={N}: {m}")
        if not torch.equal(got, quant.int8_matmul(x, q, scale).float()):
            raise AssertionError(f"int8 bf16 M={M} K={K} N={N}: same input, different bits")
        key = "small" if M <= ic.CLUSTER_MAX_M else "tiled"
        worst[key] = max(worst[key], err)
        say("int8", f"bf16{what} M={M} K={K} N={N} ({int8_plan_text(M, K, N, torch.bfloat16)}): "
            f"max|err| {err:.3e} of max|out| {top:.3e}; same bits twice")

    for K, N in INT8_SHAPES:
        for M in INT8_MS:
            check_bf16(M, K, N, seed=M + K)
    # Ragged edges: M off every 8-row tile and on the regimes' border, N off
    # the 128-column tile (and exactly on it), K off the 64-deep k-tile, K and
    # N smaller than one tile; clusters of 1 to 8 ranks.
    for K, N in [(160, 144), (4112, 272), (4112, 11008), (160, 4096), (32, 48), (1024, 4096)]:
        for M in (1, 3, 9, 17, 33, 41, 64, 65, 129, 185, 1480):
            check_bf16(M, K, N, seed=M + N, what=" ragged")
    # float32 output from bf16 x (the kernels' other store path), both regimes
    for M in (40, 185):
        x, q, scale = int8_inputs(M, 4096, 4096, torch.bfloat16, dev, seed=5)
        got = quant.int8_matmul(x, q, scale, out_dtype=torch.float32)
        ref = reference(x, q, scale)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())

    # Codes of +-127 only, and a scale column of zeros: exactly 0 there.
    for M in (8, 40, 185):
        x, q, scale = int8_inputs(M, 4096, 4096, torch.bfloat16, dev, seed=9)
        q = torch.where(q >= 0, torch.full_like(q, 127), torch.full_like(q, -127))
        scale[::7] = 0.0
        got = quant.int8_matmul(x, q, scale).float()
        ref = reference(x, q, scale)
        torch.testing.assert_close(got, ref, rtol=2.0 ** -8, atol=1e-4 * ref.abs().max().item())
        if got[:, ::7].abs().max().item() != 0.0 or not torch.isfinite(got).all():
            raise AssertionError("int8: a zero scale column is not exactly 0")
    say("int8", "codes of +-127 with zero scale columns: agree, zero columns exactly 0")

    # dx through the Function against autograd of the plain version.
    for dtype, M, K, N, rtol in ((torch.float32, 40, 256, 512, 1e-4),
                                 (torch.bfloat16, 40, 4096, 11008, 2.0 ** -7),
                                 (torch.bfloat16, 1480, 4096, 11008, 2.0 ** -7)):
        x, q, scale = int8_inputs(M, K, N, dtype, dev, seed=3)
        w = torch.randn((M, N), device=dev, dtype=torch.float32)
        grads = []
        for fn in (quant.int8_matmul, quant.int8_matmul_plain):
            xi = x.clone().requires_grad_(True)
            (g,) = torch.autograd.grad((fn(xi, q, scale).float() * w).sum(), xi)
            grads.append(g.float())
        torch.testing.assert_close(grads[0], grads[1], rtol=rtol,
                                   atol=rtol * grads[1].abs().max().item())
        say("int8", f"dx {str(dtype).split('.')[-1]} M={M} K={K} N={N}: max|err| "
            f"{(grads[0] - grads[1]).abs().max().item():.3e} of max "
            f"{grads[1].abs().max().item():.3e}")

    # The cluster launcher refuses a plan that differs from the kernel's own
    # in any field, and launches nothing then.
    x, q, scale = int8_inputs(8, 4096, 4096, torch.bfloat16, dev, seed=4)
    out = torch.empty((8, 4096), device=dev, dtype=torch.bfloat16)
    plan = ic.cluster_plan(8, 4096, 4096)
    refused = []
    for field in ic.ClusterPlan._fields:
        value = getattr(plan, field)
        bad = plan._replace(**{field: (value[0], value[1] + 1) if field == "grid" else value + 1})
        rc = raw_cluster_launch(x, q, scale, out, bad)
        if rc == 0:
            raise AssertionError(f"int8 cluster launcher took a plan with another {field}: {bad}")
        refused.append(f"{field} ({rc})")
    if raw_cluster_launch(x, q, scale, out, plan) != 0:
        raise AssertionError("int8 cluster launcher refused its own plan")
    torch.cuda.synchronize()
    say("int8", f"the cluster launcher refused plans with another {', '.join(refused)} "
        f"(CUDA error codes), and took its own")

    # Times. Each call reads another copy of the weight, from a ring larger
    # than the 50 MB L2, as a model's layers do. Device times from CUDA graphs
    # of 20 calls (graph_ms); the eager time of the same calls, with the
    # host's enqueue through the wrapper, beside it.
    def ring(t, total=128e6):
        return [t.clone() for _ in range(max(2, int(total // (t.numel() * t.element_size())) + 1))]

    for K, N in INT8_SHAPES:
        _, q, scale = int8_inputs(8, K, N, torch.bfloat16, dev, seed=1)
        qs, ws = ring(q), ring(q.to(torch.bfloat16))
        state = {"i": 0}

        def nxt(pool):
            state["i"] += 1
            return pool[state["i"] % len(pool)]

        for M in INT8_TIMED_MS:
            x = int8_inputs(M, K, N, torch.bfloat16, dev, seed=M)[0]
            reps = 20
            kernel = lambda: ic.int8_matmul_cuda(x, nxt(qs), scale, torch.bfloat16)
            library = lambda: torch.matmul(x, nxt(ws))
            with torch.no_grad():
                t_kernel = graph_ms(kernel, reps)
                t_lib = graph_ms(library, reps)
                t_eager = cuda_ms(kernel, reps)
                t_lib_eager = cuda_ms(library, reps)
                t_plain = cuda_ms(lambda: quant.int8_matmul_plain(x, nxt(qs), scale), 5)
                t_convert = cuda_ms(lambda: torch.matmul(x, nxt(qs).to(torch.bfloat16)), 5)
            b = bound(2.0 * M * K * N, M * K * 2 + K * N + N * 4 + M * N * 2, "bfloat16")
            say("int8", f"M={M} K={K} N={N} bf16 ({int8_plan_text(M, K, N, torch.bfloat16)}): "
                f"kernel {t_kernel:.4f} ms of device time (CUDA graph of {reps}), bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {b['bound_ms'] / t_kernel:.0%} of it); "
                f"torch.matmul on a bf16 weight {t_lib:.4f} ms the same way (kernel / matmul "
                f"{t_kernel / t_lib:.2f}); eager, with the host's enqueue: kernel {t_eager:.4f}, "
                f"matmul {t_lib_eager:.4f} ms; plain {t_plain:.4f} ms, convert + matmul "
                f"{t_convert:.4f} ms; card {power_line}")
            if (K, N) == (4096, 11008) and M != 40:
                name = INT8_CLUSTER if M == 8 else INT8_TILED
                results[name] = dict(
                    max_abs_err=worst["small" if M == 8 else "tiled"], ms=t_kernel,
                    plain_ms=t_plain, library_ms=t_lib, eager_ms=t_eager,
                    convert_matmul_ms=t_convert, **b)
        del qs, ws


# ---------------------------------------------------------------------------
# BCI main paths: serving and the LoRA fine-tune at Llama-2-7B width
# ---------------------------------------------------------------------------

# meta-llama/Llama-2-7b-hf config.json (the widths; the weights are random)
LLAMA2_7B = {
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
    "max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False,
}
BCI_B, BCI_BINS, BCI_CHANNELS, BCI_TEXT, BCI_SPLIT = 8, 512, 256, 64, 8
BCI_PROMPT = BCI_TEXT + (BCI_BINS - 32) // 4 + 1      # 64 text + 121 spike tokens = 185
INT8_PER_FORWARD = 7 * 32 + 1                         # 7 projections a layer + lm_head
LORA = {"r": 8, "alpha": 32, "dropout": 0.0, "modules_to_save": [],
        "target_modules": ["q_proj", "v_proj", "k_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj"]}


def write_llama_config(root: str, n_layers: int) -> str:
    """A directory with the Llama-2-7B ``config.json`` at ``n_layers`` and no
    weight files: the model's widths, random weights."""
    path = os.path.join(root, f"llama2_7b_{n_layers}l")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**LLAMA2_7B, "num_hidden_layers": n_layers}, f)
    return path


def bci_rows(n: int, seed: int) -> list:
    """Pre-tokenized BCI trials: 512 bins x 256 channels of Poisson spikes, 64
    text tokens with the spikes spliced in at 8, the loss on the last 48."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ids = rng.integers(3, LLAMA2_7B["vocab_size"], size=(BCI_TEXT,)).astype(np.int64)
        rows.append({
            "spikes": rng.poisson(1.0, size=(BCI_BINS, BCI_CHANNELS)).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones(BCI_TEXT, np.int64),
            "input_split": np.atleast_1d(BCI_SPLIT),
            "labels": np.concatenate([np.full(16, -100, np.int64), ids[16:]]),
            "sentence": "a b c", "day_idx": np.asarray(i % 2), "block_idx": np.asarray(i % 2),
        })
    return rows


class WordTokenizer:
    """A stand-in for the Llama tokenizer over a fixed word list (the words of
    ``SENTENCES``): ids 0, 1, 2 are unk, bos and eos, which
    ``skip_special_tokens`` drops; any other id decodes to a word."""

    unk_token_id, bos_token_id, eos_token_id = 0, 1, 2
    WORDS = sorted({w for s in SENTENCES for w in s.split()})

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        return " ".join(self.WORDS[i % len(self.WORDS)] for i in ids
                        if not (skip_special_tokens and i < 3))


def bci_serving_batch(device):
    import torch

    rows = bci_rows(BCI_B, seed=0)
    stack = lambda key: torch.from_numpy(np.stack([r[key] for r in rows])).to(device)
    T = BCI_BINS
    return {
        "input_ids": stack("input_ids"), "attention_mask": stack("attention_mask"),
        "input_split": stack("input_split"), "spikes": stack("spikes"),
        "spikes_mask": torch.ones((BCI_B, T), dtype=torch.int64, device=device),
        "spikes_timestamp": torch.arange(T, device=device).expand(BCI_B, T).contiguous(),
        "block_idx": stack("block_idx"), "day_idx": stack("day_idx"),
    }


def device_profile(fn, label: str, power_line: str, path=None, wall_ms_unprofiled=None,
                   phase: str = "bci") -> dict:
    """``torch.profiler`` over ``fn()``: device-busy time (the sum of the
    kernel rows) and its split by kind of kernel, beside the wall time under
    the profiler and, where given, the wall time of the same call without it
    (the profiler slows the host's launches, not the kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and not ev.key.startswith("Optimizer.")]
    dev_us = lambda ev: getattr(ev, "self_device_time_total", None) or getattr(
        ev, "self_cuda_time_total", 0)
    rows = sorted(((dev_us(ev), ev.count, ev.key) for ev in events if dev_us(ev) > 0),
                  reverse=True)
    total = sum(us for us, _, _ in rows)
    groups = {"int8 matmul kernels": ("int8_",), "flash attention kernels": ("flash_",),
              "GEMMs": ("nvjet", "gemm", "cutlass", "gemv"),
              "copies and casts": ("copy", "Memcpy"), "softmax": ("softmax",),
              "index / gather / scatter": ("index", "gather", "scatter"),
              "random draws": ("distribution", "philox", "rand"),
              "AdamW": ("multi_tensor", "adam")}
    other = "other (elementwise, reductions, norms)"
    shares = dict.fromkeys([*groups, other], 0.0)
    n_launches = 0
    for us, count, key in rows:
        name = next((g for g, pats in groups.items() if any(p in key for p in pats)), other)
        shares[name] += us
        n_launches += count
    busy = (f"{total / 1e3 / wall_ms_unprofiled:.3f} of the {wall_ms_unprofiled:.1f} ms the call "
            f"takes without the profiler, " if wall_ms_unprofiled else "")
    say(phase, f"{label}: device busy {total / 1e3:.1f} ms ({busy}"
        f"{total / 1e3 / wall_ms:.3f} of the {wall_ms:.1f} ms under the profiler), "
        f"{n_launches} kernel launches; card {power_line}")
    for name, us in shares.items():
        say(phase, f"  {us / 1e3:9.3f} ms {us / max(total, 1):7.3%} {name}")
    if path:
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(f"\n{label}; card: {power_line}\nwall under the profiler {wall_ms:.1f} ms, "
                    f"without {wall_ms_unprofiled} ms, device busy {total / 1e3:.1f} ms, "
                    f"{n_launches} launches\n")
            for name, us in shares.items():
                f.write(f"{us / 1e3:10.3f} ms {us / max(total, 1):7.3%} {name}\n")
            for us, count, key in rows[:30]:
                f.write(f"{us / 1e3:10.3f} ms {us / total:7.3%} x{count:<6d} {key[:110]}\n")
    return {"wall_ms": wall_ms, "busy_ms": total / 1e3, "launches": n_launches}


def build_bci(llm_path: str, quant, device):
    """BCI as ``configs/bci.yaml`` + ``configs/ndt1.yaml`` give it (NDT1 trunk
    5 x 1024, stack 32 / 4, projector 1024 -> 2048 -> 4096), LoRA r=8 on all
    seven projections, the Llama widths from ``llm_path/config.json``."""
    import torch
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.models.bci import BCI

    torch.manual_seed(0)
    t0 = time.perf_counter()
    model = BCI.from_config(
        DictConfig({"ndt1": {"encoder": {"embedder": {"n_channels": BCI_CHANNELS}}}}),
        method_name="endtoend", llm_path=llm_path, lora=dict(LORA), freeze_llm=False,
        quantize=quant, compute_dtype="bfloat16", device=device,
    ).eval()
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def prefill_step(model, batch, new_tokens: int):
    """The eager prefill of ``generate``'s greedy decode and the
    :class:`TokenStep` over its cache, not yet run: ``(first ids, step, P)``."""
    import torch
    from llm_bci_tpu_torch.models.decode_graph import TokenStep

    embeds, mask, _ = model.prepare_embeds(**batch)
    B, P, _ = embeds.shape
    key_mask = mask.new_zeros((B, P + new_tokens))
    key_mask[:, :P] = mask
    decode = lambda e, km, c, idx: model.llm(inputs_embeds=e, attention_mask=km, cache=c,
                                             cache_index=idx)
    logits, cache = decode(embeds, key_mask, model.llm.init_cache(B, P + new_tokens), 0)
    return torch.argmax(logits[:, -1, :], -1), TokenStep(decode, cache, key_mask), P


def bci_serve_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.models import llama as tllama
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    from llm_bci_tpu_torch.ops import quant

    dev = torch.device("cuda")
    new_tokens, beams = 32, 5
    batch = bci_serving_batch(dev)
    vocab = LLAMA2_7B["vocab_size"]
    autocast = lambda: torch.autocast("cuda", dtype=torch.bfloat16)

    def check_ids(ids, shape, what):
        if tuple(ids.shape) != shape or ids.dtype != torch.int64:
            raise AssertionError(f"{what}: shape {tuple(ids.shape)} {ids.dtype}, want {shape}")
        if int(ids.min()) < 0 or int(ids.max()) >= vocab:
            raise AssertionError(f"{what}: token ids out of [0, {vocab})")

    def timed(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    def greedy(m, n=new_tokens):
        with autocast():
            return m.generate(**batch, max_new_tokens=n, eos_token_id=-1)

    def diverse(m):
        with autocast():
            return m.generate(**batch, max_new_tokens=new_tokens, num_beams=beams,
                              num_beam_groups=beams, diversity_penalty=1.2,
                              num_return_sequences=beams, eos_token_id=2)

    def decode_times(m, label):
        """Greedy tokens/s of a whole decode (its eager prefill, its eager
        first token step, its capture and 30 replays) and its parts: the
        prefill alone, the capture, the token steps; then a profile of 16
        replayed greedy steps (argmax, embedding, key mask and the graph of
        the step)."""
        decode_graph.reset_counters()
        g_s = timed(lambda: greedy(m))
        capture_s = decode_graph.CAPTURE_SECONDS / decode_graph.CAPTURES
        with torch.no_grad(), autocast():
            prefill_s = timed(lambda: prefill_step(m, batch, new_tokens))
        step_ms = (g_s - prefill_s) * 1e3 / (new_tokens - 1)
        say("bci", f"{label}: greedy {BCI_B * new_tokens / g_s:.1f} tokens/s ({g_s * 1e3:.1f} ms "
            f"for {new_tokens} tokens of B={BCI_B}, each decode capturing its own token step): "
            f"prefill (M={BCI_B * BCI_PROMPT}, eager) {prefill_s * 1e3:.1f} ms, {step_ms:.3f} ms a "
            f"token step (the rest over {new_tokens - 1} steps: one eager, the capture "
            f"{capture_s * 1e3:.1f} ms, {new_tokens - 2} replays); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; card {power_line}")
        with torch.no_grad(), autocast():
            token, step, P = prefill_step(m, batch, 40)
            step.key_mask[:, P] = 1
            step(m.llm.embed(token[:, None]), P)          # the first step and the capture

            def steps(n=16):
                tok = token
                for t in range(1, n + 1):
                    step.key_mask[:, P + t] = 1
                    tok = torch.argmax(step(m.llm.embed(tok[:, None]), P + t), -1)
                return tok

            wall_ms = timed(steps) * 1e3
            prof = device_profile(steps, f"16 replayed greedy token steps, {label}", power_line,
                                  profile, wall_ms)
        say("bci", f"{label}: a replayed greedy token step {prof['busy_ms'] / 16:.3f} ms of "
            f"device time, {wall_ms / 16:.3f} ms of wall time")
        return g_s, wall_ms / 16

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # Kernel path against the plain matmul on the card, 2 layers deep.
        small, _ = build_bci(write_llama_config(tmp, 2), "int8", dev)
        with torch.no_grad(), autocast():
            embeds, mask, _ = small.prepare_embeds(**batch)
            k_logits, _ = small.llm(inputs_embeds=embeds, attention_mask=mask)
            decode_graph.reset_counters()
            k_tokens = small.generate(**batch, max_new_tokens=new_tokens, eos_token_id=-1)
            kernel_matmul = tllama.int8_matmul
            tllama.int8_matmul = quant.int8_matmul_plain
            try:
                p_logits, _ = small.llm(inputs_embeds=embeds, attention_mask=mask)
                p_tokens = small.generate(**batch, max_new_tokens=new_tokens, eos_token_id=-1)
            finally:
                tllama.int8_matmul = kernel_matmul
        # each decode captured its own step: the second from the plain product
        if decode_graph.CAPTURES != 2:
            raise AssertionError(f"{decode_graph.CAPTURES} captures for two decodes, want 2")
        top = p_logits.abs().max().item()
        err = (k_logits - p_logits).abs()
        # bf16 activations through 15 products in a chain (2 layers and
        # lm_head): each output is rounded to bf16 (the plain version twice,
        # before and after the scale) and summed in another order, so single
        # entries of the 47 M logits differ by a few bf16 steps of the largest
        # logit (2^-8 of it each) while the mean stays under one step: 15
        # independent roundings of 2^-9 relative each give about sqrt(15) *
        # 2^-9 = 2^-7 of a typical logit, itself a fraction of the largest.
        if not (err.max().item() <= 2.0 ** -5 * top and err.mean().item() <= 2.0 ** -8 * top):
            raise AssertionError(f"kernel and plain logits disagree: max|err| {err.max().item()} "
                                 f"mean|err| {err.mean().item()} of max|logit| {top}")
        same = (k_tokens == p_tokens).float().mean().item()
        say("bci", f"2-layer int8 model, kernel against plain matmul on the card: prompt logits "
            f"max|err| {err.max().item():.3e}, mean|err| {err.mean().item():.3e} of max {top:.3e} "
            f"(held to 2^-5 and 2^-8 of it); "
            f"{same:.3f} of {k_tokens.numel()} greedy tokens equal, "
            f"{int((k_tokens[:, 0] == p_tokens[:, 0]).sum())} of {BCI_B} first tokens (an argmax "
            f"can flip on a near-tie of bf16 logits and the row then goes its own way; the "
            f"logits are what is held)")
        del small, embeds, k_logits, p_logits, err

        # Main path: 32 layers, int8 base.
        path32 = write_llama_config(tmp, 32)
        torch.cuda.reset_peak_memory_stats()
        model, build_s = build_bci(path32, "int8", dev)
        if dataclasses.asdict(model.llama_config) != LLAMA2_7B:
            raise AssertionError(f"not Llama-2-7B: {model.llama_config}")
        weights_gib = torch.cuda.memory_allocated() / 2 ** 30
        say("bci", f"BCI with a 32-layer int8 Llama-2-7B-width base built on the card in "
            f"{build_s:.1f} s, {weights_gib:.2f} GiB allocated")

        ic.reset_counters()
        decode_graph.reset_counters()
        tokens = greedy(model)
        result = diverse(model)
        torch.cuda.synchronize()
        launches = int8_launches()
        graphs = (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS)
        check_ids(tokens, (BCI_B, new_tokens), "greedy")
        check_ids(result.sequences, (BCI_B, beams, new_tokens), "diverse beam")
        if tuple(result.scores.shape) != (BCI_B, beams) or not torch.isfinite(result.scores).all():
            raise AssertionError("diverse beam scores have the wrong shape or are not finite")
        if (result.scores[:, :-1] < result.scores[:, 1:]).any():
            raise AssertionError("diverse beam hypotheses are not sorted best-first")
        # Each decode: one eager prefill (M = B x 185 rows or 5 times that:
        # wgmma tiles), then 31 token steps (M = 8 greedy, 40 with 5 beams:
        # the cluster kernel): the first eager, then captured once and
        # replayed 30 times. The wrappers count on the host: the eager step
        # and the capture; the device runs the eager step and the replays.
        if graphs != (2, 2, 2 * (new_tokens - 2)):
            raise AssertionError(f"eager steps, captures, replays {graphs}, "
                                 f"want (2, 2, {2 * (new_tokens - 2)})")
        want = {INT8_TILED: 2 * INT8_PER_FORWARD,
                INT8_CLUSTER: (graphs[0] + graphs[1]) * INT8_PER_FORWARD}
        if launches != want or ic.LAUNCHES != sum(want.values()):
            raise AssertionError(f"int8 launches {launches} (total {ic.LAUNCHES}), want {want}")
        on_device = (graphs[0] + graphs[2]) * INT8_PER_FORWARD
        say("bci", f"greedy ({new_tokens} tokens) + diverse beam ({beams} groups) at 32 layers: "
            f"2 prefills, {graphs[0]} eager token steps, {graphs[1]} captures, {graphs[2]} "
            f"replays; int8 launches on the host {launches} = {INT8_PER_FORWARD} a model call x "
            f"(2 prefills | {graphs[0]} eager steps + {graphs[1]} captures); cluster kernel runs "
            f"on the device {on_device} = {INT8_PER_FORWARD} x ({graphs[0]} + {graphs[2]}) = "
            f"{INT8_PER_FORWARD} x 2 x {new_tokens - 1}")

        # The graph's greedy ids against the un-graphed step function on the
        # card, fed the same tokens: the same argmax at every step.
        with torch.no_grad(), autocast():
            first, step, P = prefill_step(model, batch, new_tokens)
            eager = [first]
            for t in range(new_tokens - 1):
                step.key_mask[:, P + t] = 1
                step.embeds = model.llm.embed(tokens[:, t:t + 1])
                step.position.fill_(P + t)
                eager.append(torch.argmax(step.run_eager(), -1))
            eager = torch.stack(eager, 1)
        if not torch.equal(eager, tokens):
            raise AssertionError(f"greedy ids from the graph differ from the eager step's at "
                                 f"{int((eager != tokens).sum())} of {tokens.numel()} places")
        say("bci", f"greedy ids from the replayed graph equal the un-graphed step's on the card "
            f"({tokens.numel()} ids)")
        del step

        g_s, g_step_ms = decode_times(model, "int8 base, 32 layers")
        d_s = timed(lambda: diverse(model), reps=1)
        say("bci", f"int8 base, diverse beam ({beams} groups, M={BCI_B * beams}): "
            f"{BCI_B / d_s:.2f} sequences/s ({d_s * 1e3:.0f} ms for {BCI_B} x {beams} "
            f"hypotheses of {new_tokens} tokens, each decode capturing its own token step); "
            f"card {power_line}")
        del model
        torch.cuda.empty_cache()

        # The same greedy decode on a bf16 base, through the same graph.
        torch.cuda.reset_peak_memory_stats()
        model, build_s = build_bci(path32, None, dev)
        before = ic.LAUNCHES
        tokens_bf16 = greedy(model)
        check_ids(tokens_bf16, (BCI_B, new_tokens), "greedy (bf16 base)")
        if ic.LAUNCHES != before:
            raise AssertionError("the bf16 base launched the int8 kernel")
        b_s, b_step_ms = decode_times(model, f"bf16 base, 32 layers (built in {build_s:.1f} s)")
        say("bci", f"int8 / bf16 base greedy tokens/s = {b_s / g_s:.3f}, a replayed token step "
            f"{g_step_ms:.3f} / {b_step_ms:.3f} ms of wall time; card {power_line}")
        del model
        torch.cuda.empty_cache()
    return launches


def bci_train_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    steps = 4
    dataset = {"train": bci_rows(32, seed=1), "test": bci_rows(BCI_B, seed=2)}
    losses = []

    def record(model, model_inputs, unused_inputs, outputs, **kwargs):
        losses.append(float(outputs["loss"]) / float(outputs["n_examples"]))
        return losses[-1]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        args = port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_bci.yaml"),
            "-k", f"method.model_kwargs.llm_path={write_llama_config(tmp, 32)}",
            "method.model_kwargs.quantize=int8", f"training.train_batch_size={BCI_B}",
            f"training.test_batch_size={BCI_B}", f"training.max_steps={steps}",
            f"training.eval_every={steps}", "training.save_every=null",
            f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}", "dirs.log_dir=null",
            "verbosity=1",
        ])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = port_main.build_trainer(args, dataset=dataset)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        model = trainer.model
        trainer.metric_fns["loss_per_token"] = record
        if dataclasses.asdict(model.llama_config) != LLAMA2_7B:
            raise AssertionError(f"not Llama-2-7B: {model.llama_config}")
        if model.quant != "int8" or model.lora_r != 8 or model.dtype != torch.bfloat16:
            raise AssertionError("not the int8 LoRA model of configs/trainer_bci.yaml")
        trains = {k for k, p in model.named_parameters() if p.requires_grad}
        stray = [k for k in trains if not (".lora_" in k or k.startswith(("ndt1_encoder.",
                                                                         "projector_")))]
        if stray or not any(".lora_" in k for k in trains):
            raise AssertionError(f"unexpected trainable leaves: {stray[:5]}")
        state = model.state_dict()
        frozen = {k: v.clone() for k, v in state.items() if k not in trains}
        moving = {k: v.clone() for k, v in state.items() if k in trains}
        n_train = sum(v.numel() for v in moving.values())
        say("bci", f"trainer built in {build_s:.1f} s: {n_train:,} trainable parameters in "
            f"{len(trains)} leaves, {len(frozen)} frozen leaves "
            f"({sum(v.numel() * v.element_size() for v in frozen.values()) / 2 ** 30:.2f} GiB)")

        ic.reset_counters()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = int8_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

    eval_batches = len(trainer.test_dataloader)
    want = {INT8_CLUSTER: 0, INT8_TILED: INT8_PER_FORWARD * (steps + eval_batches)}
    if launches != want or ic.LAUNCHES != sum(want.values()):
        raise AssertionError(f"int8 launches {launches}, want {want} (0 in the backward)")
    hist = trainer.eval_history
    if len(hist) != 1 or hist[0]["step"] != steps:
        raise AssertionError(f"expected one eval at step {steps}, got {hist}")
    h = hist[0]
    # the recorder ran on every train step and on every eval batch
    if len(losses) != steps + eval_batches or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    losses = losses[:steps]
    if not (np.isfinite(h["train_avg_loss"]) and np.isfinite(h["test_avg_loss"])):
        raise AssertionError(f"eval losses not finite: {h}")
    # 4 steps inside the warm-up of lr 5e-5 cannot fit anything yet: the loss
    # must stay of the order of ln(32000) = 10.4 and not blow up
    if not (losses[-1] <= 1.25 * losses[0] and max(losses) < 2 * math.log(32000)):
        raise AssertionError(f"train loss per token rose: {losses}")
    state = model.state_dict()
    for key, before in frozen.items():
        if not torch.equal(state[key], before):
            raise AssertionError(f"frozen leaf changed: {key}")
    moved = sum(not torch.equal(state[key], before) for key, before in moving.items())
    if moved < 0.9 * len(moving):
        raise AssertionError(f"only {moved} of {len(moving)} trainable leaves changed")
    say("bci", f"{steps} steps + eval ({eval_batches} batch) through the Trainer in {wall:.1f} s "
        f"(metric_lag {trainer.metric_lag}: {trainer.readback.drains} readbacks of the train "
        f"steps' losses and metric inputs): "
        f"loss per token {[round(x, 4) for x in losses]}, test_avg_loss "
        f"{h['test_avg_loss']:.4f}; int8 launches {launches} = {INT8_PER_FORWARD} a forward, "
        f"none in the backward; {len(frozen)} frozen leaves bit-identical, {moved} of "
        f"{len(moving)} trainable leaves changed")
    del frozen, moving, state

    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    if tuple(batch["spikes"].shape) != (BCI_B, BCI_BINS, BCI_CHANNELS):
        raise AssertionError(f"unexpected batch shape {tuple(batch['spikes'].shape)}")
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    say("bci", f"LoRA fine-tune step (B={BCI_B} x {BCI_PROMPT} tokens, 32 layers, int8 base, "
        f"bf16 autocast): {step_s * 1e3:.2f} ms/step, {BCI_B / step_s:.2f} samples/s; peak "
        f"memory {max(peak, torch.cuda.max_memory_allocated() / 2 ** 30):.2f} GiB; "
        f"card {power_line}")
    device_profile(lambda: [trainer.train_step(batch) for _ in range(2)],
                   "2 fine-tune steps, int8 base, 32 layers", power_line, profile,
                   2 * step_s * 1e3)
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def drive_main(cfg_path: str, overrides: list, tmp: str) -> tuple:
    """4 training steps and one eval through ``llm_bci_tpu_torch.main``, with
    the CTC launch counters set to 0 just before and read just after. Checks
    one eval at step 4 with finite losses; returns (trainer, launches, wall
    seconds, peak bytes)."""
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import ctc_cuda

    args = port_main.parse_args([
        "-c", cfg_path, "-k", *overrides, "training.max_steps=4", "training.eval_every=4",
        "training.save_every=null", f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}",
        "dirs.log_dir=null", "verbosity=1",
    ])
    torch.cuda.reset_peak_memory_stats()
    ctc_cuda.reset_counters()
    t0 = time.perf_counter()
    trainer = port_main.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
                "ctc_alpha_beta_kernel": ctc_cuda.FUSED_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.eval_history
    if len(hist) != 1 or hist[0]["step"] != 4:
        raise AssertionError(f"{cfg_path}: expected one eval at step 4, got {hist}")
    for key in ("train_avg_loss", "test_avg_loss"):
        if not np.isfinite(hist[0][key]):
            raise AssertionError(f"{cfg_path}: {key} is not finite: {hist[0][key]}")
    return trainer, launches, wall, peak


def steady_step_ms(trainer, reps: int = 20) -> tuple:
    """ms of a full train step on one fixed batch (3 warm-up steps first),
    and that batch."""
    import torch

    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, batch


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def main_path_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain
    from llm_bci_tpu_torch.models.ndt1 import stacked_lengths

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        write_mat_dataset(os.path.join(tmp, "mat"))
        say("main", f"synthetic speechbci files written in {time.perf_counter() - t0:.1f} s")
        trainer, launches, wall, peak = drive_main(
            os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"),
            [f"data.data_dir={os.path.join(tmp, 'mat')}"], tmp)

    h = trainer.eval_history[0]
    cer = h["test_avg_metrics"].get("CER")
    if cer is None or not 0.0 <= cer <= 2.0:
        raise AssertionError(f"eval CER missing or out of range: {cer}")
    # a training step forms its gradient in the forward (the fused kernel);
    # the eval's forward needs none (the alpha kernel)
    if launches["ctc_alpha_beta_kernel"] < 4 or launches["ctc_alpha_kernel"] < 1:
        raise AssertionError(f"CTC kernels not on the main path: launches {launches}")
    say("main", f"4 steps + eval through llm_bci_tpu_torch.main in {wall:.1f} s "
        f"(data, G2P and model set-up included): train_avg_loss={h['train_avg_loss']:.4f} "
        f"test_avg_loss={h['test_avg_loss']:.4f} CER={cer:.4f} launches={launches}")

    # The model's loss on a test batch (through the kernel) agrees with the
    # plain CTC on the same log-probs.
    model_inputs, _ = next(iter(trainer.test_dataloader))
    batch = trainer.to_device(model_inputs)
    trainer.model.eval()
    with torch.no_grad(), trainer.autocast():
        out = trainer.model(**batch)
    stack = trainer.config.model.encoder.embedder.stack
    lens = stacked_lengths(batch["spikes_lengths"], stack.size, stack.stride, stack.active)
    plain = ctc_loss_plain(out.preds.double(), batch["targets"], lens,
                           batch["targets_lengths"]).sum().float()
    if tuple(out.preds.shape) != (batch["spikes"].shape[0], T, V):
        raise AssertionError(f"unexpected preds shape {tuple(out.preds.shape)}")
    torch.testing.assert_close(out.loss, plain, rtol=1e-5, atol=1e-3)
    say("main", f"eval batch loss through the kernel {out.loss.item():.4f} "
        f"== plain CTC {plain.item():.4f}")

    # Steady-state train step at full width on one fixed batch.
    step_ms, batch = steady_step_ms(trainer)
    step_s = step_ms / 1e3
    n = int(batch["spikes"].shape[0])
    say("main", f"full-width train step (B={n}, 5x1024, bf16 autocast): "
        f"{1.0 / step_s:.3f} steps/s, {n / step_s:.1f} samples/s, "
        f"{step_s * 1e3:.2f} ms/step; peak memory of the main run "
        f"{peak / 2**30:.3f} GiB; card {power_line}")
    if profile:
        profile_step(trainer, batch, power_line, profile, "ctc", "NDT1-CTC",
                     {"CTC kernels": ("ctc_",),
                      "convolutions": ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad")})
    return launches


def write_spike_pickle(path: str, n_train: int = 64, n_val: int = 32, bins=(896, 1024),
                       channels: int = 256, seed: int = 0, n_regions: int = 0,
                       data_config=None) -> str:
    """Synthetic Poisson spikes (rate 1.0) as ``{split: [{"spikes": (T, N)
    float32}]}``; the first trial of each split has the longest length. With
    ``n_regions`` each row also names the region of each channel (``R0`` ..,
    in turn), as an IBL session does. With a trainer config's ``data``
    section, each row also has the behaviours an IBL session gives it: a
    ``choice`` in {-1, 1} and a ``wheel-speed`` trace of T bins, normalised
    over all trials when ``norm_behaviours`` says so (``data/ibl.py``'s rule)."""
    import pickle

    rng = np.random.default_rng(seed)
    regions = [f"R{i % n_regions}" for i in range(channels)] if n_regions else None
    data = {}
    for split, n in (("train", n_train), ("val", n_val)):
        lengths = rng.integers(bins[0], bins[1] + 1, size=n)
        lengths[0] = bins[1]
        data[split] = [{"spikes": rng.poisson(1.0, size=(int(t), channels)).astype(np.float32),
                        **({"neuron_regions": list(regions)} if regions else {})}
                       for t in lengths]
    if data_config is not None:
        rows = [row for split in data.values() for row in split]
        for row in rows:
            spikes = row["spikes"]
            row["choice"] = np.atleast_1d(np.float32(rng.choice([-1.0, 1.0])))
            # a trace that the spikes carry: a few channels' smoothed rate
            row["wheel-speed"] = (np.convolve(spikes[:, :8].mean(1), np.ones(5) / 5, "same")
                                  + 0.1 * rng.normal(size=len(spikes))).astype(np.float32)
        if data_config.get("norm_behaviours"):
            for beh in data_config.get("dynamic_behaviours") or []:
                trials = np.stack([row[beh] for row in rows])
                mean, std = trials.mean(), trials.std()
                for row in rows:
                    row[beh] = (row[beh] - mean) / std
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


MLM_OVERRIDES = [
    "data.data_load=file", "training.train_batch_size=32", "training.test_batch_size=32",
    "model.encoder.masker.neuron.active=true", "model.encoder.masker.neuron.mode=random",
    "model.encoder.masker.neuron.ratio=0.3", "model.encoder.embedder.stack.active=false",
    "model.encoder.transformer.flash_attention=auto", "precision.compute_dtype=bfloat16",
]


def mlm_main_path_phase(power_line: str, profile) -> dict:
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc

    n_layers, steps = 5, 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        write_spike_pickle(os.path.join(tmp, "spikes.pkl"))
        say("mlm", f"synthetic spike pickle written in {time.perf_counter() - t0:.1f} s")
        args = port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
            "-k", *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
            f"training.max_steps={steps}", f"training.eval_every={steps}",
            "training.save_every=null", f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}",
            "dirs.log_dir=null", "verbosity=1",
        ])
        torch.cuda.reset_peak_memory_stats()
        fc.reset_counters()
        t0 = time.perf_counter()
        trainer = port_main.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {FWD_WG: fc.FWD_LAUNCHES, DQ_WG: fc.BWD_DQ_LAUNCHES,
                    DKV_WG: fc.BWD_DKV_LAUNCHES, "flash_delta_kernel": fc.BWD_DELTA_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()

    tr = trainer.config.model.encoder.transformer
    if (tr.n_layers, tr.hidden_size, tr.n_heads) != (n_layers, 1024, 8):
        raise AssertionError(f"not the full-width model: {dict(tr)}")
    hist = trainer.eval_history
    if len(hist) != 1 or hist[0]["step"] != steps:
        raise AssertionError(f"expected one eval at step {steps}, got {hist}")
    h = hist[0]
    for key in ("train_avg_loss", "test_avg_loss"):
        if not np.isfinite(h[key]):
            raise AssertionError(f"{key} is not finite: {h[key]}")
    eval_batches = len(trainer.test_dataloader)
    want = {FWD_WG: n_layers * (steps + eval_batches), DQ_WG: n_layers * steps,
            DKV_WG: n_layers * steps, "flash_delta_kernel": n_layers * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    say("mlm", f"{steps} steps + eval ({eval_batches} batch) through llm_bci_tpu_torch.main in "
        f"{wall:.1f} s (data and model set-up included): train_avg_loss={h['train_avg_loss']:.4f} "
        f"test_avg_loss={h['test_avg_loss']:.4f} launches={launches}")

    # One training-mode forward: shapes, the masked share, finite values.
    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    n, T, N = batch["spikes"].shape
    if (n, T, N) != (32, 1024, 256):
        raise AssertionError(f"unexpected batch shape {(n, T, N)}")
    if int(batch["spikes_mask"][:, 0].sum()) == n:
        raise AssertionError("expected left padding in the batch")
    trainer.model.train()
    with torch.no_grad(), trainer.autocast():
        out = trainer.model(**batch, generator=trainer.generator)
    valid_bins = float(batch["spikes_mask"].sum()) * N
    share = float(out.n_examples) / valid_bins
    if tuple(out.preds.shape) != (n, T, N) or not torch.isfinite(out.preds).all():
        raise AssertionError("mlm preds have the wrong shape or are not finite")
    if not torch.isfinite(out.loss) or abs(share - 0.3) > 0.01:
        raise AssertionError(f"mlm loss {out.loss.item()} / masked share {share:.4f} (want 0.3)")
    say("mlm", f"training forward: loss/n_examples={out.loss.item() / float(out.n_examples):.4f}, "
        f"n_examples is {share:.4f} of the valid bins")

    # Steady-state train step at full width on one fixed batch.
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    say("mlm", f"full-width train step (B={n}, T={T}, 5x1024, 8 heads, bf16 autocast): "
        f"{step_s * 1e3:.2f} ms/step, {n / step_s:.1f} samples/s; peak memory of the main run "
        f"{peak / 2**30:.3f} GiB; card {power_line}")
    if profile:
        profile_step(trainer, batch, power_line, profile, "mlm", "NDT1-mlm",
                     {"flash attention kernels": ("flash_",)})
    return launches


# ---------------------------------------------------------------------------
# Co-smoothing, PhonemeLLM, eval_phonemes
# ---------------------------------------------------------------------------

# bench.py::bench_cosmooth's IBL shape: 256 channels in 4 regions, T=100 bins,
# 64 trials in test batches of 32
COSMOOTH_IBL = {"channels": 256, "regions": 4, "bins": 100, "trials": 64, "batch": 32}


def neuron_sweep(trainer, n_points: int, label: str, power_line: str, profile=None):
    """The neuron-mode sweep's held-out rates of the first ``n_points``
    channels, ``(n_points, trials, T)``, and its neurons/s; one chunk runs
    first as a warm-up. The scoring on the host is not timed. With
    ``profile``, a table of one chunk's kernels goes there."""
    import torch
    from llm_bci_tpu_torch.eval import co_smoothing as cs

    batches, region_list = cs.sweep_inputs(trainer)
    run = lambda points: np.concatenate([
        rates for _, rates in cs.run_sweep(trainer, batches, cs.SWEEP_MASKERS["neuron"],
                                           cs.mode_overrides("neuron", region_list), points,
                                           channel_for=lambda n: n)])
    run(list(range(cs.SWEEP_BATCH)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rates = run(list(range(n_points)))
    seconds = time.perf_counter() - t0
    if profile:
        chunk = list(range(cs.SWEEP_BATCH))
        device_profile(lambda: run(chunk), f"co-smoothing, one folded pass of "
                       f"{cs.SWEEP_BATCH} neurons, {label}", power_line, profile,
                       seconds * 1e3 * cs.SWEEP_BATCH / n_points, phase="cosmooth")
    return rates, n_points / seconds


def check_bps(res: dict, want: dict, label: str) -> None:
    for mode, n in want.items():
        bps = np.asarray(res[mode]["bps"], np.float64)
        if len(bps) != n or np.isinf(bps).any():
            raise AssertionError(f"{label} {mode}: {len(bps)} bits-per-spike (want {n}), "
                                 f"finite or NaN: {bps[:8]}")


def cosmooth_phase(power_line: str, profile=None) -> dict:
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.config import DictConfig, resolve_path, update_config
    from llm_bci_tpu_torch.eval import co_smoothing as cs
    from llm_bci_tpu_torch.eval.metrics import bits_per_spike
    from llm_bci_tpu_torch.models import ndt1
    from llm_bci_tpu_torch.ops import flash_attention as fa
    from llm_bci_tpu_torch.ops import flash_attention_cuda as fc
    from llm_bci_tpu_torch.training.trainer import Trainer

    # IBL shape, dense attention (T=100 < FLASH_AUTO_MIN_T): every neuron
    ibl = COSMOOTH_IBL
    C, Tb = ibl["channels"], ibl["bins"]
    rng = np.random.default_rng(0)
    rows = [{"spikes": rng.poisson(0.5, size=(Tb, C)).astype(np.float32),
             "neuron_regions": [f"R{i % ibl['regions']}" for i in range(C)]}
            for _ in range(ibl["trials"])]
    pad = {"dim": 0, "side": "right", "value": 0, "truncate": None, "min_length": None}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trainer = Trainer(DictConfig({
            "savestring": "cosmooth", "verbosity": 3, "seed": 0,
            "dirs": {"checkpoint_dir": tmp, "log_dir": None},
            "training": {"num_epochs": 1, "train_batch_size": ibl["batch"],
                         "test_batch_size": ibl["batch"], "save_on_preemption": False},
            "model": update_config(resolve_path("configs/ndt1.yaml"), {"encoder": {
                "masker": {"neuron": {"active": True, "mode": "co-smooth", "ratio": 1.0,
                                      "channels": [0]}},
                "embedder": {"n_channels": C, "max_F": Tb, "input_dim": 256,
                             "stack": {"active": False}}}}),
            "data": {"dataset_class": "base"},
            "method": {"model_kwargs": {"method_name": "mlm", "loss": "poisson_nll",
                                        "log_input": True},
                       "dataset_kwargs": {}, "metric_kwargs": {},
                       "dataloader_kwargs": {"pad_dict": {
                           k: dict(pad) for k in ("spikes", "spikes_mask", "spikes_timestamp")}}},
            "optimizer": {"lr": 1e-3, "scheduler": "cosine", "warmup_pct": 0.1},
            "precision": {"compute_dtype": "bfloat16"},
        }), dataset={"train": rows, "test": rows})
    tr = trainer.config.model.encoder.transformer
    if (tr.n_layers, tr.hidden_size) != (5, 1024) or trainer.model.encoder._use_flash_now(Tb):
        raise AssertionError("not the full-width NDT1 on the dense path")
    fc.reset_counters()
    t0 = time.perf_counter()
    res = cs.co_smoothing_eval(trainer, modes=["neuron"])
    wall = time.perf_counter() - t0
    if fc.FWD_LAUNCHES:
        raise AssertionError(f"{fc.FWD_LAUNCHES} flash launches at T={Tb} (the dense path)")
    check_bps(res, {"neuron": C}, "IBL shape")
    bps = np.asarray(res["neuron"]["bps"])
    _, rate = neuron_sweep(trainer, C, "IBL shape", power_line, profile)
    say("cosmooth", f"IBL shape (NDT1 5 x 1024, {C} channels in {ibl['regions']} regions, "
        f"T={Tb}, {ibl['trials']} trials, dense attention, bf16): co_smoothing_eval of all {C} "
        f"neurons in {wall:.2f} s with the scoring; the sweep alone {rate:.1f} neurons/s "
        f"({cs.SWEEP_BATCH} neurons a folded pass of {cs.SWEEP_BATCH * ibl['batch']} rows); "
        f"bps median {np.nanmedian(bps):.4f}, {int(np.isnan(bps).sum())} NaN; card {power_line}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # The mlm model of the mlm main path at T=1024 (B=32): the flash path
    max_N, n_regions = 16, 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_spike_pickle(os.path.join(tmp, "spikes.pkl"), n_train=8, n_regions=n_regions)
        trainer = port_main.build_trainer(port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_ssl_ndt1.yaml"),
            "-k", *MLM_OVERRIDES, f"data.data_dir={tmp}", "data.data_file=spikes.pkl",
            "training.save_every=null", f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}",
            "dirs.log_dir=null", "verbosity=3",
        ]))
    batches, region_list = cs.sweep_inputs(trainer)
    n, T, N = batches[0]["spikes"].shape
    if (len(batches), n, T, N) != (1, 32, 1024, 256) or not trainer.model.encoder._use_flash_now(T):
        raise AssertionError(f"not the mlm shape on the flash path: {len(batches)} x {(n, T, N)}")
    fc.reset_counters()
    t0 = time.perf_counter()
    res = cs.co_smoothing_eval(trainer, max_N=max_N)
    wall = time.perf_counter() - t0
    launches = {FWD_WG: fc.FWD_LAUNCHES}
    passes = 2 * -(-max_N // cs.SWEEP_BATCH) + n_regions
    if launches[FWD_WG] != 5 * passes:
        raise AssertionError(f"{launches[FWD_WG]} flash forward launches, want 5 a folded pass "
                             f"x {passes} passes")
    check_bps(res, {"neuron": max_N, "intra-region": max_N, "inter-region": max_N}, "mlm")

    # Two neurons of a folded pass of 8 against a pass of each alone (K=1).
    # The folded pass's first flash call is recorded, to hold the kernel
    # against its plain version on those inputs below.
    seen, wrapped = [], ndt1.banded_flash_attention

    def record(q, k, v, key_valid, **kw):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone(), key_valid.clone(), dict(kw)))
        return wrapped(q, k, v, key_valid, **kw)

    ndt1.banded_flash_attention = record
    try:
        ((_, folded),) = cs.run_sweep(trainer, batches, cs.SWEEP_MASKERS["neuron"],
                                      cs.mode_overrides("neuron", region_list), list(range(8)),
                                      channel_for=lambda c: c)
    finally:
        ndt1.banded_flash_attention = wrapped
    spikes = batches[0]["spikes"]
    worst = [0.0, 0.0]
    for c in (0, 5):
        ((_, alone),) = cs.run_sweep(trainer, batches, cs.SWEEP_MASKERS["neuron"],
                                     cs.mode_overrides("neuron", region_list), [c],
                                     channel_for=lambda x: x, sweep_batch=1)
        err = float(np.abs(np.log(folded[c]) - np.log(alone[0])).max())
        d_bps = abs(bits_per_spike(folded[c][:, :, None], spikes[:, :, [c]])
                    - bits_per_spike(alone[0][:, :, None], spikes[:, :, [c]]))
        if not (err <= 2e-2 and d_bps <= 1e-3):
            raise AssertionError(f"neuron {c}: the folded pass differs from a pass alone: "
                                 f"log-rate max|err| {err}, bps {d_bps}")
        worst = [max(worst[0], err), max(worst[1], d_bps)]

    # The flash forward at the folded pass's own inputs (K x B rows, the
    # pickle's key padding, no dropout) against the plain version in float32,
    # 32 rows at a time (its (B, H, T, T) logits), at the bf16 out tolerance
    # of the flash phase.
    q, k, v, key_valid, kw = seen[0]
    if (tuple(q.shape) != (8 * n, T, 8, 128) or q.dtype != torch.bfloat16
            or kw["dropout_rate"] != 0.0 or not (key_valid == 0).any()):
        raise AssertionError(f"the folded pass's flash call: {tuple(q.shape)} {q.dtype} "
                             f"dropout {kw['dropout_rate']}, padded keys "
                             f"{int((key_valid == 0).sum())}")
    band = {b: kw[b] for b in ("context_forward", "context_backward")}
    got = fa.banded_flash_attention(q, k, v, key_valid, **band).float()
    ref = torch.cat([fa.banded_flash_attention_plain(
        q[i:i + n].float(), k[i:i + n].float(), v[i:i + n].float(), key_valid[i:i + n],
        **band) for i in range(0, len(q), n)])
    torch.cuda.synchronize()
    o_atol = FLASH_TOL["bfloat16"][0]
    flash_err = (got - ref).abs().max().item()
    torch.testing.assert_close(got, ref, atol=o_atol, rtol=0.0,
                               msg=lambda m: f"flash forward at the folded shape: {m}")
    say("cosmooth", f"{FWD_WG} at the folded pass's inputs (B={len(q)}, T={T}, H=8, D=128, "
        f"bf16, no dropout, {int((key_valid == 0).sum())} padded keys, band {band}) against "
        f"the plain version in float32: out max|err| {flash_err:.2e} (atol {o_atol})")
    del q, k, v, key_valid, got, ref, seen

    _, rate = neuron_sweep(trainer, max_N, "mlm shape", power_line, profile)
    say("cosmooth", f"mlm model (5 x 1024, 8 heads, D=128, B={n}, T={T}, bf16, flash): "
        f"co_smoothing_eval of {max_N} neurons in 3 modes ({passes} folded passes, "
        f"{launches[FWD_WG]} flash forward launches = 5 a pass) in {wall:.2f} s with the "
        f"scoring; neuron sweep {rate:.1f} neurons/s ({cs.SWEEP_BATCH * n} rows a pass); "
        f"folded against alone (neurons 0, 5): log-rate max|err| {worst[0]:.2e} "
        f"(atol 2e-2), bps {worst[1]:.2e} (1e-3); card {power_line}")
    del trainer, batches
    torch.cuda.empty_cache()
    return launches


PHONEME_FRAMES, PHONEME_VOCAB = (BCI_BINS - 32) // 4 + 1, 41     # 121 CTC frames x 41


def phoneme_batch(device, seed: int = 0) -> tuple:
    """B=8: CTC posteriors (softmax of seeded normals, 121 frames x 41) spliced
    into a 64-token prompt at 8; the loss on the last 48 text tokens."""
    import torch

    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(BCI_B, PHONEME_FRAMES, PHONEME_VOCAB))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rng.integers(3, LLAMA2_7B["vocab_size"], size=(BCI_B, BCI_TEXT))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    batch = {"input_ids": t(ids), "attention_mask": t(np.ones_like(ids)),
             "input_split": t(np.full((BCI_B,), BCI_SPLIT)),
             "phoneme_probs": t(probs.astype(np.float32)),
             "phonemes_mask": t(np.ones((BCI_B, PHONEME_FRAMES), np.int64))}
    return batch, t(np.where(np.arange(BCI_TEXT) >= 16, ids, -100))


def phoneme_llm_phase(power_line: str) -> dict:
    import torch
    from llm_bci_tpu_torch.config import DictConfig
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.models.phoneme_llm import PhonemeLLM

    dev = torch.device("cuda")
    new_tokens, beams = 32, 5
    vocab = LLAMA2_7B["vocab_size"]
    autocast = lambda: torch.autocast("cuda", dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        torch.manual_seed(0)
        t0 = time.perf_counter()
        model = PhonemeLLM.from_config(DictConfig({}), llm_path=write_llama_config(tmp, 32),
                                       lora=dict(LORA), compute_dtype="bfloat16", device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    if dataclasses.asdict(model.llama_config) != LLAMA2_7B or model.dtype != torch.bfloat16:
        raise AssertionError(f"not a bf16 Llama-2-7B: {model.llama_config}")
    batch, targets = phoneme_batch(dev)
    trains = {k for k, p in model.named_parameters() if p.requires_grad}
    if not trains or any(".lora_" not in k and not k.startswith("coupler") for k in trains):
        raise AssertionError(f"unexpected trainable leaves: {sorted(trains)[:5]}")
    state = model.state_dict()
    frozen = {k: v.clone() for k, v in state.items() if k not in trains}
    moving = {k: v.clone() for k, v in state.items() if k.endswith("lora_B") or
              k.startswith("coupler")}

    # one forward with a loss, one step of LoRA + coupler
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-4)
    model.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with autocast():
        out = model(**batch, targets=targets)
    out.loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n_tokens = BCI_B * (BCI_TEXT - 16)
    if tuple(out.preds.shape) != (BCI_B, BCI_TEXT + PHONEME_FRAMES, vocab):
        raise AssertionError(f"logits shape {tuple(out.preds.shape)}")
    if not torch.isfinite(out.loss) or int(out.n_examples) != n_tokens:
        raise AssertionError(f"loss {out.loss.item()} over {int(out.n_examples)} tokens")
    state = model.state_dict()
    for key, before in frozen.items():
        if not torch.equal(state[key], before):
            raise AssertionError(f"frozen leaf changed: {key}")
    stuck = [k for k, before in moving.items() if torch.equal(state[k], before)]
    if stuck:
        raise AssertionError(f"{len(stuck)} LoRA B / coupler leaves did not move: {stuck[:3]}")
    say("phoneme", f"PhonemeLLM (32 layers x Llama-2-7B width, bf16 base, LoRA r=8 on 7 "
        f"projections, B={BCI_B}, {PHONEME_FRAMES} x {PHONEME_VOCAB} posteriors spliced into "
        f"{BCI_TEXT} tokens) built in {build_s:.1f} s; a forward with the loss and one "
        f"LoRA + coupler step {step_s * 1e3:.1f} ms (the first): loss/token "
        f"{out.loss.item() / n_tokens:.4f}; {len(frozen)} frozen leaves bit-identical, "
        f"{len(moving)} LoRA B and coupler leaves moved")
    del frozen, moving, state, opt, out

    model.eval()

    def greedy():
        with autocast():
            return model.generate(**batch, max_new_tokens=new_tokens, eos_token_id=-1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    decode_graph.reset_counters()
    tokens = greedy()
    again, g_s = timed(greedy)
    with autocast():
        result, b_s = timed(lambda: model.generate(
            **batch, max_new_tokens=new_tokens, num_beams=beams, num_return_sequences=beams,
            eos_token_id=2))
    graphs = (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS)
    if graphs != (3, 3, 3 * (new_tokens - 2)):
        raise AssertionError(f"eager steps, captures, replays {graphs}")
    if tuple(tokens.shape) != (BCI_B, new_tokens) or not torch.equal(tokens, again):
        raise AssertionError("greedy ids have the wrong shape or differ between two decodes")
    if (tuple(result.sequences.shape) != (BCI_B, beams, new_tokens)
            or not torch.isfinite(result.scores).all()
            or (result.scores[:, :-1] < result.scores[:, 1:]).any()):
        raise AssertionError("beam hypotheses have the wrong shape, or are not finite and sorted")
    for ids in (tokens, result.sequences):
        if int(ids.min()) < 0 or int(ids.max()) >= vocab:
            raise AssertionError("token ids out of range")
    # the graph's greedy ids against the un-graphed step, fed the same tokens
    with torch.no_grad(), autocast():
        first, step, P = prefill_step(model, batch, new_tokens)
        eager = [first]
        for t in range(new_tokens - 1):
            step.key_mask[:, P + t] = 1
            step.embeds = model.llm.embed(tokens[:, t:t + 1])
            step.position.fill_(P + t)
            eager.append(torch.argmax(step.run_eager(), -1))
        eager = torch.stack(eager, 1)
    if not torch.equal(eager, tokens):
        raise AssertionError(f"greedy ids from the graph differ from the eager step's at "
                             f"{int((eager != tokens).sum())} of {tokens.numel()} places")
    say("phoneme", f"greedy {BCI_B * new_tokens / g_s:.1f} tokens/s ({g_s * 1e3:.1f} ms for "
        f"{new_tokens} tokens of B={BCI_B}, its capture included), beam {beams} "
        f"{BCI_B / b_s:.2f} sequences/s ({b_s * 1e3:.0f} ms); the graph's greedy ids equal the "
        f"un-graphed step's ({tokens.numel()} ids); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; card {power_line}")
    del model, step
    torch.cuda.empty_cache()
    return {}


def quantization_repair_check(tmp: str, power_line: str) -> None:
    """``BCI.load_checkpoint_params`` puts a saved LLM blob into the model's
    quantization layout, on the card, 2 layers deep at Llama-2-7B width: a
    bf16 checkpoint (the whole base) served int8, and that int8 checkpoint
    served on a bf16 base again. Every int8 leaf must equal ``quantize_int8``
    (axis 0, the JAX package's rule) of the saved weight; the int8 model's
    prompt logits, through the int8 kernels, must agree with those of the bf16
    model that holds the dequantized codes within the tolerance of the
    kernel's own check in the bci-serve phase (2^-5 and 2^-8 of the largest
    logit, max and mean)."""
    import torch
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic
    from llm_bci_tpu_torch.ops import quant

    dev = torch.device("cuda")
    batch = bci_serving_batch(dev)
    path = write_llama_config(tmp, 2)

    def logits(model):
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            embeds, mask, _ = model.prepare_embeds(**batch)
            return model.llm(inputs_embeds=embeds, attention_mask=mask)[0].float()

    def saved(model, name):
        os.makedirs(os.path.join(tmp, name))
        model.save_checkpoint(os.path.join(tmp, name))
        return os.path.join(tmp, name)

    t0 = time.perf_counter()
    trained, _ = build_bci(path, None, dev)
    ck_bf16, bf16_logits = saved(trained, "repair_bf16"), logits(trained)
    del trained
    served, _ = build_bci(path, "int8", dev)          # its own codes, replaced below
    served.load_checkpoint_params(ck_bf16)
    blob = torch.load(os.path.join(ck_bf16, "llm.pt"), map_location="cpu", weights_only=True)
    state, n = served.llm.state_dict(), 0
    for key, w in blob.items():
        prefix = key[:-len(".weight")]
        if key.endswith(".weight") and prefix + ".kernel" in state:
            q, scale = quant.quantize_int8(w.float().numpy().T, axis=0)
            if not (np.array_equal(state[prefix + ".kernel"].cpu().numpy(), q)
                    and np.array_equal(state[prefix + ".kernel_scale"].cpu().numpy(), scale)):
                raise AssertionError(f"{prefix}: the int8 leaves are not quantize_int8 of the "
                                     f"saved weight")
            n += 1
    if n != 7 * 2 + 1:
        raise AssertionError(f"{n} layers quantized from the bf16 checkpoint, want 15")
    del blob, state
    before = ic.LAUNCHES
    int8_logits = logits(served)
    if ic.LAUNCHES == before:
        raise AssertionError("the int8 model launched no int8 kernel")
    ck_int8 = saved(served, "repair_int8")
    del served
    back, _ = build_bci(path, None, dev)
    back.load_checkpoint_params(ck_int8)
    if any(k.endswith((".kernel", ".kernel_scale")) for k in back.llm.state_dict()):
        raise AssertionError("the bf16 model holds int8 leaves")
    ref = logits(back)
    del back
    seconds = time.perf_counter() - t0
    top = ref.abs().max().item()
    err = (int8_logits - ref).abs()
    if not (err.max().item() <= 2.0 ** -5 * top and err.mean().item() <= 2.0 ** -8 * top):
        raise AssertionError(f"int8 logits against the dequantized bf16 model: max|err| "
                             f"{err.max().item()} mean|err| {err.mean().item()} of {top}")
    q_err = (int8_logits - bf16_logits).abs()
    say("eval-ph", f"quantization-layout repair, 2 layers at 7B width: a bf16 checkpoint "
        f"served int8 ({n} layers quantized, each equal to quantize_int8 of the saved "
        f"weight), saved and served on a bf16 base again: int8 logits against the "
        f"dequantized bf16 model max|err| {err.max().item():.3e}, mean|err| "
        f"{err.mean().item():.3e} of max {top:.3e} (held to 2^-5 and 2^-8 of it); against "
        f"the trained bf16 model (the quantization's own error, not held) max|err| "
        f"{q_err.max().item():.3e}, mean|err| {q_err.mean().item():.3e}; {seconds:.1f} s "
        f"with two saves and loads; card {power_line}")
    del int8_logits, bf16_logits, ref, err, q_err
    gc.collect()
    torch.cuda.empty_cache()


def eval_phonemes_phase(power_line: str) -> dict:
    import pickle

    import torch
    from llm_bci_tpu_torch import eval_phonemes as tep
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.models import decode_graph
    from llm_bci_tpu_torch.ops import int8_matmul_cuda as ic

    trials, beam_sizes, new_tokens = 4, (1, 5), 20
    test = bci_rows(trials, seed=3)
    for i, row in enumerate(test):
        row["sentence"] = SENTENCES[i]
    dataset = {"train": bci_rows(BCI_B, seed=1), "test": test}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        quantization_repair_check(tmp, power_line)
        # One step on a bf16 base, saved without the frozen base (a 7B base
        # is gigabytes a save). The eval builds its int8 base from the same
        # seed, but an int8 layer draws its codes directly: it serves fresh
        # int8 codes with the trained LoRA factors, encoder and projector.
        # The repair of a saved base is held above, 2 layers deep.
        t0 = time.perf_counter()
        trainer = port_main.main(port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_bci.yaml"),
            "-k", f"method.model_kwargs.llm_path={write_llama_config(tmp, 32)}",
            f"training.train_batch_size={BCI_B}", f"training.test_batch_size={BCI_B}",
            "training.max_steps=1", "training.eval_every=null", "training.save_every=1",
            "training.component_blobs=false", f"dirs.checkpoint_dir={os.path.join(tmp, 'ck')}",
            "dirs.log_dir=null", "verbosity=1",
        ]), dataset=dataset)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if trainer.model.quant is not None or trainer.model.dtype != torch.bfloat16:
            raise AssertionError("not a bf16 base")
        ckpt = os.path.join(trainer.checkpoint_dir, "STEP1")
        saved = torch.load(os.path.join(ckpt, "llm.pt"), map_location="cpu", weights_only=True)
        if not saved or any(".lora_" not in k for k in saved):
            raise AssertionError("llm.pt holds more than the LoRA factors")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # the shapes of every int8 product are recorded on the way, to show
        # that the int8 phase held each kernel against its plain version there
        save, shapes, wrapped = os.path.join(tmp, "wer"), set(), ic.int8_matmul_cuda

        def record(x, q, scale, out_dtype):
            shapes.add((x.shape[0], *q.shape, x.dtype, out_dtype))
            return wrapped(x, q, scale, out_dtype)

        ic.int8_matmul_cuda = record
        ic.reset_counters()
        decode_graph.reset_counters()
        try:
            metrics = tep.main(tep.parse_args([
                "-k", f"from_pt={ckpt}", f"beams={','.join(map(str, beam_sizes))}",
                f"savestring={save}", f"test_len={trials}", "quantize=int8",
            ]), dataset=dataset, tokenizer=WordTokenizer())
        finally:
            ic.int8_matmul_cuda = wrapped
        torch.cuda.synchronize()
        launches = int8_launches()
        graphs = (decode_graph.EAGER_STEPS, decode_graph.CAPTURES, decode_graph.REPLAYS)
        for k in beam_sizes:
            with open(f"{save}_{k}.pkl", "rb") as f:
                preds = pickle.load(f)
            if len(preds) != trials or any(t.shape != (k, new_tokens) for t, _ in preds):
                raise AssertionError(f"{save}_{k}.pkl: {[t.shape for t, _ in preds]}")
    # a trial: the eval's forward (M = 185) and a decode: its prefill (M = 137,
    # 5 x 137 with beams), its eager first token step and the capture of the
    # step (M = 1 or 5), then the replays
    decodes = trials * len(beam_sizes)
    if graphs != (decodes, decodes, decodes * (new_tokens - 2)):
        raise AssertionError(f"eager steps, captures, replays {graphs}")
    want = {INT8_TILED: INT8_PER_FORWARD * 2 * decodes, INT8_CLUSTER: INT8_PER_FORWARD * 2 * decodes}
    if launches != want or ic.LAUNCHES != sum(want.values()):
        raise AssertionError(f"int8 launches {launches} (total {ic.LAUNCHES}), want {want}")
    unchecked = sorted((M, K, N) for M, K, N, dt, out in shapes
                       if M not in INT8_MS or (K, N) not in INT8_SHAPES
                       or dt != torch.bfloat16 or out != torch.bfloat16)
    if unchecked:
        raise AssertionError(f"int8 products at shapes the int8 phase does not check: {unchecked}")
    say("eval-ph", f"int8 products at M = {sorted({sh[0] for sh in shapes})} on the "
        f"Llama-2-7B (K, N), bf16: each held against the plain version by the int8 phase")
    if sorted(metrics) != list(beam_sizes) or not all(np.isfinite(m["WER"])
                                                      for m in metrics.values()):
        raise AssertionError(f"WER {metrics}")
    per_trial = ", ".join(f"beams={k}: {metrics[k]['seconds'] / trials:.3f} s/trial, WER "
                          f"{metrics[k]['WER']:.3f}" for k in beam_sizes)
    say("eval-ph", f"BCI at 32 layers x Llama-2-7B width trained 1 step on a bf16 base "
        f"({train_s:.1f} s with the build), saved without its base, served int8 by "
        f"llm_bci_tpu_torch.eval_phonemes on {trials} trials ({new_tokens} new tokens, diverse "
        f"beam): {per_trial}; int8 launches {launches} = {INT8_PER_FORWARD} x {2 * decodes} "
        f"(forwards + prefills | eager steps + captures), {graphs[2]} replays; card {power_line}")
    return launches


# ---------------------------------------------------------------------------
# iTransformer and PatchTST (ROADMAP slice 7)
# ---------------------------------------------------------------------------

CTC_KERNELS = ("ctc_alpha_kernel", "ctc_alpha_beta_kernel")
# the IBL behaviour session: COSMOOTH_IBL's 256 neurons in 4 regions and
# T=100 bins, its 64 trials split 48 / 16
IBL_SPLIT = (48, 16)
PATCHTST_CTC_BATCH = 64


def trainer_yaml(tmp: str, base: str, model: str) -> str:
    """``configs/<base>`` with ``model: include:configs/<model>``, written to
    ``tmp``."""
    import yaml

    with open(os.path.join(REPO, "configs", base)) as f:
        cfg = yaml.safe_load(f)
    cfg["model"] = f"include:configs/{model}"
    path = os.path.join(tmp, f"{os.path.splitext(base)[0]}_{model}")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def report_run(phase: str, label: str, trainer, launches: dict, wall: float, peak: int,
               power_line: str) -> tuple:
    """Prints a run's wall time, the steady train step, steps/s, peak memory
    and the CTC launches; returns (ms a step, the batch it was timed on)."""
    ms, batch = steady_step_ms(trainer)
    n = int(batch["spikes"].shape[0])
    h = trainer.eval_history[0]
    say(phase, f"{label}: 4 steps + eval through llm_bci_tpu_torch.main in {wall:.1f} s (data "
        f"and model set-up included): train_avg_loss={h['train_avg_loss']:.4f} test_avg_loss="
        f"{h['test_avg_loss']:.4f} {h['test_avg_metrics']}; steady train step (B={n}) "
        f"{ms:.2f} ms, {1e3 / ms:.2f} steps/s, {n * 1e3 / ms:.1f} samples/s; peak memory of "
        f"the run {peak / 2**30:.3f} GiB; CTC launches {launches}; card {power_line}")
    return ms, batch


def ctc_head_check(phase: str, label: str, trainer, lens_of, lattice: str,
                   power_line: str) -> dict:
    """The model's own float32 log-probs on a test batch (eval, autocast as
    trained) through the CTC kernels against the plain version in float64
    (``ctc_check``), then the pair's device time (CUDA graphs), ``F.ctc_loss``
    (eager) and the bound at those inputs."""
    import torch

    batch = trainer.to_device(next(iter(trainer.test_dataloader))[0])
    trainer.model.eval()
    with torch.no_grad(), trainer.autocast():
        out = trainer.model(**batch)
    lp = out.preds
    if lp.dtype != torch.float32:
        raise AssertionError(f"{label}: log-probs in {lp.dtype}, not float32")
    il = lens_of(batch).int()
    targets, tl = batch["targets"].int(), batch["targets_lengths"].int()
    res = ctc_check(label, lp, targets, il, tl, True, lattice)
    t = {**ctc_times(lp, targets, il, tl), **ctc_eager_times(lp, targets, il, tl, False)}
    fwd_bound, fused_bound = ctc_bounds(lp, targets, il, tl)
    say(phase, f"{label} CTC at (B, T', V, S) = {tuple(lp.shape)} + ({targets.shape[1]},), "
        f"{res['feasible']} of {lp.shape[0]} rows feasible, lattice in {lattice}: device time "
        f"(CUDA graphs of 20) ctc_alpha_kernel {t['fwd_ms']:.4f} ms (bound "
        f"{fwd_bound['bound_ms']:.5f}, {fwd_bound['bound_by']}), ctc_alpha_beta_kernel "
        f"{t['fused_ms']:.4f} ms, the pair with the backward's multiply {t['pair_ms']:.4f} ms "
        f"(bound {fused_bound['bound_ms']:.5f}, {fused_bound['bound_by']}); eager forward "
        f"{t['fwd_eager_ms']:.4f} ms, pair {t['pair_eager_ms']:.4f} ms; F.ctc_loss (eager) "
        f"forward {t['lib_fwd_ms']:.4f} ms, forward + backward {t['lib_pair_ms']:.4f} ms; "
        f"card {power_line}")
    return res


def check_ctc_run(label: str, trainer, launches: dict, frames: int) -> None:
    """A CTC run: the fused kernel once a training step, the forward-only
    kernel once an eval batch, a CER in [0, max(2, frames / the shortest
    test target)]: an edit distance is at most the longer string, and the
    greedy decode of ``frames`` frames has at most ``frames`` labels (an
    untrained head over 512 frames decodes far more labels than a target
    has)."""
    want = {"ctc_alpha_beta_kernel": 4, "ctc_alpha_kernel": len(trainer.test_dataloader)}
    if launches != want:
        raise AssertionError(f"{label}: CTC launches {launches}, want {want}")
    data = trainer.test_dataset
    shortest = min(len(row[data.targets_name]) for row in data.dataset)
    cer = trainer.eval_history[0]["test_avg_metrics"].get("CER")
    if cer is None or not 0.0 <= cer <= max(2.0, frames / shortest):
        raise AssertionError(f"{label}: eval CER missing or out of range: {cer} (at most "
                             f"max(2, {frames} frames / {shortest} labels))")


def itransformer_phase(power_line: str, profile=None) -> dict:
    """iTransformer at ``configs/itransformer.yaml``'s widths: the three IBL
    configs (mlm, choice, wheel speed) with behaviour decoding, then the
    ``ctc`` head at the speechbci shape (T' = 512: the global-scratch plan)."""
    import torch
    from llm_bci_tpu_torch.config import update_config
    from llm_bci_tpu_torch.eval.behaviour_decoding import behaviour_decoding_eval

    ibl = COSMOOTH_IBL
    total = dict.fromkeys(CTC_KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in ("ssl", "choice", "wheel"):
            cfg_path = os.path.join(REPO, "configs", f"trainer_{name}_itransformer.yaml")
            write_spike_pickle(os.path.join(tmp, f"{name}.pkl"), *IBL_SPLIT,
                               bins=(ibl["bins"], ibl["bins"]), channels=ibl["channels"],
                               n_regions=ibl["regions"],
                               data_config=update_config(cfg_path, None).data)
            trainer, launches, wall, peak = drive_main(cfg_path, [
                "data.data_load=file", f"data.data_dir={tmp}", f"data.data_file={name}.pkl"],
                tmp)
            add_launches(total, launches)
            enc = trainer.model.config["encoder"]
            width = (enc["hidden_size"], enc["n_layers"], enc["n_heads"], enc["max_n_channels"],
                     enc["embedder"]["mode"], enc["embedder"]["max_n_bins"], len(enc["regions"]))
            if width != (768, 5, 8, 1500, "mlp", ibl["bins"], ibl["regions"]):
                raise AssertionError(f"{name}: not the config's widths, or max_n_bins / regions "
                                     f"not pinned: {width}")
            if any(launches.values()):
                raise AssertionError(f"{name}: CTC launches without a CTC head: {launches}")
            report_run("itransformer", f"{name} (trainer_{name}_itransformer.yaml, B=16, "
                       f"{ibl['channels']} neurons, T={ibl['bins']})", trainer, launches, wall,
                       peak, power_line)
            if name == "choice":
                acc = trainer.eval_history[0]["test_avg_metrics"]["accuracy"]
                dec = behaviour_decoding_eval(trainer, is_cls=True)
                if trainer.model.n_labels != 2 or not (0 <= acc <= 1 and 0 <= dec["acc"] <= 1):
                    raise AssertionError(f"choice: n_labels {trainer.model.n_labels}, accuracy "
                                         f"{acc}, behaviour decoding {dec}")
                say("itransformer", f"choice: eval accuracy {acc:.4f}; behaviour_decoding_eval "
                    f"{dec}")
            elif name == "wheel":
                dec = behaviour_decoding_eval(trainer, is_cls=False,
                                              regression_metrics=["r2", "mse"])
                if not np.isfinite(list(dec.values())).all():
                    raise AssertionError(f"wheel: behaviour decoding {dec}")
                say("itransformer", f"wheel: behaviour_decoding_eval {dec}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()

        mat = write_mat_dataset(os.path.join(tmp, "mat"))
        cfg_path = trainer_yaml(tmp, "trainer_ctc_ndt1.yaml", "itransformer.yaml")
        # speechbci trials carry no brain regions
        trainer, launches, wall, peak = drive_main(
            cfg_path, [f"data.data_dir={mat}", "model.encoder.embed_region=false"], tmp)
    add_launches(total, launches)
    enc = trainer.model.config["encoder"]
    if (enc["hidden_size"], enc["n_layers"], enc["embedder"]["max_n_bins"]) != (768, 5, 512):
        raise AssertionError(f"ctc: widths or max_n_bins {enc}")
    check_ctc_run("iTransformer ctc", trainer, launches, enc["embedder"]["max_n_bins"])
    _, batch = report_run("itransformer", "ctc (trainer_ctc_ndt1.yaml with itransformer.yaml, "
                          "B=64, 480-512 bins x 256 inputs)", trainer, launches, wall, peak,
                          power_line)
    ctc_head_check("itransformer", "iTransformer ctc head", trainer,
                   lambda b: b["spikes_lengths"], "global", power_line)
    if profile:
        profile_step(trainer, batch, power_line, profile, "itransformer", "iTransformer-CTC",
                     {"CTC kernels": ("ctc_",)})
    del trainer
    return total


def running_stats(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers() if n.endswith(("_mean", "_var"))}


def check_running_stats(label: str, trainer) -> None:
    """BatchNorm's running averages are finite and moved from their start (0,
    1) by training, and an eval leaves them."""
    import torch

    stats = running_stats(trainer.model)
    if len(stats) != 2 * 2 * trainer.config.model.encoder.num_hidden_layers:
        raise AssertionError(f"{label}: running statistics {sorted(stats)}")
    for n, v in stats.items():
        start = torch.zeros_like(v) if n.endswith("_mean") else torch.ones_like(v)
        if not torch.isfinite(v).all() or torch.equal(v, start):
            raise AssertionError(f"{label}: {n} not finite or not moved by training")
    trainer.evaluate()
    if any(not torch.equal(v, stats[n]) for n, v in running_stats(trainer.model).items()):
        raise AssertionError(f"{label}: an eval moved the running statistics")


def patchtst_phase(power_line: str, profile=None) -> dict:
    """PatchTST at ``configs/patchtst.yaml``'s widths: ``mlm`` at the IBL shape
    (context 100, 10 patches) and ``ctc`` at the speechbci shape (context 520,
    52 patches: the shared-memory plan)."""
    import torch

    ibl = COSMOOTH_IBL
    total = dict.fromkeys(CTC_KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_spike_pickle(os.path.join(tmp, "ibl.pkl"), *IBL_SPLIT,
                           bins=(ibl["bins"], ibl["bins"]), channels=ibl["channels"],
                           n_regions=ibl["regions"])
        cfg_path = trainer_yaml(tmp, "trainer_ssl_itransformer.yaml", "patchtst.yaml")
        trainer, launches, wall, peak = drive_main(cfg_path, [
            "data.data_load=file", f"data.data_dir={tmp}", "data.data_file=ibl.pkl"], tmp)
        add_launches(total, launches)
        enc = trainer.model.config["encoder"]
        width = (enc["d_model"], enc["num_hidden_layers"], enc["num_attention_heads"],
                 enc["ffn_dim"], enc["norm_type"], enc["num_input_channels"],
                 enc["context_length"])
        if width != (256, 4, 8, 1024, "batchnorm", ibl["channels"], ibl["bins"]):
            raise AssertionError(f"mlm: not the config's widths or the pinned context: {width}")
        if any(launches.values()):
            raise AssertionError(f"mlm: CTC launches without a CTC head: {launches}")
        check_running_stats("PatchTST mlm", trainer)
        report_run("patchtst", f"mlm (trainer_ssl_itransformer.yaml with patchtst.yaml, B=16, "
                   f"{ibl['channels']} channels, T={ibl['bins']}, 10 patches)", trainer,
                   launches, wall, peak, power_line)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        mat = write_mat_dataset(os.path.join(tmp, "mat"))
        cfg_path = trainer_yaml(tmp, "trainer_ctc_ndt1.yaml", "patchtst.yaml")
        trainer, launches, wall, peak = drive_main(cfg_path, [
            f"data.data_dir={mat}", f"training.train_batch_size={PATCHTST_CTC_BATCH}",
            f"training.test_batch_size={PATCHTST_CTC_BATCH}"], tmp)
    add_launches(total, launches)
    enc = trainer.model.config["encoder"]
    if (enc["d_model"], enc["num_hidden_layers"], enc["context_length"]) != (256, 4, 520):
        raise AssertionError(f"ctc: widths or context {enc}")
    pl, ps = enc["patch_length"], enc["patch_stride"]
    check_ctc_run("PatchTST ctc", trainer, launches, 1 + (enc["context_length"] - pl) // ps)
    check_running_stats("PatchTST ctc", trainer)
    _, batch = report_run("patchtst", f"ctc (trainer_ctc_ndt1.yaml with patchtst.yaml, "
                          f"B={PATCHTST_CTC_BATCH}: {PATCHTST_CTC_BATCH * 256} sequences of 52 "
                          f"patches)", trainer, launches, wall, peak, power_line)
    ctc_head_check("patchtst", "PatchTST ctc head", trainer,
                   lambda b: torch.div(b["spikes_lengths"] - pl, ps, rounding_mode="floor") + 1,
                   "shared", power_line)
    if profile:
        profile_step(trainer, batch, power_line, profile, "patchtst", "PatchTST-CTC",
                     {"CTC kernels": ("ctc_",), "BatchNorm": ("batch_norm", "welford")})
    del trainer
    return total


def profile_step(trainer, batch, power_line: str, path: str, phase: str, label: str,
                 own: dict) -> None:
    """``torch.profiler`` over 3 steady train steps: device time by kernel,
    appended as a table to ``path``; ``own`` names the groups of kernels that
    are looked for before the common ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: the operator rows and the optimizer's annotation
    # repeat their kernels' device time
    from torch.autograd import DeviceType

    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and not ev.key.startswith("Optimizer.")]
    dev_us = lambda ev: getattr(ev, "self_device_time_total", None) or getattr(
        ev, "self_cuda_time_total", 0)
    total = sum(dev_us(ev) for ev in events)
    rows = sorted(((dev_us(ev), ev.count, ev.key) for ev in events if dev_us(ev) > 0),
                  reverse=True)
    groups = {**own, "GEMMs": ("nvjet", "gemm", "cutlass"),
              "copies and casts": ("copy", "Memcpy"), "LayerNorm": ("layer_norm",),
              "random draws": ("distribution", "philox", "rand"),
              "AdamW": ("multi_tensor", "adam")}
    other = "other (elementwise, reductions, softmax)"
    shares = dict.fromkeys([*groups, other], 0.0)
    for us, _, key in rows:
        name = next((g for g, pats in groups.items() if any(p in key for p in pats)), other)
        shares[name] += us
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(f"\ncard: {power_line}\n3 {label} train steps: wall {wall_ms:.1f} ms, device "
                f"busy {total / 1e3:.1f} ms ({total / 1e3 / wall_ms:.3f} of the wall time)\n")
        for name, us in shares.items():
            f.write(f"{us / 1e3 / 3:10.3f} ms/step {us / total:7.3%} {name}\n")
        for us, count, key in rows[:40]:
            f.write(f"{us / 1e3:10.3f} ms {us / total:7.3%} x{count:<5d} {key[:110]}\n")
    say(phase, f"profile of 3 {label} steps: wall {wall_ms:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms ({total / 1e3 / wall_ms:.3f}); table in "
        f"{os.path.relpath(path, REPO)}")
    for name, us in shares.items():
        say(phase, f"  {us / 1e3 / 3:9.3f} ms/step {us / total:7.3%} {name}")


KERNELS = {
    # name of the kernel that runs at the timed shape: (source, the TPU kernel
    # it replaces). Float32 and head sizes without a wgmma plan take other
    # kernels of the same sources (flash_fwd_kernel, flash_dq_kernel,
    # flash_dkv_kernel, int8_f32_kernel); no main path runs them.
    # the forward without a gradient (eval), and the one with it (a training
    # step: alpha and beta at once, the gradient written in the forward)
    "ctc_alpha_kernel": ("llm_bci_tpu_torch/csrc/ctc.cu", "llm_bci_tpu/ops/ctc_pallas.py:77"),
    "ctc_alpha_beta_kernel": ("llm_bci_tpu_torch/csrc/ctc.cu",
                              "llm_bci_tpu/ops/ctc_pallas.py:93"),
    FWD_WG: ("llm_bci_tpu_torch/csrc/flash_attention.cu", "llm_bci_tpu/ops/flash_attention.py:103"),
    DQ_WG: ("llm_bci_tpu_torch/csrc/flash_attention.cu", "llm_bci_tpu/ops/flash_attention.py:237"),
    DKV_WG: ("llm_bci_tpu_torch/csrc/flash_attention.cu",
             "llm_bci_tpu/ops/flash_attention.py:294"),
    # the expression that XLA fuses into one pass there
    "flash_delta_kernel": ("llm_bci_tpu_torch/csrc/flash_attention.cu",
                           "llm_bci_tpu/ops/flash_attention.py:367"),
    # one TPU kernel, two kernels of the port: M <= 64 (a decode step) and M >
    # 64 (prefill, fine-tune), timed at (K, N) = (4096, 11008)
    INT8_CLUSTER: ("llm_bci_tpu_torch/csrc/int8_matmul.cu", "llm_bci_tpu/ops/quant.py:127"),
    INT8_TILED: ("llm_bci_tpu_torch/csrc/int8_matmul.cu", "llm_bci_tpu/ops/quant.py:127"),
}


def main(only=None, profile=None) -> int:
    if not os.path.isdir(os.path.join(REPO, "llm_bci_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout (llm_bci_tpu_torch/ is missing)")
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    power_line = nvidia_smi_line()
    say("device", f"{kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {power_line}")

    from llm_bci_tpu_torch.ops import _build

    # One nvcc a source, all started together.
    def timed_build(name: str):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(timed_build, name)
                  for name in ("ctc", "flash_attention", "int8_matmul")]
        for future in builds:
            lib, secs = future.result()      # a failed build raises here
            say("build", f"{os.path.relpath(lib, REPO)} built in {secs:.1f} s")

    if profile:
        os.makedirs(os.path.dirname(os.path.abspath(profile)), exist_ok=True)
        open(os.path.abspath(profile), "w").close()     # the phases append their tables
    results: dict = {}
    launches: dict = {}
    if only in (None, "ctc"):
        kernel_phase(results)
    if only in (None, "flash"):
        flash_kernel_phase(results)
    if only in (None, "int8"):
        int8_kernel_phase(results, power_line)
    if only in (None, "ctc-main"):
        launches.update(main_path_phase(power_line, profile))
    if only in (None, "mlm-main"):
        launches.update(mlm_main_path_phase(power_line, profile))
    for phase, run in (("bci-serve", bci_serve_phase), ("bci-train", bci_train_phase),
                       ("cosmooth", cosmooth_phase),
                       ("phoneme-llm", lambda p, _: phoneme_llm_phase(p)),
                       ("eval-phonemes", lambda p, _: eval_phonemes_phase(p)),
                       ("itransformer", itransformer_phase), ("patchtst", patchtst_phase)):
        if only in (None, phase):
            add_launches(launches, run(power_line, profile))
            # a trainer holds reference cycles: free what the phase left, so
            # that the next phase's peak memory is its own
            gc.collect()
            torch.cuda.empty_cache()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if only is None or (name in results and name in launches):
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], **results[name],
            })
    print(power_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default=None,
                        choices=["ctc", "flash", "int8", "ctc-main", "mlm-main", "bci-serve",
                                 "bci-train", "cosmooth", "phoneme-llm", "eval-phonemes",
                                 "itransformer", "patchtst"])
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="write the torch.profiler tables of the CTC and mlm train steps, "
                             "the BCI greedy decode, the BCI fine-tune step, a folded "
                             "co-smoothing pass and the iTransformer and PatchTST ctc steps "
                             "to PATH")
    cli = parser.parse_args()
    sys.exit(main(cli.only, cli.profile))
