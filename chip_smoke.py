#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``llm_bci_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, a few lines each; any failure raises and the exit code is non-zero:

1. the card: ``torch.cuda.is_available()``, its name and power limit;
2. build the CUDA kernels from ``llm_bci_tpu_torch/csrc``, one ``nvcc`` a
   source, all started together;
3. kernels: the CTC forward and backward kernels against the plain PyTorch
   version on the card at the NDT1-CTC flagship shapes (B=64, T'=121,
   V=41, S=64, partial input lengths, an empty and an infeasible target,
   repeated labels) on float32 log-probs: loss rtol 1e-4 and gradient atol
   1e-4 against the plain version run in float64 (the kernels recurse in
   double; the plain version's own float32 error over 121 sequential
   log-sum-exps is printed beside it); torch's native CTC through the
   logits as an independent oracle; kernel and float32 plain times from
   CUDA events after warm-up, and ``torch.nn.functional.ctc_loss`` timed
   beside them (``library_ms``; the port never calls it);
4. kernels: the banded flash-attention forward, dQ and dK/dV kernels
   against the plain version on the card, in float32 (out atol 5e-5,
   gradients atol 2e-4 + rtol 2e-4: float32 sums in another order) and in
   bf16 against the float32 plain version of the same bf16 inputs (out atol
   2e-2, gradients atol 3e-2 + rtol 3e-2: p and ds are rounded to bf16
   before their products), over an unbounded band, narrow bands, a causal
   band, right and left key padding, rows with no visible key (exactly 0,
   gradients 0), a ragged T with small D, and dropout 0.4 from a fixed seed
   (same keep mask as the plain version, kept fraction, same bits twice);
   then the NDT1-mlm shape (B=32, H=8, T=1024, D=128, bf16, dropout 0.4)
   with times from CUDA events, the bound of each kernel, and
   ``scaled_dot_product_attention`` timed beside them at T=1024 and T=128;
5. main path (NDT1-CTC): synthetic competition-format ``.mat`` files (64 train and
   64 test trials, 256 channels, 480-512 bins, real sentences for the G2P
   phoneme targets) through ``llm_bci_tpu_torch.main`` with
   ``configs/trainer_ctc_ndt1.yaml`` at full width (5 x 1024, bf16
   autocast): 4 training steps and one eval with the CER metric. The
   launch counters must show the CTC kernels ran; the model's loss on a
   test batch must agree with the plain CTC on the same log-probs;
6. main path (NDT1-mlm): synthetic Poisson spikes (rate 1.0, 64 train and
   32 val trials of 896-1024 bins x 256 channels) in a pickle through
   ``llm_bci_tpu_torch.main`` with ``configs/trainer_ssl_ndt1.yaml`` at full
   width and depth (5 x 1024, 8 heads, D=128, B=32, T=1024, bf16 autocast,
   ``random`` masker ratio 0.3, left padding, ``flash_attention: auto``):
   4 training steps and one eval. The launch counters must show 5 forward
   launches a model call and 5 of each backward kernel a training step.

``--only ctc|flash|ctc-main|mlm-main`` runs one phase (for development);
``--profile PATH`` adds a ``torch.profiler`` table of the mlm train step,
written to ``PATH``.

The second-to-last line is a JSON object with the kernels' launches,
errors and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
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


# Published dense peaks of one H100 SXM: operations a second by input type,
# and bytes a second of device memory.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound(ops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def ctc_case(device):
    """Flagship-shaped CTC inputs with the edge cases in the batch."""
    import torch

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(B, T, V)).astype(np.float32) * 2.0
    targets = rng.integers(1, V, size=(B, S)).astype(np.int64)
    il = rng.integers(90, T + 1, size=B).astype(np.int64)
    il[0] = T
    tl = rng.integers(20, S + 1, size=B).astype(np.int64)
    tl[1] = 0                                  # empty target
    il[2], tl[2] = 40, S                       # infeasible: 64 labels in 40 frames
    targets[3, :12] = [5, 5, 5, 7, 7, 9, 9, 9, 9, 2, 2, 5]   # repeated labels
    tl[3] = 12
    targets[4] = 6                             # all one label, 30 repeats
    tl[4] = 30
    t = lambda a: torch.from_numpy(a).to(device)
    return t(logits), t(targets), t(il), t(tl)


def kernel_phase(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain

    dev = torch.device("cuda")
    logits, targets, il, tl = ctc_case(dev)
    lp = torch.log_softmax(logits, -1).detach()

    def kernel_fb():
        x = lp.clone().requires_grad_(True)
        loss = ctc_cuda.ctc_loss_cuda(x, targets, il, tl)
        (g,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), g

    def plain_fb(dtype):
        x = lp.to(dtype).requires_grad_(True)
        loss = ctc_loss_plain(x, targets, il, tl)
        (g,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach().float(), g.float()

    k_loss, k_grad = kernel_fb()
    p_loss, p_grad = plain_fb(torch.float64)     # the reference
    f_loss, f_grad = plain_fb(torch.float32)     # for scale: float32's own error
    torch.cuda.synchronize()
    if not (torch.isfinite(k_loss).all() and torch.isfinite(k_grad).all()):
        raise AssertionError("CTC kernel produced non-finite values")
    if k_loss[2].item() != 0.0 or k_grad[2].abs().max().item() != 0.0:
        raise AssertionError("infeasible target: expected zero loss and zero gradient")
    fwd_err = (k_loss - p_loss).abs().max().item()
    bwd_err = (k_grad - p_grad).abs().max().item()
    say("kernels", f"CTC at B={B} T={T} V={V} S={S}, against the plain version in float64: "
        f"kernel loss max|err|={fwd_err:.3e} grad max|err|={bwd_err:.3e}; plain float32 "
        f"loss max|err|={(f_loss - p_loss).abs().max().item():.3e} "
        f"grad max|err|={(f_grad - p_grad).abs().max().item():.3e}")
    torch.testing.assert_close(k_loss, p_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k_grad, p_grad, rtol=0.0, atol=1e-4)

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
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0.0, atol=1e-4)
    say("kernels", "CTC kernel vs torch native CTC in float64 (through the logits): agree, "
        f"grad max|err|={(grads[0][1] - grads[1][1]).abs().max().item():.3e}")

    # Times: forward alone, and backward alone on a retained graph.
    x = lp.clone().requires_grad_(True)
    k_fwd = cuda_ms(lambda: ctc_cuda.ctc_loss_cuda(x, targets, il, tl), 50)
    p_fwd = cuda_ms(lambda: ctc_loss_plain(x, targets, il, tl), 5)
    k_out = ctc_cuda.ctc_loss_cuda(x, targets, il, tl).sum()
    p_out = ctc_loss_plain(x, targets, il, tl).sum()
    k_bwd = cuda_ms(lambda: torch.autograd.grad(k_out, x, retain_graph=True), 50)
    p_bwd = cuda_ms(lambda: torch.autograd.grad(p_out, x, retain_graph=True), 5)
    # torch's own CTC on the same float32 log-probs: timed only.
    xt = lp.transpose(0, 1).contiguous().requires_grad_(True)
    lib_loss = lambda: F.ctc_loss(xt, targets, il, tl, reduction="none", zero_infinity=True)
    l_fwd = cuda_ms(lib_loss, 50)
    l_out = lib_loss().sum()
    l_bwd = cuda_ms(lambda: torch.autograd.grad(l_out, xt, retain_graph=True), 50)
    say("kernels", f"CTC forward: kernel {k_fwd:.4f} ms, plain {p_fwd:.4f} ms, "
        f"F.ctc_loss {l_fwd:.4f} ms; backward: kernel {k_bwd:.4f} ms, plain {p_bwd:.4f} ms, "
        f"F.ctc_loss {l_bwd:.4f} ms")
    # Bounds: the (B, T, V) float32 log-probs read once, int32 labels and
    # lengths, the loss (forward) or the gradient (backward) written once;
    # about 10 float operations a lattice slot (three-way log-sum-exp).
    slots = B * T * (2 * S + 1)
    in_bytes = B * T * V * 4 + B * S * 4 + 2 * B * 4
    fwd_bound = bound(10 * slots, in_bytes + B * 4, "float32")
    bwd_bound = bound(10 * slots, in_bytes + B * 4 + B * T * V * 4, "float32")
    results["ctc_alpha_kernel"] = dict(max_abs_err=fwd_err, ms=k_fwd, plain_ms=p_fwd,
                                       library_ms=l_fwd, **fwd_bound)
    results["ctc_beta_kernel"] = dict(max_abs_err=bwd_err, ms=k_bwd, plain_ms=p_bwd,
                                      library_ms=l_bwd, **bwd_bound)


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
    worst = {"fwd": max(worst["fwd"], errs[0]), "dq": max(worst["dq"], errs[1]),
             "dkv": max(worst["dkv"], errs[2], errs[3])}
    say("kernels", f"flash bfloat16 B={B} H={H} T={T} D={D} dropout {drop}, left padding: "
        f"max|err| out {errs[0]:.2e} dq {errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e}")
    del got, ref

    def timings(B, T, H, D, valid, drop, seed):
        """Kernel, plain and SDPA times at one bf16 shape."""
        q, k, v, w, _ = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        seed_t = torch.tensor([seed], dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(D)
        args = (q, k, v, valid, seed_t, T, T, scale, drop)
        t = {}
        with torch.no_grad():
            t["fwd"] = cuda_ms(lambda: fc.FlashAttentionFunction.apply(*args), 20)
            out = fc.FlashAttentionFunction.apply(*args)
        # the backward kernels alone, on the tensors the backward would get
        meta = fc.kernel_meta(q, T, T, scale, drop)
        with torch.no_grad():
            _, lse = fc.flash_fwd(q, k, v, valid, seed_t, meta)
            delta = (w.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            back = (q, k, v, valid, seed_t, w, lse, delta, meta)
            t["dq"] = cuda_ms(lambda: fc.flash_dq(*back), 20)
            t["dkv"] = cuda_ms(lambda: fc.flash_dkv(*back), 20)
        p_out = fa.banded_flash_attention_plain(q, k, v, valid, None, None, drop, seed_t)
        with torch.no_grad():
            t["plain_fwd"] = cuda_ms(lambda: fa.banded_flash_attention_plain(
                q, k, v, valid, None, None, drop, seed_t), 3)
        t["plain_dq"] = cuda_ms(lambda: torch.autograd.grad(p_out, q, w, retain_graph=True), 3)
        t["plain_dkv"] = cuda_ms(
            lambda: torch.autograd.grad(p_out, (k, v), w, retain_graph=True), 3)
        del p_out
        # one library call: SDPA on (B, H, T, D) with a boolean mask of the
        # same padding (the band is unbounded) and the same dropout rate
        qh, kh, vh, wh = (x.detach().transpose(1, 2).contiguous() for x in (q, k, v, w))
        qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
        mask = (valid != 0)[:, None, None, :].expand(B, 1, T, T)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=drop)
        with torch.no_grad():
            t["sdpa_fwd"] = cuda_ms(sdpa, 20)
        s_out = sdpa()
        t["sdpa_dq"] = cuda_ms(lambda: torch.autograd.grad(s_out, qh, wh, retain_graph=True), 20)
        t["sdpa_dkv"] = cuda_ms(
            lambda: torch.autograd.grad(s_out, (kh, vh), wh, retain_graph=True), 20)
        return t

    t = timings(B, T, H, D, valid, drop, seed)
    # Bounds from this run's data: a (query, key) pair counts when the key is
    # valid (the band is unbounded); 2*D operations a pair and product.
    pairs = float(T * valid.sum().item() * H)
    e = 2                                                    # bytes of a bf16
    qkv = B * T * H * D * e
    small = B * H * T * 4
    bounds = {
        "fwd": bound(2 * 2 * D * pairs, 4 * qkv + small + B * T * 4, "bfloat16"),
        # dQ needs s, dp and ds.K; dK/dV needs s, dp, p^T.dO and ds^T.Q
        "dq": bound(3 * 2 * D * pairs, 5 * qkv + 2 * small + B * T * 4, "bfloat16"),
        "dkv": bound(4 * 2 * D * pairs, 6 * qkv + 2 * small + B * T * 4, "bfloat16"),
    }
    for key, label in (("fwd", "flash_fwd_kernel"), ("dq", "flash_dq_kernel"),
                       ("dkv", "flash_dkv_kernel")):
        results[label] = dict(max_abs_err=worst[key], ms=t[key], plain_ms=t[f"plain_{key}"],
                              library_ms=t[f"sdpa_{key}"], **bounds[key])
        say("kernels", f"{label} at B={B} H={H} T={T} D={D} bf16 dropout {drop}: "
            f"{t[key]:.3f} ms, bound {bounds[key]['bound_ms']:.3f} ms "
            f"({bounds[key]['bound_by']}), plain {t['plain_' + key]:.3f} ms, "
            f"SDPA {t['sdpa_' + key]:.3f} ms")
    q0, k0, v0, _, _ = flash_inputs(B, T, H, D, "none", torch.bfloat16, dev, seed=1)
    with torch.no_grad():
        no_drop = cuda_ms(lambda: fc.FlashAttentionFunction.apply(
            q0, k0, v0, valid, None, T, T, 1.0 / math.sqrt(D), 0.0), 20)
    say("kernels", f"flash_fwd_kernel without dropout: {no_drop:.3f} ms "
        f"(the keep mask costs {t['fwd'] - no_drop:.3f} ms)")
    k_all = t["fwd"] + t["dq"] + t["dkv"]
    s_all = t["sdpa_fwd"] + t["sdpa_dq"]        # SDPA's backward gives all three at once
    say("kernels", f"flash vs SDPA at T={T}: forward {t['fwd'] / t['sdpa_fwd']:.2f}x its time, "
        f"forward+backward {k_all:.3f} ms vs {s_all:.3f} ms ({k_all / s_all:.2f}x)")

    # The short length of the stacked CTC path, for the auto threshold.
    Bs, Ts = 64, 128
    valid_s = torch.ones((Bs, Ts), dtype=torch.int32, device=dev)
    ts = timings(Bs, Ts, H, D, valid_s, drop, seed)
    k_all = ts["fwd"] + ts["dq"] + ts["dkv"]
    s_all = ts["sdpa_fwd"] + ts["sdpa_dq"]
    say("kernels", f"flash vs SDPA at B={Bs} T={Ts}: forward {ts['fwd']:.3f} ms vs "
        f"{ts['sdpa_fwd']:.3f} ms ({ts['fwd'] / ts['sdpa_fwd']:.2f}x), forward+backward "
        f"{k_all:.3f} ms vs {s_all:.3f} ms ({k_all / s_all:.2f}x); plain forward "
        f"{ts['plain_fwd']:.3f} ms, plain backward {ts['plain_dq'] + ts['plain_dkv']:.3f} ms")


def main_path_phase(power_line: str) -> dict:
    import torch
    from llm_bci_tpu_torch import main as port_main
    from llm_bci_tpu_torch.ops import ctc_cuda
    from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain
    from llm_bci_tpu_torch.models.ndt1 import stacked_lengths

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        write_mat_dataset(os.path.join(tmp, "mat"))
        say("main", f"synthetic speechbci files written in {time.perf_counter() - t0:.1f} s")
        args = port_main.parse_args([
            "-c", os.path.join(REPO, "configs", "trainer_ctc_ndt1.yaml"),
            "-k", f"data.data_dir={os.path.join(tmp, 'mat')}",
            "training.max_steps=4", "training.eval_every=4", "training.save_every=null",
            f"dirs.checkpoint_dir={os.path.join(tmp, 'ckpt')}", "dirs.log_dir=null",
            "verbosity=1",
        ])
        torch.cuda.reset_peak_memory_stats()
        ctc_cuda.reset_counters()
        t0 = time.perf_counter()
        trainer = port_main.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ctc_alpha_kernel": ctc_cuda.FWD_LAUNCHES,
                    "ctc_beta_kernel": ctc_cuda.BWD_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()

    hist = trainer.eval_history
    if len(hist) != 1 or hist[0]["step"] != 4:
        raise AssertionError(f"expected one eval at step 4, got {hist}")
    h = hist[0]
    for key in ("train_avg_loss", "test_avg_loss"):
        if not np.isfinite(h[key]):
            raise AssertionError(f"{key} is not finite: {h[key]}")
    cer = h["test_avg_metrics"].get("CER")
    if cer is None or not 0.0 <= cer <= 2.0:
        raise AssertionError(f"eval CER missing or out of range: {cer}")
    if launches["ctc_alpha_kernel"] < 5 or launches["ctc_beta_kernel"] < 4:
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
    batch = trainer.to_device(next(iter(trainer.train_dataloader))[0])
    n = int(batch["spikes"].shape[0])
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    say("main", f"full-width train step (B={n}, 5x1024, bf16 autocast): "
        f"{1.0 / step_s:.3f} steps/s, {n / step_s:.1f} samples/s, "
        f"{step_s * 1e3:.2f} ms/step; peak memory of the main run "
        f"{peak / 2**30:.3f} GiB; card {power_line}")
    return launches


def write_spike_pickle(path: str, n_train: int = 64, n_val: int = 32, bins=(896, 1024),
                       channels: int = 256, seed: int = 0) -> str:
    """Synthetic Poisson spikes (rate 1.0) as ``{split: [{"spikes": (T, N)
    float32}]}``; the first trial of each split has the longest length."""
    import pickle

    rng = np.random.default_rng(seed)
    data = {}
    for split, n in (("train", n_train), ("val", n_val)):
        lengths = rng.integers(bins[0], bins[1] + 1, size=n)
        lengths[0] = bins[1]
        data[split] = [{"spikes": rng.poisson(1.0, size=(int(t), channels)).astype(np.float32)}
                       for t in lengths]
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
        launches = {"flash_fwd_kernel": fc.FWD_LAUNCHES, "flash_dq_kernel": fc.BWD_DQ_LAUNCHES,
                    "flash_dkv_kernel": fc.BWD_DKV_LAUNCHES}
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
    want = {"flash_fwd_kernel": n_layers * (steps + eval_batches),
            "flash_dq_kernel": n_layers * steps, "flash_dkv_kernel": n_layers * steps}
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
        profile_step(trainer, batch, power_line, profile)
    return launches


def profile_step(trainer, batch, power_line: str, path: str) -> None:
    """``torch.profiler`` over 3 steady train steps: device time by kernel,
    as a table in ``path``."""
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
    groups = {"flash attention kernels": ("flash_",), "GEMMs": ("nvjet", "gemm", "cutlass"),
              "copies and casts": ("copy", "Memcpy"), "LayerNorm": ("layer_norm",),
              "random draws": ("distribution", "philox", "rand"),
              "AdamW": ("multi_tensor", "adam")}
    shares = dict.fromkeys([*groups, "other (elementwise, reductions, softmax)"], 0.0)
    for us, _, key in rows:
        name = next((g for g, pats in groups.items() if any(p in key for p in pats)),
                    "other (elementwise, reductions, softmax)")
        shares[name] += us
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"card: {power_line}\n3 mlm train steps: wall {wall_ms:.1f} ms, device busy "
                f"{total / 1e3:.1f} ms ({total / 1e3 / wall_ms:.3f} of the wall time)\n")
        for name, us in shares.items():
            f.write(f"{us / 1e3 / 3:10.3f} ms/step {us / total:7.3%} {name}\n")
        for us, count, key in rows[:40]:
            f.write(f"{us / 1e3:10.3f} ms {us / total:7.3%} x{count:<5d} {key[:110]}\n")
    say("mlm", f"profile of 3 steps: wall {wall_ms:.1f} ms, device busy {total / 1e3:.1f} ms "
        f"({total / 1e3 / wall_ms:.3f}); table in {os.path.relpath(path, REPO)}")
    for name, us in shares.items():
        say("mlm", f"  {us / 1e3 / 3:9.3f} ms/step {us / total:7.3%} {name}")


KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "ctc_alpha_kernel": ("llm_bci_tpu_torch/csrc/ctc.cu", "llm_bci_tpu/ops/ctc_pallas.py:77"),
    "ctc_beta_kernel": ("llm_bci_tpu_torch/csrc/ctc.cu", "llm_bci_tpu/ops/ctc_pallas.py:93"),
    "flash_fwd_kernel": ("llm_bci_tpu_torch/csrc/flash_attention.cu",
                         "llm_bci_tpu/ops/flash_attention.py:103"),
    "flash_dq_kernel": ("llm_bci_tpu_torch/csrc/flash_attention.cu",
                        "llm_bci_tpu/ops/flash_attention.py:237"),
    "flash_dkv_kernel": ("llm_bci_tpu_torch/csrc/flash_attention.cu",
                         "llm_bci_tpu/ops/flash_attention.py:294"),
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

    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = [pool.submit(timed_build, name) for name in ("ctc", "flash_attention")]
        for future in builds:
            lib, secs = future.result()      # a failed build raises here
            say("build", f"{os.path.relpath(lib, REPO)} built in {secs:.1f} s")

    results: dict = {}
    launches: dict = {}
    if only in (None, "ctc"):
        kernel_phase(results)
    if only in (None, "flash"):
        flash_kernel_phase(results)
    if only in (None, "ctc-main"):
        launches.update(main_path_phase(power_line))
    if only in (None, "mlm-main"):
        launches.update(mlm_main_path_phase(power_line, profile))

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
    parser.add_argument("--only", choices=["ctc", "flash", "ctc-main", "mlm-main"], default=None)
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="write a torch.profiler table of the mlm train step to PATH")
    cli = parser.parse_args()
    sys.exit(main(cli.only, cli.profile))
