#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``llm_bci_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one line each; any failure raises and the exit code is non-zero:

1. the card: ``torch.cuda.is_available()``, its name and power limit;
2. build the CUDA kernels from ``llm_bci_tpu_torch/csrc`` (seconds);
3. kernels: the CTC forward and backward kernels against the plain PyTorch
   version on the card at the NDT1-CTC flagship shapes (B=64, T'=121,
   V=41, S=64, partial input lengths, an empty and an infeasible target,
   repeated labels) on float32 log-probs: loss rtol 1e-4 and gradient atol
   1e-4 against the plain version run in float64 (the kernels recurse in
   double; the plain version's own float32 error over 121 sequential
   log-sum-exps is printed beside it); torch's native CTC through the
   logits as an independent oracle; kernel and float32 plain times from
   CUDA events after warm-up;
4. main path: synthetic competition-format ``.mat`` files (64 train and
   64 test trials, 256 channels, 480-512 bins, real sentences for the G2P
   phoneme targets) through ``llm_bci_tpu_torch.main`` with
   ``configs/trainer_ctc_ndt1.yaml`` at full width (5 x 1024, bf16
   autocast): 4 training steps and one eval with the CER metric. The
   launch counters must show the CTC kernels ran; the model's loss on a
   test batch must agree with the plain CTC on the same log-probs.

The second-to-last line is a JSON object with the kernels' launches,
errors and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

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
    say("kernels", f"CTC forward: kernel {k_fwd:.4f} ms, plain {p_fwd:.4f} ms; "
        f"backward: kernel {k_bwd:.4f} ms, plain {p_bwd:.4f} ms")
    results["ctc_alpha_kernel"] = dict(max_abs_err=fwd_err, ms=k_fwd, plain_ms=p_fwd)
    results["ctc_beta_kernel"] = dict(max_abs_err=bwd_err, ms=k_bwd, plain_ms=p_bwd)


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


def main() -> int:
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

    t0 = time.perf_counter()
    lib = _build.build("ctc")
    say("build", f"{os.path.relpath(lib, REPO)} built in {time.perf_counter() - t0:.1f} s")

    results: dict = {}
    kernel_phase(results)
    launches = main_path_phase(power_line)

    kernels = []
    replaces = {"ctc_alpha_kernel": "llm_bci_tpu/ops/ctc_pallas.py:77",
                "ctc_beta_kernel": "llm_bci_tpu/ops/ctc_pallas.py:93"}
    for name in ("ctc_alpha_kernel", "ctc_beta_kernel"):
        kernels.append({
            "name": name, "route": "cuda", "source": "llm_bci_tpu_torch/csrc/ctc.cu",
            "replaces": replaces[name], "launches": launches[name], **results[name],
        })
    print(power_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
