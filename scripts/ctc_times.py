#!/usr/bin/env python3
"""Device time of the port's CTC kernels at the NDT1-CTC flagship shape, for
one tree of this repository, on one NVIDIA GPU.

    python3 scripts/ctc_times.py [--tree DIR] [--label NAME] [--ptxas]

``llm_bci_tpu_torch`` is imported from ``DIR`` (default: this checkout), so
that the kernels of two trees (another commit unpacked with ``git archive``
into the git-ignored ``_checkout/``) can be timed in turns on one machine:
run it for each tree in the order A, B, B, A and compare within the run. The
kernels are built from ``DIR``'s sources at the first call.

At B=64, T'=121, V=41, S=64 (``chip_smoke.ctc_case``): the forward without a
gradient, and the pair that a training step runs (the forward with the
gradient, then the backward), as device time from CUDA graphs of 20 calls on
preallocated outputs (``chip_smoke.graph_ms``), in ms and in us a frame; the
same through autograd one call at a time (CUDA events, the host's enqueue
included); ``torch.nn.functional.ctc_loss`` (eager) and the byte bound beside
them. A tree with ``ctc_plan`` times ``ctc_alpha_kernel`` and
``ctc_alpha_beta_kernel`` (with the backward's multiply); an older tree its
``ctc_alpha_kernel`` (the forward; with the alpha lattice for the pair) and
``ctc_beta_kernel``. ``--ptxas`` also prints what ``nvcc -Xptxas -v`` says of
the tree's ``csrc/ctc.cu`` (registers, spills, shared memory a kernel).

Prints the card's name and power limit, then one JSON object.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` (timing helpers and shapes; it
    imports nothing of the port at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ptxas_lines(tree: str, nvcc: str) -> list:
    """``nvcc -Xptxas -v`` of the tree's ``csrc/ctc.cu``: a line a kernel."""
    src = os.path.join(tree, "llm_bci_tpu_torch", "csrc", "ctc.cu")
    out = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                          "-Xptxas", "-v", "-c", "-o", os.devnull, src],
                         capture_output=True, text=True, timeout=300, check=True)
    lines, kernel = [], None
    for raw in out.stderr.splitlines():
        if "Compiling entry function" in raw:
            kernel = raw.split("'")[1]
        elif kernel and ("registers" in raw or "spill" in raw):
            lines.append(f"{kernel}: {raw.split(' : ', 1)[-1].strip()}")
    return lines


def older_tree_times(cs, ctc_cuda, lp, targets, il, tl) -> dict:
    """Graph-timed device times of a tree whose forward kernel is
    ``ctc_alpha_kernel`` and whose backward is ``ctc_beta_kernel``."""
    import torch

    lib = ctc_cuda._lib()
    B, T, V = lp.shape
    S = targets.shape[1]
    dev = lp.device
    loss = torch.empty(B, device=dev)
    log_p = torch.empty(B, device=dev, dtype=torch.float64)
    alpha = torch.empty((B, T, 2 * S + 1), device=dev, dtype=torch.float64)
    g = torch.ones(B, device=dev)
    grad = torch.empty_like(lp)
    ptr = lambda t: t.data_ptr() if t is not None else None
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def fwd(lattice):
        rc = lib.ctc_alpha_launch(lp.data_ptr(), targets.data_ptr(), il.data_ptr(), tl.data_ptr(),
                                  B, T, V, S, 0, 1, ptr(lattice), loss.data_ptr(),
                                  log_p.data_ptr(), stream())
        assert rc == 0, rc

    def bwd():
        rc = lib.ctc_beta_launch(lp.data_ptr(), targets.data_ptr(), il.data_ptr(), tl.data_ptr(),
                                 alpha.data_ptr(), log_p.data_ptr(), g.data_ptr(), B, T, V, S, 0,
                                 grad.data_ptr(), stream())
        assert rc == 0, rc

    return {"fwd_ms": cs.graph_ms(lambda: fwd(None), 20),
            "fwd_grad_ms": cs.graph_ms(lambda: fwd(alpha), 20),
            "bwd_ms": cs.graph_ms(bwd, 20),
            "pair_ms": cs.graph_ms(lambda: (fwd(alpha), bwd()), 20)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=REPO, help="root of the tree whose port is timed")
    parser.add_argument("--label", default=None, help="name of the tree in the output")
    parser.add_argument("--ptxas", action="store_true",
                        help="also print nvcc -Xptxas -v of the tree's csrc/ctc.cu")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ctc_times: no CUDA device")
    cs = _chip_smoke()
    from llm_bci_tpu_torch.ops import _build, ctc_cuda

    if not os.path.abspath(ctc_cuda.__file__).startswith(tree + os.sep):
        raise SystemExit(f"ctc_times: imported {ctc_cuda.__file__}, not from {tree}")
    power_line = cs.nvidia_smi_line()
    print(f"card: {power_line}", flush=True)
    dev = torch.device("cuda")
    logits, targets, il, tl = cs.ctc_case(dev)
    lp = torch.log_softmax(logits, -1).detach().contiguous()
    targets, il, tl = targets.int(), il.int(), tl.int()
    B, T, V = lp.shape
    S = targets.shape[1]

    with torch.no_grad():   # one check against the plain version (float64) first
        from llm_bci_tpu_torch.ops.ctc import ctc_loss_plain
        got = ctc_cuda.ctc_loss_cuda(lp, targets, il, tl)
        ref = ctc_loss_plain(lp.double(), targets, il, tl).float()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    if hasattr(ctc_cuda, "ctc_plan"):
        cell = cs.ctc_times(lp, targets, il, tl)
    else:
        cell = older_tree_times(cs, ctc_cuda, lp, targets, il, tl)
    cell.update(cs.ctc_eager_times(lp, targets, il, tl, with_plain=False))
    # the pair's bytes: the log-probs, labels and lengths read once, the loss
    # and the (B, T, V) gradient written once
    in_bytes = B * T * V * 4 + B * S * 4 + 2 * B * 4
    b = cs.bound(20 * B * T * (2 * S + 1), in_bytes + B * 4 + B * T * V * 4, "float32")
    cell.update({"tree": args.label or tree, "B": B, "T": T, "V": V, "S": S,
                 "pair_bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                 "fwd_us_a_frame": cell["fwd_ms"] * 1e3 / T,
                 "pair_us_a_frame": cell["pair_ms"] * 1e3 / T, "card": power_line})
    if args.ptxas:
        cell["ptxas"] = ptxas_lines(tree, _build.find_nvcc())
    print(json.dumps(cell), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
