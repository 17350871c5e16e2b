"""Process start and the host-side collectives of multi-device training (the
port's ``jax.distributed.initialize`` and ``multihost_utils``).

A run with several ranks is started by a launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` for each
process, as ``torchrun --nproc-per-node N -m llm_bci_tpu_torch.main ...``
does, or by :func:`spawn`, which starts ``N`` such processes on this host.
:func:`init_process` joins the group: NCCL on ``cuda:LOCAL_RANK`` unless the
caller asks for the CPU, which takes gloo. There is no silent CPU run: a
CUDA device without a card raises. Every group gets an explicit timeout
(``DEFAULT_TIMEOUT_S``), so that a collective that hangs fails instead of
eating a time limit.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 300.0


def launcher_env() -> bool:
    """True when a launcher started this process as one rank of a group."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given, else
    ``cuda:LOCAL_RANK``; a CUDA device without a card raises."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' explicitly to run "
                           "the ranks on the CPU")
    return device


def init_process(device=None, backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group that the launcher's environment describes
    (nothing happens when one is up already) and return this rank's device.
    ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU."""
    import torch.distributed as dist

    device = rank_device(device)
    if dist.is_initialized():
        return device
    if not launcher_env():
        raise RuntimeError("init_process: no RANK / WORLD_SIZE in the environment; start the "
                           "ranks with torchrun or llm_bci_tpu_torch.parallel.process.spawn")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=device if backend == "nccl" else None,
    )
    return device


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv: Sequence[str], n: int, env: Optional[dict] = None, timeout_s: float = 600.0,
          cwd: Optional[str] = None) -> List[subprocess.CompletedProcess]:
    """Run ``python <argv>`` as ``n`` ranks of one group on this host (a free
    port, the launcher variables set) and wait for all of them; raises
    ``RuntimeError`` with each failed rank's output when any rank exits with
    another code than 0 (one killed at ``timeout_s`` among them). Every
    process is ended before this returns."""
    port = free_port()
    procs, logs = [], []
    results, failed = [], []
    try:
        for rank in range(n):
            launcher = {"RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_RANK": str(rank),
                        "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": "localhost",
                        "MASTER_PORT": str(port)}
            # a file, not a pipe: a rank blocked on a full pipe would hold
            # up the collectives of the others
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen([sys.executable, *argv], cwd=cwd,
                                          env={**os.environ, **(env or {}), **launcher},
                                          stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            logs[rank].seek(0)
            out = logs[rank].read()
            results.append(subprocess.CompletedProcess(p.args, p.returncode, out, None))
            if p.returncode != 0:
                failed.append(f"rank {rank} exited with {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed:
        raise RuntimeError("spawn: " + "\n".join(failed))
    return results


def all_gather_host(value, group=None) -> List:
    """Every rank's ``value`` (a numpy array or a number), in rank order, on
    every rank: the counterpart of ``multihost_utils.process_allgather``.
    Travels as a CPU tensor over gloo and as a tensor on this rank's card
    over NCCL."""
    import torch.distributed as dist

    arr = np.asarray(value)
    t = torch.as_tensor(np.ascontiguousarray(arr))
    if dist.get_backend(group) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, t, group=group)
    return [o.cpu().numpy().reshape(arr.shape) for o in outs]


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when ``flag`` is true on any rank."""
    return bool(np.any(all_gather_host(np.asarray(bool(flag), np.int32), group)))
