"""One run of one cell: the cell's driver builds the program, times it over a
window and checks what it produced against the plain reference; the harness
reads the metrics and prints the result line.

Everything that belongs to a cell is data or code found by its name:
``BENCHMARK.json`` names the cell's configuration and traffic,
``configs/<config>.json`` holds the configuration as it is run (its model's
reference is ``reference/<model_class>.py``), ``traffic/<traffic>.json``
the traffic's parameters and, under ``run.driver``, the driver
(``drivers/<driver>.py``: ``run(spec, seed, seconds, trace, device,
started, controls)``), ``limits/<cell>.json`` the limits of the compared
numbers. Each end-to-end metric is read by ``end_to_end/<metric>.py`` and
each per-layer metric by ``metrics/<metric>.py``: its ``read(ctx)`` takes
what the driver handed over (``e2e`` or ``layer``) and returns a number, or
None where it finds nothing to read (the metric is then left out).
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "llm_bci_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_spec(cell: str) -> dict:
    """The cell's entry in ``BENCHMARK.json`` with its configuration,
    traffic and limits, and the metrics that it reports."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    reports = lambda m: cell in m.get("workloads", [cell])    # noqa: E731
    return {
        "entry": entry,
        "config": load_json(os.path.join(BENCH_DIR, "configs", f"{entry['config']}.json")),
        "traffic": load_json(os.path.join(BENCH_DIR, "traffic", f"{entry['traffic']}.json")),
        "limits": load_json(os.path.join(BENCH_DIR, "limits", f"{cell}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def loaded_forbidden() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, loaded by its path."""
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(folder: str, name: str, ctx):
    """``(value, error)`` of ``<folder>/<name>.py``'s reader."""
    try:
        return load_module(folder, name).read(ctx), None
    except Exception as err:   # a failed reader keeps its key, with the error
        return None, f"{type(err).__name__}: {err}"


def read_metrics(folder: str, specs: Sequence[dict], ctx) -> Dict[str, dict]:
    """Each metric's reading: left out where its reader found nothing;
    where the reader failed, kept with no value and the error."""
    out = {}
    for m in specs:
        value, error = read_metric(folder, m["name"], ctx)
        if value is not None or error is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
            if error is not None:
                out[m["name"]]["error"] = error
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """Every number within its limit, and a limit for every number; a number
    whose limit is null is read and printed, and not compared (the reason is
    in PERF.md)."""
    return bool(numbers) and all(k in limits and (limits[k] is None or numbers[k] <= limits[k])
                                 for k in numbers)


def run(cell: str, seed: int, seconds: float, trace: bool, *, device: Optional[str] = None,
        started: Optional[float] = None, shrink=None, controls: Sequence[dict] = (),
        log=sys.stderr) -> dict:
    """One run; returns the result dict (its last key ``checks``).
    ``shrink(config, traffic)`` edits the loaded files (debug sizes in the
    tests); ``controls`` go to the driver (the reference in the program's
    place, at another precision or with a fault), and their numbers to
    ``result["controls"]``."""
    import torch

    started = time.perf_counter() if started is None else started
    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    spec = cell_spec(cell)
    if shrink is not None:
        shrink(spec["config"], spec["traffic"])
    limits = spec["limits"]
    driver = load_module("drivers", spec["traffic"]["run"]["driver"])
    out = driver.run(spec, seed, seconds, trace, torch.device(device or "cuda"), started,
                     controls)

    result = {"correct": verdict(out.numbers, limits) and out.failed == 0, "attempted": out.attempted,
              "failed": out.failed}
    if trace:
        result["metrics"] = read_metrics("metrics", spec["per_layer"], out.layer)
    else:
        result["metrics"] = read_metrics("end_to_end", spec["end_to_end"], out.e2e)
    result["device"] = dict(out.device, count=int(spec["entry"]["chips"]))
    if trace:
        result["breakdown"] = out.breakdown
    result["details"] = out.details
    if controls:
        result["controls"] = out.controls
    result["forbidden_modules"] = loaded_forbidden()
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in out.numbers.items()}
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
    return result
