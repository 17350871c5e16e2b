"""The port's benchmark: one run of one cell on the card.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds the port (``llm_bci_tpu_torch``).
Prints each compared number beside its limit as the last lines of standard
error, and the result as the last line of standard output: one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` when traced), then ``checks``. Exits non-zero, printing no
result, without a card (or fewer cards than the cell asks for), or when JAX
or the JAX package is loaded once the window has closed.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, ".cache")

# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
    os.makedirs(os.environ[var], exist_ok=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, BENCH_DIR)
    sys.path.insert(0, ROOT)
    import harness

    chips = int(harness.cell_spec(args.workload)["entry"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         started=STARTED)
    forbidden = result.pop("forbidden_modules")
    if forbidden:
        print(f"bench_port: loaded in the measuring process: {', '.join(forbidden)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
