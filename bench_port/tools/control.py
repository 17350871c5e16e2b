"""Readings that the limits are set from, on the card at the cell's own
size: for each seed one run of the cell (a short window) gives the
program's numbers against the reference (the lower readings), and the same
run puts the reference in the program's place three times: in float8 (the
control: the precision below the configuration's bfloat16), with half of
each batch left out and the loss doubled, and with no update taken (two
faults), for their readings (the upper ones). With ``--bf16`` the
reference in bfloat16 is put in its place as well: a witness of what
bfloat16's rounding alone moves. One JSON line a seed to
``chiprun_out/control_<cell>.jsonl``.

    python bench_port/tools/control.py <cell> <seconds> [--bf16] <seed> [<seed> ...]
"""
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(0, os.path.dirname(BENCH_DIR))

import harness  # noqa: E402

CONTROLS = ({"precision": "fp8"}, {"half_batch": True}, {"frozen": True})


def main():
    cell, seconds, rest = sys.argv[1], float(sys.argv[2]), sys.argv[3:]
    controls = CONTROLS + (({"precision": "bf16"},) if "--bf16" in rest else ())
    seeds = [int(s) for s in rest if s != "--bf16"]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"control_{cell}.jsonl"), "a") as out:
        for seed in seeds:
            r = harness.run(cell, seed, seconds, False, controls=controls,
                            log=open(os.devnull, "w"))
            line = {"cell": cell, "seed": seed, "correct": r["correct"],
                    "program": {k: v["value"] for k, v in r["checks"].items()},
                    "controls": r["controls"], "details": r["details"],
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
