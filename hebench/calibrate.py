"""The readings the limits of checks.py are set from, and the control.

    python -m hebench.calibrate --workload <name> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: a run of the cell as `hebench.run` makes it
(a short window), then the same sampled answers judged twice: as served
(the program's reading) and through checks.control (the control's
reading). Prints one JSON line a seed. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from hebench import checks, harness


def readings(root: Path, workload: str, seed: int, seconds: float, device: str) -> dict:
    started = time.perf_counter()
    result, extra = harness.run_cell(root, workload, seed, seconds, False, device, started)
    served = extra["served"]
    limits = extra["run"].config["limits"]
    control = checks.judge(served, extra["answers"], limits, device=device,
                           scalar_bits=extra["run"].config["scalar_bits"])
    return dict(
        workload=workload, seed=seed, correct=result["correct"], checked=extra["judged"]["checked"],
        program={k: v["value"] for k, v in result["checks"].items()},
        control={k: v["value"] for k, v in control["numbers"].items()},
        control_correct=checks.passes(control["numbers"]),
        metrics={k: v["value"] for k, v in result["metrics"].items()},
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m hebench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("the control is read on the CUDA card")
        return 2
    harness.log(f"card: {harness.card_line()}")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(Path.cwd(), args.workload, seed, args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
