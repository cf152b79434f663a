"""The controls and the planted faults, on the card at a cell's own size:
``python3 -m colorbench.control --workload <cell> --seeds 11,12,13
--seconds <s> [--fault <name>|none]``.  Each seed is one run of the cell
with the fault planted (``faults.py`` and the cell's drivers; by default
each of the cell's controls in turn, ``none`` for sound runs), and prints
the numbers the judge compared with their limits, and whether it judged
the run correct.  The benchmark's own runs never plant a fault.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402

from colorbench import faults, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="colorbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch

    from colorbench.run import cache_dirs, execute

    cell = spec.cell(args.workload)
    cache_dirs(spec.ROOT)
    if not torch.cuda.is_available():
        print("colorbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    drivers = spec.cell_drivers(cell)
    for fault in [args.fault] if args.fault else faults.controls(drivers):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            with faults.planted(fault, drivers) if fault != "none" else nullcontext():
                result, numbers = execute(cell, seed, args.seconds, False, device, t_start=t0)
            print(json.dumps({"workload": cell.name, "fault": fault, "seed": seed,
                              "correct": result["correct"], "attempted": result["attempted"],
                              "checks": result["checks"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
