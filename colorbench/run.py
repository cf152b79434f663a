"""One run of one cell: ``python3 -m colorbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.

Set-up, then a closed loop of colouring jobs for ``--seconds``; then the
reference judges every job (``check.py``) and the last line of standard
output is the result: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy and window
seconds and the breakdown.  Exits non-zero without printing a result
where there is no CUDA card, fewer cards than the cell asks for, or a
JAX module loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from colorbench import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "mcmc_colorer_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="colorbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernels build into ``build/kernels/`` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def metric_values(names, run) -> dict:
    out = {}
    for m in names:
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START) -> tuple[dict, list]:
    """Run the cell and judge it: (the result object, the numbers
    compared).  ``device`` is the card; the tests pass the CPU."""
    import torch

    from colorbench import check, loop
    from colorbench import trace as tr

    shim = prof = setup_prof = None
    if trace:
        kernels = spec.roofline_kernels(cell.per_layer)
        shim = tr.Recorder(kernels).install()
        names = {k: spec.roofline(k).KERNEL for k in kernels}
        prof = tr.Trace(names)
        setup_prof = tr.DeviceSection(names)
    try:
        run = loop.run_cell(cell, seed, seconds, device, t_start, shim=shim, profile=prof,
                            setup_profile=setup_prof)
    finally:
        if shim is not None:
            shim.uninstall()
    run.trace = prof
    run.recorder = shim
    t_read = time.perf_counter()
    metrics = metric_values(cell.per_layer if trace else cell.end_to_end, run)
    read_s = time.perf_counter() - t_read
    run.recorder = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, checked = check.judge(run, device)
    check_s = time.perf_counter() - t_check
    attempted = len(run.jobs)
    failed = sum(1 for j in run.jobs if j.seconds is None)
    result = {
        "correct": attempted > 0 and all(x.ok for x in numbers),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    if trace:
        result["device"]["busy_s"] = prof.busy_s
        result["device"]["window_s"] = prof.window_s
        result["breakdown"] = {"device_ops": prof.device_ops, "idle_gaps": prof.idle_gaps}
    result["checks"] = {x.name: {"value": x.value, "limit": x.limit} for x in numbers}
    phases = " ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items())
    print(f"set-up s at the end of each phase: {phases} warm {run.setup_s:.3f}; "
          f"window {run.window_s:.3f} s", file=sys.stderr)
    if trace:
        print(f"trace: profiler stopped in {prof.read_s[0]:.3f} s, events read in "
              f"{prof.read_s[1]:.3f} s, metrics read in {read_s:.3f} s", file=sys.stderr)
        if run.setup_trace is not None:
            st = run.setup_trace
            print(f"trace: set-up's graph section {st.window_s} s, device busy {st.busy_s} s; "
                  f"top device ops {st.device_ops[:5]}", file=sys.stderr)
    print(f"checked {checked} of {attempted} jobs against the reference in {check_s:.3f} s",
          file=sys.stderr)
    return result, numbers


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    cache_dirs(spec.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"colorbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import mcmc_colorer_tpu_torch  # noqa: F401  (the program under test)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, numbers = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"colorbench: JAX modules loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result, numbers)
    return 0


def emit(result: dict, numbers) -> None:
    """The numbers compared, beside their limits, as the last lines of
    standard error; the result as the last line of standard output."""
    for x in numbers:
        print(f"check {x.name} {x.value} limit {x.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
