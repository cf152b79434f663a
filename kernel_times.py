#!/usr/bin/env python3
"""The port's kernels K1-K6 and the ELL tailcut's lower-movable kernel
timed on the card at the shapes the benchmark's cells launch them, each
beside its plain version and the least time the card could take for the
same work.

    python3 kernel_times.py [--parent DIR] [--out PATH]

Run from the root of a checkout, on a machine with an NVIDIA card.  For
each configuration of ``BENCHMARK.json`` it makes the cells' graph as the
benchmark does (``colorbench/families``) and runs one job of each kind
its cells' traffic holds through the cell's driver (``colorbench/drivers``:
the colourer, its palette, its graph path), while the launch function of
each kernel is wrapped to keep the first inputs of every shape it is
launched at, and the launches.  Then, for each kernel and shape, on those
inputs:

- ``ms``: the median CUDA-event time of a launch, a median of 10 launches
  after a warm-up, in 5 rounds (``ms_range`` the rounds' range);
- ``device_ms``: the kernel's time on the card a launch, by
  ``torch.profiler`` over 10 launches, without the host's time before a
  launch;
- ``plain_ms``: the plain version's time on the same inputs (K5's over
  128 of its rows, scaled to the graph's n);
- ``bound_ms`` and ``bound_by``: the larger of the bytes over the memory
  rate and the operations over their peak, from the kernel's work count
  in ``colorbench/roofline/`` and the peaks of ``colorbench/peaks.py``
  (K6, which has none, by K5's: a build of the same graph whose rectangle
  is A's words; the lower-movable kernel, which has none either, by its
  bytes: the rows' movable flags read and written, the movable rows'
  ids); ``bound_share`` = ``bound_ms / device_ms``, and
  ``bound_share_event`` = ``bound_ms / ms``, which counts the host's time
  before a launch too.

``--parent DIR``: the kernels of another checkout at ``DIR`` (its
``mcmc_colorer_tpu_torch/ops`` wrappers and ``csrc`` sources, unpacked
with ``git archive`` into a git-ignored directory) run on the same inputs
in the same rounds, in turns with these (``parent_ms``, ``parent_ms_range``,
``parent_device_ms``).

Each kernel source's build prints, for each kernel instance in it, its
registers, shared memory and spills (as ``nvcc -Xptxas -v`` gives them),
the parent's too.  K3's shapes hold the greedy instance's launches and
the tailcut's (those with ``flag``), apart.  The output is one JSON
line per kernel, then the card's name and power limit; all of it also
goes to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# kernel: (ops module, launch function, plain version, roofline file, the
# kernel's name on the device)
KERNELS = {
    "K1": ("packed_nc", "packed_nc_cuda", "packed_nc_reference", "k1", "packed_nc_kernel"),
    "K2": ("resample", "resample_sweep_cuda", "resample_sweep_plain", "k2", "resample_kernel"),
    "K3": ("firstfit", "first_fit_cuda", "first_fit_plain", "k3", "first_fit_kernel"),
    "K4": ("propose_nc", "propose_nc_cuda", "propose_nc_plain", "k4", "propose_nc_kernel"),
    "K5": ("hash_ell", "hash_ell_cuda", None, "k5", "hash_ell_kernel"),
    "K6": ("hash_packed", "hash_packed_cuda", None, None, "hash_packed_kernel"),
    "K3-lower": ("firstfit", "lower_movable_cuda", "lower_movable_plain", None,
                 "lower_movable_kernel"),
}
# the arguments a launch reads and never writes, and which stay alive
# with the graph: kept as they are, where the others are cloned
SHARED_ARG = {"K1": 0, "K2": 0, "K3": 0, "K3-lower": 0}
RUNS, ROUNDS, K5_PLAIN_ROWS = 10, 5, 128


def ops_module(name: str, root: Path | None = None):
    """``ops/<name>.py`` of this checkout, or of the checkout at ``root``
    as a module of its own that builds its own ``csrc`` source (None where
    that checkout has no such file)."""
    if root is None:
        return importlib.import_module(f"mcmc_colorer_tpu_torch.ops.{name}")
    path = root / "mcmc_colorer_tpu_torch" / "ops" / f"{name}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(f"parent_ops_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass in the file looks its module up
    spec.loader.exec_module(mod)
    return mod


def ptxas(source: Path) -> str:
    """What ptxas says of each kernel instance of ``source`` (registers,
    shared memory, spills), from an nvcc run of the build's own flags into
    a scratch directory: a library loaded from an earlier build has no
    log.  Each instance is named as ``cu++filt`` demangles it, without its
    parameter list (``_without_params``), where the toolkit has it."""
    import re
    import shutil
    import tempfile

    from mcmc_colorer_tpu_torch.utils import cuda_build

    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                               str(Path(td) / "k.so"), str(source)],
                              capture_output=True, text=True, check=True)
    entries: dict[str, list[str]] = {}
    name = ""
    for ln in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            name = m.group(1)
            entries.setdefault(name, [])
        elif "registers" in ln or "spill" in ln:
            entries.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    filt = shutil.which("cu++filt") or str(Path(cuda_build._nvcc()).with_name("cu++filt"))
    names = list(entries)
    if names and Path(filt).exists():
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(names):
            names = [_without_params(n) for n in out]
    return " | ".join(f"{n}: {'; '.join(v)}" for n, v in zip(names, entries.values()))


def _without_params(name: str) -> str:
    """A demangled kernel name without ``void`` and its parameter list:
    ``ns::k<(bool)1, (int)2>``."""
    name = name.removeprefix("void ")
    close = name.rfind(">")
    if close >= 0 and name[close + 1:close + 2] in ("(", ""):
        return name[:close + 1]
    return name.split("(")[0]


def build(mods: dict, label: str) -> None:
    """Load every kernel (its nvcc runs started together) and print what
    ptxas says of each source's instances, once a source."""
    by_source = {m.SOURCE: m for m in mods.values()}
    with ThreadPoolExecutor(len(by_source)) as pool:
        built = dict(zip(by_source, pool.map(lambda m: m.load_kernel(), by_source.values())))
        reports = dict(zip(by_source, pool.map(ptxas, by_source)))
    for src, b in built.items():
        names = " ".join(k for k, m in mods.items() if m.SOURCE == src)
        print(f"{label} {names} {b.path.name}: loaded in {b.seconds:.3f} s; "
              f"ptxas: {reports[src]}")


def _key(args, kwargs) -> tuple:
    def one(x):
        if isinstance(x, torch.Tensor):
            return tuple(x.shape)
        if hasattr(x, "n_colors"):  # MCMCParams
            return (x.proposal.value, x.n_colors, x.taboo_iterations)
        return x if isinstance(x, (int, float, bool, type(None))) else type(x).__name__
    return tuple(one(x) for x in args) + tuple((k, one(v)) for k, v in sorted(kwargs.items()))


class Capture:
    """While jobs run: for each kernel of ``mods`` ({kernel: its ops
    module}), the first inputs of each shape it is launched at (cloned but
    for ``SHARED_ARG``), and the launches, under the label ``self.label``:
    ``seen`` is {(label, kernel, shape key): [launches, (args, kwargs)]}."""

    def __init__(self, mods: dict):
        self.mods, self.seen, self.label = mods, {}, ""

    def __enter__(self):
        self.orig = {k: getattr(m, KERNELS[k][1]) for k, m in self.mods.items()}
        for k, m in self.mods.items():
            setattr(m, KERNELS[k][1], self._wrap(k, self.orig[k]))
        return self

    def _wrap(self, kernel, orig):
        def call(*args, **kwargs):
            rec = self.seen.setdefault((self.label, kernel, _key(args, kwargs)), [0, None])
            if rec[1] is None:
                rec[1] = (tuple(x.clone() if isinstance(x, torch.Tensor)
                                and i != SHARED_ARG.get(kernel) else x
                                for i, x in enumerate(args)),
                          {k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in kwargs.items()})
            rec[0] += 1
            return orig(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for k, m in self.mods.items():
            setattr(m, KERNELS[k][1], self.orig[k])


def run_cells(device, mods) -> dict:
    """One job of each kind of every cell's traffic, a configuration at a
    time, under ``Capture``: {(configuration and job, kernel, shape key):
    [launches, (args, kwargs)]}."""
    from colorbench import spec

    bench = spec.benchmark()
    jobs: dict[str, list] = {}
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench=bench)
        todo = jobs.setdefault(cell.config["name"], [])
        todo += [(cell.config, job) for job in cell.traffic["jobs"]
                 if (cell.config, job) not in todo]
    cap = Capture(mods)
    for name, todo in jobs.items():
        config = todo[0][0]
        graph = spec.family(config["family"]).make(config, config["graph_seed"])
        for config, job in todo:
            driver = spec.driver(config["path"], job["colorer"])
            cap.label = f"{name} {job['colorer']}" + (
                f" ratio {job['num_col_ratio']}" if "num_col_ratio" in job else "")
            with cap:
                driver.run(driver.make(config, job, graph, device), 1, 0)
            print(f"ran {cap.label}", flush=True)
        del graph
        torch.cuda.empty_cache()
    return cap.seen


def event_ms(fn, runs: int = RUNS) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` calls after one."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, name: str, runs: int = RUNS) -> float:
    """The card's time for one launch of the kernel named ``name``, without
    the host's time before it: ``runs`` calls of ``fn`` under
    ``torch.profiler``, the kernel's device time over the launches the
    profiler recorded (it can miss the first few of a session)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if name in e.key]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in rows)
    return us / 1e3 / max(sum(e.count for e in rows), 1)


def plain_call(kernel: str, mods: dict, args, kwargs):
    """The plain version on a launch's inputs: (a call, or None; the rows
    it covers where that is fewer than the launch's)."""
    mod = mods[kernel]
    if kernel == "K4":
        from mcmc_colorer_tpu_torch.models.mcmc import choose_block_size

        nc, params = args[0], args[7]
        block = choose_block_size(nc.shape[1], params.n_colors)
        return (lambda: mod.propose_nc_plain(*args, block)), None
    if kernel == "K5":
        degrees, n, p, seed = args[:4]
        d_pad = args[4] if len(args) > 4 else kwargs.get("d_pad")
        if d_pad is None:
            return None, None  # the count: the fill's plain rows run both passes
        return (lambda: mod.hash_ell_plain_rows(n, p, seed, degrees.shape[0], d_pad, 0,
                                                K5_PLAIN_ROWS, device=degrees.device)), \
            K5_PLAIN_ROWS
    if kernel == "K6":
        from mcmc_colorer_tpu_torch.ops.hashgen import gen_packed_rows_plain

        r0, n, t, seed32, out, degrees = args
        words = out.shape[1]
        return (lambda: gen_packed_rows_plain(r0, n, t, seed32, words, out, degrees)), None
    return (lambda: getattr(mod, KERNELS[kernel][2])(*args, **kwargs)), None


def bound(kernel: str, args, kwargs, memo) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time of the launch's work, which
    the kernel's roofline file counts, at the peaks; K6's as K5's build of
    the same graph into a rectangle of A's words (a count and a fill)."""
    from colorbench import peaks, spec

    if kernel == "K3-lower":
        neigh, movable = args[:2]
        row0 = kwargs.get("row0", 0)
        mine = movable[:, row0:row0 + neigh.shape[0]]
        n_bytes = 2 * mine.numel() + int(mine.sum()) * neigh.shape[1] * neigh.element_size()
        return peaks.bound_s(n_bytes, 0, 1.0) * 1e3, "bytes"
    if kernel == "K6":
        _r0, n, _t, _s, out, degrees = args
        rows = torch.empty(((out if out is not None else degrees).shape[0],))
        words = out.shape[1] if out is not None else 0
        roof, launches = spec.roofline("k5"), [(rows, n, None, None, words), (rows, n)]
    else:
        roof, launches = spec.roofline(KERNELS[kernel][3]), [args]
    total = by_bytes = by_ops = 0.0
    for a in launches:
        n_bytes, ops = (float(x) for x in roof.work(a, kwargs, memo))
        total += peaks.bound_s(n_bytes, ops, roof.OPS_PER_S)
        by_bytes += peaks.bound_s(n_bytes, 0, roof.OPS_PER_S)
        by_ops += peaks.bound_s(0, ops, roof.OPS_PER_S)
    return total * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def _takes(fn, args, kwargs) -> bool:
    """Whether ``fn`` takes these arguments (a parent's launch function may
    lack a keyword, such as K3's tailcut call)."""
    import inspect

    try:
        inspect.signature(fn).bind(*args, **kwargs)
    except TypeError:
        return False
    return True


def time_shape(kernel, launches, inputs, mods, parent, memo) -> dict:
    """One shape's row: the kernel (and the parent's) in turns, device
    time, the plain version, the bound."""
    args, kwargs = inputs
    fns = {"": lambda: getattr(mods[kernel], KERNELS[kernel][1])(*args, **kwargs)}
    if parent.get(kernel) is not None and _takes(getattr(parent[kernel], KERNELS[kernel][1]),
                                                 args, kwargs):
        fns["parent_"] = lambda: getattr(parent[kernel], KERNELS[kernel][1])(*args, **kwargs)
    rounds = {k: [] for k in fns}
    for r in range(ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            rounds[k].append(event_ms(fns[k]))
    row = {"launches": launches}
    for k, t in rounds.items():
        row[f"{k}ms"] = statistics.median(t)
        row[f"{k}ms_range"] = [min(t), max(t)]
        row[f"{k}device_ms"] = device_ms(fns[k], KERNELS[kernel][4])
    plain, rows = plain_call(kernel, mods, args, kwargs)
    row["plain_ms"] = None
    if plain is not None:
        ms = event_ms(plain, runs=1)
        row["plain_ms"] = ms if rows is None else ms * args[1] / rows
    row["bound_ms"], row["bound_by"] = bound(kernel, args, kwargs, memo)
    # the profiler may record no launch (device_ms 0): no share then
    row["bound_share"] = row["bound_ms"] / row["device_ms"] if row["device_ms"] else None
    row["bound_share_event"] = row["bound_ms"] / row["ms"]
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose kernels run beside these on the same inputs")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_times.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py: no CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    mods = {k: ops_module(v[0]) for k, v in KERNELS.items()}
    build(mods, "build")
    parent = {}
    if args.parent is not None:
        parent = {k: ops_module(v[0], args.parent.resolve()) for k, v in KERNELS.items()}
        # a parent without a kernel's launch function runs none of it
        parent = {k: m if hasattr(m, KERNELS[k][1]) else None for k, m in parent.items()}
        build({k: m for k, m in parent.items() if m is not None}, "parent build")
    seen = run_cells(device, mods)
    from colorbench.trace import Memo

    memo, lines = Memo(), {}
    for (label, kernel, key), (n, inputs) in seen.items():
        row = time_shape(kernel, n, inputs, mods, parent, memo)
        lines.setdefault(kernel, []).append({"job": label, "shape": str(key), **row})
        torch.cuda.empty_cache()
    out = []
    for kernel in KERNELS:
        line = {"kernel": kernel, "name": KERNELS[kernel][0],
                "source": str(mods[kernel].SOURCE.relative_to(ROOT)), "card": smi,
                "shapes": lines.get(kernel, [])}
        out.append(line)
        print(json.dumps(line), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
