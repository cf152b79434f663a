"""Kernels K1 (``csrc/packed_nc.cu``), K2 (``csrc/resample.cu``) and K3
(``csrc/first_fit.cu``) timed on the card beside their variants and,
optionally, an earlier commit's kernels.

    python3 -m mcmc_colorer_tpu_torch.measure_kernels [--parent DIR] [--out PATH]

Needs one CUDA device.  Every variant that computes the kernel's function
is first held against the plain version (K1 and K3 exactly; K2 with
exact conflict counts and at most 0.1 % of rows sampling another colour,
at CDF steps):

- K1 at the resident bench shape: the hash graph ER(100k, 0.01) (n_pad
  100,352, 3,200 words a row), 1152 padded colours, random colours, and
  the measurement variants of the kernel (mode 1:
  A streamed and the colours staged, nothing counted; mode 2: also the
  bits walked and their colours looked up, without the histogram);
  before them, rows of 2**16 set bits (the kernel's 32-bit path);
- K3 at a band of BASELINE config 3's shape: 104,832 rows of d_pad 1280,
  ids drawn on the card with ER(1M, 0.001) degrees (normal, mean 1000,
  sd 31.6, at most 1173) into a colour vector of 2**20 ids, 1173 colours,
  random colours, ids in order and the padding id in the rest of a row;
  the ``index_select`` gather of the band, which K3 now does itself, and
  probes of what holds it: K3 on the band with its ids folded into the
  first 2**10, 2**14 or 2**17 ids, so that its colour lookups fall in
  4 KB, 64 KB or 512 KB;
- K2 (balance-dynamic) at the same config-3 band, in the L2 regime, and
  at a sweep of ER(100k, 0.01)'s shape (100,000 rows of d_pad 1152, the
  same degree law capped at 1150, into the 100,000 real vertices'
  colours, 1150 colours), staged and forced to L2; the ``index_select``
  gather alone, and probes of what holds K2 (its measurement modes: 1
  streams the ids alone, 2 adds the colour lookups and the occupancy,
  without the palette passes); and each variant's peak device memory
  above what was allocated before it.  With ``--parent``, the parent's
  K2 also runs alone on a band gathered beforehand.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked
with ``git archive`` into the git-ignored ``build/``), the earlier
kernels run beside them: its K1 and K3 at the same shapes, and the
gather plus its K2 over the gathered band (the interface K2 had before
it gathered for itself).

The variants run in turn, ``--rounds`` times over, so that a drift of the
card's clock during the run reaches them all; a round's time is the
median CUDA-event time of ``--runs`` calls after one warm-up, and each
variant reports the median of its rounds with their range.  A CUDA-event
time around one call also holds the host's time before the launch, so
each variant also reports its device time: the card's time for the work
of ``--runs`` calls under ``torch.profiler``, a call's share of it.  The result
goes to ``--out`` as JSON, with the card's name and power limit.

    python3 -m mcmc_colorer_tpu_torch.measure_kernels --colorers [--out PATH]

times the colorers around K1 and K3 instead: at BASELINE config 3
(ER(1M, 0.001), seed 3, the native sampler) GreedyFF and VFF, full and
frontier; at ER(100k, 0.01) (the hash graph of graph seed 0, re-derived
on the host) Luby's gather, frontier and resident loops.  Each colorer
runs once to warm up, once timed (wall seconds on the host clock
between synchronizations, the peak of allocated device bytes), and once
under ``torch.profiler``: the device's idle share, the ten operations
with the most device time, and the frontier rounds grouped by their
profiler range (``models/mcmc_active.py:round_range``, named by loop and
cap): rounds and host milliseconds a round.  A frontier round ends in a
host read, so its host time is its wall time.  It also times an empty
``round_range`` without a profiler, the range's cost a round.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import torch


def _median_ms(fn, runs: int) -> float:
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _load_parent(root: str | None, name: str):
    """``ops/<name>.py`` of the checkout at ``root`` as a module of its own
    (it builds its own kernel source), or None."""
    if root is None:
        return None
    path = Path(root) / "mcmc_colorer_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(fn, runs: int) -> float:
    """Device time of one call of ``fn``: the time of all the work it puts
    on the card, summed over ``runs`` calls under ``torch.profiler``, over
    ``runs``.  Unlike a CUDA-event time around one call, it leaves out the
    host's time before the launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3 / runs


def _rounds(variants: dict, runs: int, rounds: int, label: str) -> list[dict]:
    """Time the variants in turn, ``rounds`` times over (so that a drift of
    the card's clock reaches them all); each round's time is a median of
    ``runs`` calls.  Then each variant's device time (``_device_ms``)."""
    times = {name: [] for name in variants}
    for _ in range(rounds):
        for name, fn in variants.items():
            times[name].append(_median_ms(fn, runs))
    out = []
    for name, t in times.items():
        med = statistics.median(t)
        dev_ms = _device_ms(variants[name], runs)
        out.append({"variant": name, "ms": med, "rounds_ms": t, "device_ms": dev_ms})
        print(f"{label} {name}: {med:.4f} ms, median of {rounds} rounds "
              f"({min(t):.4f}-{max(t):.4f}); device time {dev_ms:.4f} ms a call")
    return out


def _k1(device, runs: int, rounds: int, gen, parent=None) -> list[dict]:
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops.hashgen import degrees_from_packed, er_packed_on_device

    n, n_pad, ncp = 100_000, 100_352, 1152
    adj = er_packed_on_device(n, 0.01, 1, n_pad, device=device)
    colors = torch.randint(0, ncp, (n_pad,), generator=gen, device=device, dtype=torch.int32)
    colors[n:] = -1
    want = k1.packed_nc_reference(adj, colors, ncp)
    set_bits = int(degrees_from_packed(adj).sum())
    # rows of 2**16 set bits and more take the kernel's 32-bit path
    wide = torch.randint(-2**31, 2**31 - 1, (64, 2048), generator=gen, device=device,
                         dtype=torch.int32)
    wide[::2] = -1  # every bit set
    cw = torch.randint(-1, 8, (2048 * 32,), generator=gen, device=device, dtype=torch.int32)
    if not torch.equal(k1.packed_nc_cuda(wide, cw, 128), k1.packed_nc_reference(wide, cw, 128)):
        raise RuntimeError("K1 differs from its plain version on rows of 2**16 set bits")
    print("K1 rows of 65,536 set bits: exact")
    variants = {
        "K1": lambda: k1.packed_nc_cuda(adj, colors, ncp),
        "mode 1": lambda: k1.packed_nc_cuda(adj, colors, ncp, mode=1),
        "mode 2": lambda: k1.packed_nc_cuda(adj, colors, ncp, mode=2),
    }
    if parent is not None:
        variants["parent K1"] = lambda: parent.packed_nc_cuda(adj, colors, ncp)
    for name, fn in variants.items():
        if "mode" not in name and not torch.equal(fn(), want):
            raise RuntimeError(f"{name} differs from the plain version")
    label = f"K1 n_pad={n_pad} words={adj.shape[1]} n_col_pad={ncp} set_bits={set_bits}"
    return _rounds(variants, runs, rounds, label)


def _config3_band(device, gen, rows=104_832, d_pad=1280, n_ids=2**20, n_real=1_000_000,
                  max_degree=1173):
    """[rows, d_pad] ids of ER degrees (mean 1000, sd 31.6) in order, drawn
    from the first ``n_real`` ids, the padding id ``n_ids`` in the rest of
    a row; and the number of neighbour slots."""
    deg = (torch.randn((rows,), generator=gen, device=device) * 31.6 + 1000).round()
    deg = deg.clamp(0, max_degree).to(torch.int32)
    ids = torch.randint(0, n_real, (rows, d_pad), generator=gen, device=device, dtype=torch.int32)
    slot = torch.arange(d_pad, device=device, dtype=torch.int32)[None, :]
    ids = torch.where(slot < deg[:, None], ids, n_ids)
    ids = torch.sort(ids, dim=1).values.contiguous()
    return ids, int(deg.sum())


def _k3(device, runs: int, rounds: int, gen, parent=None) -> list[dict]:
    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors

    n_ids, ncol = 2**20, 1173
    ids, slots = _config3_band(device, gen, n_ids=n_ids)
    colors = torch.randint(0, ncol, (n_ids,), generator=gen, device=device, dtype=torch.int32)
    colors[1_000_000:] = ncol  # phantoms hold a colour that counts nowhere
    allow = torch.ones((ncol,), dtype=torch.int32, device=device)
    want = k3.first_fit_plain(ids, colors, allow, ncol)
    variants = {
        "K3": lambda: k3.first_fit_cuda(ids, colors, allow, ncol),
        "index_select gather": lambda: neighbor_colors(ids, colors),
    }
    # probes of what holds K3: the same band with every id folded into the
    # first m ids, so that the colour lookups fall in 4 * m bytes
    for log_m in (10, 14, 17):
        m = 1 << log_m
        folded = torch.where(ids < n_ids, ids % m, m)
        variants[f"probe: ids folded into {m}"] = (
            lambda f=folded, c=colors[:m].contiguous(): k3.first_fit_cuda(f, c, allow, ncol))
    if parent is not None:
        variants["parent K3"] = lambda: parent.first_fit_cuda(ids, colors, allow, ncol)
    for name, fn in variants.items():
        if "K3" in name:
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{name} differs from the plain version")
    label = (f"K3 band [{ids.shape[0]}, {ids.shape[1]}] n_ids={n_ids} n_colors={ncol} "
             f"neighbour slots={slots}")
    return _rounds(variants, runs, rounds, label)


def _peak_bytes(fn) -> int:
    """Device bytes ``fn`` allocates at its peak above what was allocated."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _k2_case(label, ids, colors, n_colors, gen, runs, rounds, parent, staged) -> dict:
    """K2 (balance-dynamic, random colours and uniforms, no taboo) on one
    band: its regimes, the gather, the probes and the parent's gather plus
    K2, in turns."""
    from mcmc_colorer_tpu_torch.config import MCMCParams, ProposalKind
    from mcmc_colorer_tpu_torch.ops import resample as k2
    from mcmc_colorer_tpu_torch.ops.neighbor import neighbor_colors

    dev = ids.device
    rows = ids.shape[0]
    p = MCMCParams(n_colors=n_colors, proposal=ProposalKind.BALANCE_DYNAMIC)
    p_eff = torch.rand((n_colors,), generator=gen, device=dev)
    p_eff /= p_eff.sum()
    cur = colors[:rows].contiguous()
    taboo = torch.zeros((rows,), dtype=torch.int32, device=dev)
    unif = torch.rand((rows,), generator=gen, device=dev)
    args = (ids, colors, cur, taboo, 0, unif, p_eff, p.epsilon, p)
    if k2.sweep_shape(colors.shape[0], n_colors).staged != staged:
        raise RuntimeError(f"K2 at {label}: not the regime measured")
    want = k2.resample_sweep_plain(*args)
    variants = {"K2": lambda: k2.resample_sweep_cuda(*args)}
    if staged:
        variants["K2 forced to L2"] = lambda: k2.resample_sweep_cuda(*args, _l2=True)
    variants["index_select gather"] = lambda: neighbor_colors(ids, colors)
    variants["probe: ids streamed alone"] = lambda: k2.resample_sweep_cuda(*args, mode=1)
    variants["probe: + lookups and occupancy"] = lambda: k2.resample_sweep_cuda(*args, mode=2)
    if parent is not None:
        self_ids = torch.arange(rows, dtype=torch.int32, device=dev)
        nc = neighbor_colors(ids, colors)
        variants["index_select gather + parent K2"] = lambda: parent.resample_sweep_cuda(
            neighbor_colors(ids, colors), ids, cur, taboo, self_ids, unif, p_eff, p.epsilon, p)
        variants["parent K2 on the gathered band"] = lambda: parent.resample_sweep_cuda(
            nc, ids, cur, taboo, self_ids, unif, p_eff, p.epsilon, p)
    for name, fn in variants.items():
        if "K2" not in name:
            continue
        got = fn()
        differ = int((got[0] != want[0]).sum())
        if int(got[3]) != int(want[3]) or differ > 1e-3 * rows:
            raise RuntimeError(f"{name} at {label}: conflicts {int(got[3])} vs "
                               f"{int(want[3])}, {differ} samples differ")
    peak = {name: _peak_bytes(fn) for name, fn in variants.items()}
    label = f"K2 {label} n_ids={colors.shape[0]} n_colors={n_colors}"
    out = _rounds(variants, runs, rounds, label)
    for row in out:
        row["peak_bytes"] = peak[row["variant"]]
    print(f"{label} peak bytes above the inputs: {peak}")
    return {"rows": rows, "d_pad": ids.shape[1], "n_ids": colors.shape[0],
            "n_colors": n_colors, "variants": out}


def _k2(device, runs: int, rounds: int, gen, parent=None) -> dict:
    n_col3 = 1173
    ids, slots = _config3_band(device, gen)
    colors = torch.randint(0, n_col3, (2**20,), generator=gen, device=device, dtype=torch.int32)
    colors[1_000_000:] = n_col3
    out = {"config-3 band": _k2_case(
        f"config-3 band [{ids.shape[0]}, {ids.shape[1]}] slots={slots}", ids, colors, n_col3,
        gen, runs, rounds, parent, staged=False)}
    del ids, colors
    torch.cuda.empty_cache()
    n, n_col = 100_000, 1150
    ids, slots = _config3_band(device, gen, rows=n, d_pad=1152, n_ids=n, n_real=n,
                               max_degree=n_col)
    colors = torch.randint(0, n_col, (n,), generator=gen, device=device, dtype=torch.int32)
    out["ER(100k, 0.01) sweep"] = _k2_case(
        f"ER(100k, 0.01) sweep [{n}, 1152] slots={slots}", ids, colors, n_col, gen, runs,
        rounds, parent, staged=True)
    return out


CONFIG3 = (1_000_000, 0.001, 3)   # n, p, seed: BASELINE.md config 3
LUBY_GRAPH = (100_000, 0.01, 0)   # n, p, graph seed: the resident bench
LUBY_SEED = 5
ROUND_TAG = " round cap="         # in the names of round_range's ranges


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _colorer(label: str, make, top: int = 10) -> dict:
    """``make()`` (one colorer run) warm, timed and profiled."""
    from torch.profiler import ProfilerActivity, profile

    from mcmc_colorer_tpu_torch.utils.memtrack import device_memory_stats
    from mcmc_colorer_tpu_torch.utils.timer import Timer

    make()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Timer() as wall:
        make()
        torch.cuda.synchronize()
    row = {"wall_s": wall.duration_ms / 1e3,
           "peak_bytes": device_memory_stats()["peak_bytes_in_use"]}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with Timer() as prof_wall:
            make()
            torch.cuda.synchronize()
    device, rounds = [], {}
    for e in prof.key_averages():
        on_card = str(e.device_type).endswith("CUDA")
        if ROUND_TAG in e.key:  # a host range only: spans leave no row on the card
            ms = e.cpu_time_total / 1e3
            rounds[e.key] = {"rounds": e.count, "ms": ms, "ms_a_round": ms / e.count}
        elif on_card:
            device.append(e)
    device.sort(key=_device_us, reverse=True)
    device_ms = sum(map(_device_us, device)) / 1e3
    row["profile"] = {
        "wall_s": prof_wall.duration_ms / 1e3, "device_ms": device_ms,
        "idle_share": 1 - device_ms / prof_wall.duration_ms,
        "top": [{"op": e.key, "count": e.count, "device_ms": _device_us(e) / 1e3}
                for e in device[:top]],
        "rounds": dict(sorted(rounds.items(), key=lambda kv: int(kv[0].split("=")[1]))),
    }
    print(f"{label}: {json.dumps(row)[:3000]}", flush=True)
    return row


def _range_cost_us(n: int = 10_000) -> float:
    """Host microseconds of one empty ``round_range`` without a profiler."""
    from mcmc_colorer_tpu_torch.models.mcmc_active import round_range
    from mcmc_colorer_tpu_torch.utils.timer import Timer

    with Timer() as t:
        for _ in range(n):
            with round_range("probe", 128):
                pass
    return t.duration_ms * 1e3 / n


def _colorers(device) -> dict:
    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
    from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer
    from mcmc_colorer_tpu_torch.models.luby import LubyColorer
    from mcmc_colorer_tpu_torch.models.vff import VFFColorer

    out = {"round_range_us": _range_cost_us()}
    resident = LubyColorer(None, resident_spec=LUBY_GRAPH, device=device)
    g = resident.host_graph()
    for label, c in (("Luby gather", LubyColorer(g, device=device)),
                     ("Luby frontier", LubyColorer(g, active=True, device=device)),
                     ("Luby resident", resident)):
        out[label] = _colorer(label, lambda c=c: c.run(LUBY_SEED))
    del resident, c, g
    torch.cuda.empty_cache()
    g = erdos_renyi(CONFIG3[0], CONFIG3[1], seed=CONFIG3[2])
    for label, make in (("GreedyFF full", lambda: GreedyFFColorer(g, device=device)),
                        ("GreedyFF frontier", lambda: GreedyFFColorer(g, active=True,
                                                                      device=device)),
                        ("VFF full", lambda: VFFColorer(g, device=device)),
                        ("VFF frontier", lambda: VFFColorer(g, active=True, device=device))):
        c = make()
        out[f"{label}, config 3"] = _colorer(f"{label}, config 3", c.run)
        del c
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/measure_kernels.json")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit whose kernels are timed alongside")
    ap.add_argument("--colorers", action="store_true",
                    help="time the colorers around K1 and K3 instead of the kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_kernels: no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from concurrent.futures import ThreadPoolExecutor

    from mcmc_colorer_tpu_torch.ops import firstfit as k3
    from mcmc_colorer_tpu_torch.ops import packed_nc as k1
    from mcmc_colorer_tpu_torch.ops import resample as k2

    with ThreadPoolExecutor(3) as pool:
        for built in list(pool.map(lambda m: m.load_kernel(), (k1, k2, k3))):
            print(f"built {built.path.name} in {built.seconds:.3f} s: " + " | ".join(
                ln.strip() for ln in built.log.splitlines() if "registers" in ln))
    if args.colorers:
        result = {"card": smi, "colorers": _colorers(device)}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
        return 0
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    k2_rows = _k2(device, args.runs, args.rounds, gen, _load_parent(args.parent, "resample"))
    torch.cuda.empty_cache()
    k3_rows = _k3(device, args.runs, args.rounds, gen, _load_parent(args.parent, "firstfit"))
    torch.cuda.empty_cache()
    k1_rows = _k1(device, args.runs, args.rounds, gen, _load_parent(args.parent, "packed_nc"))
    result = {"card": smi, "k1": k1_rows, "k2": k2_rows, "k3": k3_rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
