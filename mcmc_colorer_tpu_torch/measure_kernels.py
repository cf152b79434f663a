"""Kernels K1 (``csrc/packed_nc.cu``) and K3 (``csrc/first_fit.cu``)
timed on the card beside their variants and, optionally, an earlier
commit's kernels.

    python3 -m mcmc_colorer_tpu_torch.measure_kernels [--parent DIR] [--out PATH]

Needs one CUDA device.  Every variant that computes the kernel's function
is first held against the plain version, exactly:

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
  4 KB, 64 KB or 512 KB.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked
with ``git archive`` into the git-ignored ``build/``), the earlier
kernels run beside them: its K1 at the same shape, and the gather plus
its K3 over the gathered band.

The variants run in turn, ``--rounds`` times over, so that a drift of the
card's clock during the run reaches them all; a round's time is the
median CUDA-event time of ``--runs`` calls after one warm-up, and each
variant reports the median of its rounds with their range.  The result
goes to ``--out`` as JSON, with the card's name and power limit.
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


def _rounds(variants: dict, runs: int, rounds: int, label: str) -> list[dict]:
    """Time the variants in turn, ``rounds`` times over (so that a drift of
    the card's clock reaches them all); each round's time is a median of
    ``runs`` calls."""
    times = {name: [] for name in variants}
    for _ in range(rounds):
        for name, fn in variants.items():
            times[name].append(_median_ms(fn, runs))
    out = []
    for name, t in times.items():
        med = statistics.median(t)
        out.append({"variant": name, "ms": med, "rounds_ms": t})
        print(f"{label} {name}: {med:.4f} ms, median of {rounds} rounds "
              f"({min(t):.4f}-{max(t):.4f})")
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


def _config3_band(device, gen, rows=104_832, d_pad=1280, n_ids=2**20, n_real=1_000_000):
    deg = (torch.randn((rows,), generator=gen, device=device) * 31.6 + 1000).round()
    deg = deg.clamp(0, 1173).to(torch.int32)
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
        variants["index_select gather + parent K3"] = lambda: parent.first_fit_cuda(
            neighbor_colors(ids, colors), allow, ncol)
    for name, fn in variants.items():
        if name.startswith("K3") or name.startswith("index_select gather +"):
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{name} differs from the plain version")
    label = (f"K3 band [{ids.shape[0]}, {ids.shape[1]}] n_ids={n_ids} n_colors={ncol} "
             f"neighbour slots={slots}")
    return _rounds(variants, runs, rounds, label)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/measure_kernels.json")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit whose kernels are timed alongside")
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

    with ThreadPoolExecutor(2) as pool:
        for built in list(pool.map(lambda m: m.load_kernel(), (k1, k3))):
            print(f"built {built.path.name} in {built.seconds:.3f} s: " + " | ".join(
                ln.strip() for ln in built.log.splitlines() if "registers" in ln))
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    k3_rows = _k3(device, args.runs, args.rounds, gen, _load_parent(args.parent, "firstfit"))
    torch.cuda.empty_cache()
    k1_rows = _k1(device, args.runs, args.rounds, gen, _load_parent(args.parent, "packed_nc"))
    result = {"card": smi, "k1": k1_rows, "k3": k3_rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
