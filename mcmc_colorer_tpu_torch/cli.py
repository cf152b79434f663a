"""Command-line interface of the PyTorch/CUDA port.

Counterpart of ``mcmc_colorer_tpu/cli.py``, with the same flags, defaults,
messages and exit codes over the port's colorers, and the reference's
output contract (``<name>-<ALGO>-<rep>.log`` and ``...-colors.txt`` in
``<graphName>_out``).  One flag is added: ``--device`` (default
``cuda``, the current card); ``--device cpu`` runs the colorers' plain
versions on the CPU.  Without a card and without ``--device cpu`` it
refuses (exit 2).

``--mcmcgpu``/``--lubygpu``/``--grdffgpu``/``--vffgpu`` run the device
colorers; the device MCMC's log tag is ``MCMC_GPU``, the reference's own.
``--mcmccpu`` and ``--greedycpu`` run the sequential host colorers.
``--mcmcgpu --active`` runs the frontier chain (``ActiveMCMCColorer``, or
the resident one with ``--resident``); ``--backend matmul|packed`` runs
``MCMCColorer``'s packed chain over a host graph, and the other device
colorers take ``auto`` instead, as the JAX CLI does.  ``--layout
bucketed`` lays the graph out in degree classes for every device colorer
(with ``--active`` too).  ``--chains N`` runs ``EnsembleMCMCColorer``
(with ``--resident``, the resident ensemble); ``--dbg`` runs the stepped
chain (``SteppedMCMC``) under the break-in debugger (``DebugAttach``);
``--ckpt``/``--resume`` go to the targets that checkpoint (the resident
colorer, the stepped chain), as in JAX: for any other ``--resume`` exits
2 and ``--ckpt`` is ignored with a message; ``-v 1`` or more turns the
TRACE output on (the device chain's free-colour lines among it).

``--resident --mcmcgpu --backend pallas|xla`` on a graph whose packed
adjacency does not fit (``n`` past ``PACKED_ADJ_MAX_N``: BASELINE config
3, ER(10^6, 0.001)) runs ``MCMCColorer`` over a ``HashGraph``, one chain
of full sweeps: the hash graph's flat ELL built on the device by kernel
K5; ``--check`` enumerates the graph on the host.  Below the cap the
packed route runs, as it always has.

``--mesh-chains``/``--mesh-shards`` run ``ShardedMCMCColorer`` on a
(chains, shards) mesh of ``torch.distributed`` ranks (``--anneal``:
pooled annealing; ``--active``: frontier sweeps, cap ``max(128, n //
8)``): over a host graph, with ``--backend matmul|packed`` each rank's
strip of the bit-packed adjacency (K1), or with ``--resident`` the hash
graph's strips, each rank generating its own (no bytes uploaded).
``--active --chains N`` runs it on a 1x1 mesh in this process, as JAX
runs frontier ensembles.  More than one rank is started by ``torchrun
--nproc-per-node N`` (one card each under NCCL, gloo where ranks share a
card); a mesh larger than the world exits 2 naming ``torchrun``, and rank
0 alone prints and writes the ``.log`` and ``-colors.txt``.  The JAX
CLI's refusals (``--active --hastings``; with ``--resident``: other
colorers, ``--lubygpu`` on a mesh, ``--active`` with checkpoints or
``--chains`` without a mesh, ``--dbg``, ``--anneal`` without a mesh) exit
2 with its messages.

Run ``python -m mcmc_colorer_tpu_torch.cli --help``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from mcmc_colorer_tpu_torch.config import (
    ColorerKind,
    MCMCParams,
    ProposalKind,
    default_n_colors,
)
from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi
from mcmc_colorer_tpu_torch.graph.io import load_edge_list
from mcmc_colorer_tpu_torch.models.base import check_coloring, colorer_device
from mcmc_colorer_tpu_torch.utils.logging import save_run

_LOGO = r"""
  __  __  ___ __  __  ___    ___     _                      ___ ___ _   _
 |  \/  |/ __|  \/  |/ __|  / __|___| |___ _ _ ___ _ _     / __| _ \ | | |
 | |\/| | (__| |\/| | (__  | (__/ _ \ / _ \ '_/ -_) '_|   | (_ |  _/ |_| |
 |_|  |_|\___|_|  |_|\___|  \___\___/_\___/_| \___|_|      \___|_|  \___/
"""

_CITATION = (
    "Based on: Conte, Grossi, Lanzarotti, Lin, Petrini,\n"
    '"A parallel MCMC algorithm for the Balanced Graph Coloring problem",\n'
    "IAPR TC-15 Workshop on Graph-based Representations (GbR 2019)."
)

# --cite-me output (ArgHandle::citeMe, ArgHandle.cpp:341-353)
_BIBTEX = """\
This work can be cited by adding the following items to your bibliografy:

@inproceedings{colorerGbR2019,
	author    = {Conte, Donatello and Grossi, Giuliano and Lanzarotti, Raffaella and Lin, Jianyi and Petrini, Alessandro},
	title     = {A parallel MCMC algorithm for the Balanced Graph Coloring problem},
	booktitle = {IAPR International workshop on Graph-Based Representation in Pattern Recognition, Tours, France},
	year      = {2019},
	month     = {Jul},
	day       = {19-21}
}
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mcmc-colorer-torch",
        description="Balanced graph coloring framework on PyTorch/CUDA.",
        epilog=_CITATION,
    )
    ds = p.add_argument_group("Dataset")
    ds.add_argument("-g", "--graph", metavar="file.txt", help="input edge list")
    ds.add_argument("-o", "--outDir", dest="out_dir", help="output directory")
    ds.add_argument(
        "-s",
        "--simulate",
        type=float,
        metavar="P",
        help="simulate an Erdős–Rényi graph with edge probability P",
    )
    ds.add_argument("-n", "--nodes", type=int, default=0, help="node count")
    alg = p.add_argument_group("Coloring algorithm")
    alg.add_argument("--mcmccpu", "-1", action="store_true", help="sequential MCMC")
    alg.add_argument("--mcmcgpu", "-2", action="store_true", help="parallel MCMC")
    alg.add_argument("--lubygpu", "-3", action="store_true", help="Luby MIS")
    alg.add_argument("--grdffgpu", "-4", action="store_true", help="Greedy FF")
    alg.add_argument("--vffgpu", "-5", action="store_true", help="GFF + VFF rebalance")
    alg.add_argument(
        "--greedycpu",
        action="store_true",
        help="sequential degree-sorted greedy first-fit (the reference's "
        "ColoringGreedyCPU, colorer.cpp:135-208 — not CLI-reachable there)",
    )
    mc = p.add_argument_group("Coloring options (MCMC)")
    mc.add_argument("-k", "--nCol", dest="n_col", type=int, default=0)
    mc.add_argument(
        "-r", "--numColRatio", dest="num_col_ratio", type=float, default=1.0
    )
    # the reference spells the flag singular (ArgHandle.cpp:46); both
    # spellings are accepted so its command lines run unmodified
    mc.add_argument(
        "-t",
        "--tabooIteration",
        "--tabooIterations",
        dest="taboo_iterations",
        type=int,
        default=0,
    )
    mc.add_argument("-l", "--tailcut", action="store_true")
    mc.add_argument(
        "--proposal",
        choices=[k.value for k in ProposalKind],
        default=ProposalKind.BALANCE_DYNAMIC.value,
        help="MCMC proposal variant (reference default: balance_dynamic)",
    )
    mc.add_argument(
        "--hastings",
        action="store_true",
        help="enable Metropolis-Hastings acceptance (off in the reference)",
    )
    mc.add_argument(
        "--seq-stall-escape",
        action="store_true",
        help="back the sequential tailcut with the reference's intended "
        "unlock_stall (random re-color on a no-progress pass); default "
        "off = faithful stall semantics",
    )
    gen = p.add_argument_group("General")
    gen.add_argument("-R", "--repet", type=int, default=1)
    gen.add_argument(
        "-S", "--seed", type=int, default=None, help="RNG seed (default: time)"
    )
    gen.add_argument(
        "-v",
        "--verbose-level",
        dest="verbose_level",
        type=int,
        default=0,
        help="0-3 (clamped); >=1 enables TRACE output, like switching "
        "TRACE ENABLE in logger.conf (ArgHandle.cpp:51,217)",
    )
    gen.add_argument(
        "-M",
        "--cite-me",
        dest="cite_me",
        action="store_true",
        help="print the BibTeX entry and exit (ArgHandle.cpp:341)",
    )
    gen.add_argument(
        "--dbg",
        action="store_true",
        help="interactive debugger of the parallel MCMC chain (ESC breaks "
        "in at a segment boundary; reference src/utils/dbg.cpp)",
    )
    gen.add_argument(
        "--device",
        default="cuda",
        help="device of the device colorers: 'cuda' (default, the current "
        "card; refused without one) or 'cpu' (their plain versions)",
    )
    dev = p.add_argument_group("Device scaling (no reference counterpart)")
    dev.add_argument("--chains", type=int, default=1, help="independent chains (ensemble)")
    dev.add_argument("--mesh-chains", type=int, default=0,
                     help="chains axis of the rank mesh (start ranks with torchrun)")
    dev.add_argument("--mesh-shards", type=int, default=0,
                     help="shards axis of the rank mesh (start ranks with torchrun)")
    dev.add_argument(
        "--backend",
        choices=["auto", "pallas", "xla", "matmul", "packed"],
        default="auto",
        help="device backend: 'pallas' = the hand-written kernels (auto), "
        "'xla' = their plain PyTorch versions; 'matmul'/'packed' = the "
        "full-sweep MCMC over a bit-packed adjacency (K1)",
    )
    dev.add_argument(
        "--layout",
        choices=["flat", "bucketed"],
        default="flat",
        help="ELL device layout of the device colorers: 'bucketed' groups "
        "vertices by degree class (10-100x less gather volume on "
        "skewed-degree graphs)",
    )
    dev.add_argument(
        "--anneal", action="store_true",
        help="pooled epsilon annealing (the sharded colorer's routes)"
    )
    dev.add_argument(
        "--resident",
        action="store_true",
        help="with --simulate: define the ER graph as a stateless hash "
        "and materialise the bit-packed adjacency ON the device (zero "
        "bytes uploaded; models/mcmc_resident.py).  --mcmcgpu and/or "
        "--lubygpu; --check re-derives the identical graph host-side",
    )
    dev.add_argument(
        "--ckpt", metavar="PATH",
        help="write a chain checkpoint at every segment boundary (the resident colorer "
        "and the stepped chain)",
    )
    dev.add_argument("--resume", metavar="PATH", help="resume a chain from a checkpoint")
    dev.add_argument(
        "--active",
        action="store_true",
        help="frontier mode: the MCMC chain resamples only the conflict "
        "frontier; Luby/GFF/VFF gather only candidate/uncolored rows",
    )
    p.add_argument("--check", action="store_true", help="validate colorings")
    p.add_argument("--quiet", action="store_true")
    return p


def _refuse(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(2)


def _check_refusals(args) -> None:
    """Refuse the combinations the JAX CLI refuses, with its messages,
    before any device work."""
    if args.mcmcgpu and args.active and args.hastings:
        # the frontier sweep never forms the passive set's proposal
        # probability, so the Hastings ratio is undefined there
        _refuse("--active is incompatible with --hastings: frontier sweeps run the "
                "shipped always-accept dynamics (use full sweeps for acceptance).")
    if args.resident:
        _check_resident_args(args)


def _on_mesh(args) -> bool:
    return bool(args.mesh_chains or args.mesh_shards)


def _sharded_route(args) -> bool:
    """The MCMC routes that run ``ShardedMCMCColorer``: a mesh (over a host
    graph or, with ``--resident``, the hash strips), or a frontier
    ensemble (JAX runs those on a 1x1 mesh, cli.py:386-411)."""
    return _on_mesh(args) or (args.active and args.chains > 1)


def _make_mesh(args, device):
    """The rank mesh of ``--mesh-chains``/``--mesh-shards`` (joining the
    ranks ``torchrun`` started), or a 1x1 mesh for a frontier ensemble;
    exits 2 when the mesh does not match the world."""
    import torch

    from mcmc_colorer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    mesh_dev = "cpu" if device.type == "cpu" else None  # None: this rank's card
    if not _on_mesh(args):
        return make_mesh(1, 1, device=device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_distributed()
    try:
        mesh = make_mesh(args.mesh_chains or None, args.mesh_shards or None, device=mesh_dev)
    except ValueError as e:
        _refuse(f"--mesh-chains {args.mesh_chains} --mesh-shards {args.mesh_shards}: {e}")
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def _load_graph(args, seed: int) -> tuple[Graph, float | None]:
    if args.graph:
        g = load_edge_list(args.graph)
        return g, None
    if args.simulate is None:
        print(
            "Either --graph or --simulate must be given (see --help).",
            file=sys.stderr,
        )
        sys.exit(2)
    if not (0.0 < args.simulate < 1.0):
        print("Simulation: P must be 0 < P < 1.", file=sys.stderr)
        sys.exit(2)
    if args.nodes <= 0:
        print("Simulation: -n N (positive) is mandatory.", file=sys.stderr)
        sys.exit(2)
    g = erdos_renyi(args.nodes, args.simulate, seed=seed)
    return g, args.simulate


def _algos(args) -> list[ColorerKind]:
    sel = []
    if args.mcmccpu:
        sel.append(ColorerKind.MCMC_SEQ)
    if args.mcmcgpu:
        sel.append(ColorerKind.MCMC)
    if args.lubygpu:
        sel.append(ColorerKind.LUBY)
    if args.grdffgpu:
        sel.append(ColorerKind.GREEDY_FF)
    if args.vffgpu:
        sel.append(ColorerKind.VFF)
    if args.greedycpu:
        sel.append(ColorerKind.GREEDY_SEQ)
    if not sel:
        # reference default: MCMC CPU (ArgHandle.cpp:247-249)
        print(
            "No colorer selected: defaulting to sequential MCMC (--mcmccpu).",
            file=sys.stderr,
        )
        sel.append(ColorerKind.MCMC_SEQ)
    return sel


_ALGO_TAG = {
    ColorerKind.MCMC_SEQ: "MCMC_CPU",
    ColorerKind.MCMC: "MCMC_GPU",
    ColorerKind.LUBY: "LUBY",
    ColorerKind.GREEDY_FF: "GFF",
    ColorerKind.VFF: "VFF",
    ColorerKind.GREEDY_SEQ: "GREEDY_CPU",
}


def _check_resident_args(args) -> None:
    """--resident is the zero-upload hash-graph path (JAX
    ``_check_resident_args``): full-sweep or frontier --mcmcgpu (one
    chain, an ensemble, or a mesh) and/or the matmul Luby loop (--lubygpu,
    no mesh) over a --simulate graph."""
    if args.graph or args.simulate is None:
        print("--resident requires --simulate (it IS the generator).",
              file=sys.stderr)
        sys.exit(2)
    on_mesh = _on_mesh(args)
    others = (
        args.mcmccpu or args.grdffgpu or args.vffgpu
        or args.greedycpu or not (args.mcmcgpu or args.lubygpu)
    )
    if others or (args.lubygpu and on_mesh):
        print(
            "--resident runs the NC-native colorers only: --mcmcgpu "
            "(any driver) and/or --lubygpu (no mesh); other colorers "
            "gather neighbor lists, which the resident graph never "
            "materialises.",
            file=sys.stderr,
        )
        sys.exit(2)
    if args.active and (args.ckpt or args.resume) and not on_mesh:
        _refuse("--resident --active does not checkpoint (the frontier loop's cnt "
                "re-derives from colors); drop --ckpt/--resume or use full sweeps.")
    if args.active and args.chains > 1 and not on_mesh:
        _refuse("--resident --active is single-chain (or mesh): drop --chains or add "
                "--mesh-shards.")
    for flag, on in (("--dbg", args.dbg),
                     ("--anneal without a mesh", args.anneal and not on_mesh)):
        if on:
            _refuse(f"--resident is incompatible with {flag}.")
    if _resident_ell_route(args):
        for flag, on in (("--layout bucketed", args.layout != "flat"),
                         ("--active", args.active), ("--chains", args.chains > 1)):
            if on:
                _refuse(f"--resident --backend {args.backend} past the packed adjacency's cap "
                        f"runs one chain of full sweeps over one flat ELL; drop {flag}.")
    elif args.backend not in ("auto", "matmul", "packed"):
        print(
            f"--resident implies the packed-MXU backend; ignoring "
            f"--backend {args.backend}.",
            file=sys.stderr,
        )


def _resident_ell_route(args) -> bool:
    """``--resident --mcmcgpu --backend pallas|xla`` (no mesh) on a graph
    whose packed adjacency does not fit (``ResidentMCMCColorer``'s cap):
    ``MCMCColorer`` over a ``HashGraph``, whose flat ELL kernel K5 builds
    on the device from the hash definition."""
    from mcmc_colorer_tpu_torch.models.mcmc_resident import packed_adj_fits

    return bool(args.resident and args.mcmcgpu and args.backend in ("pallas", "xla")
                and not _on_mesh(args) and not packed_adj_fits(args.nodes))


def _device_backend(args) -> str:
    """Backend of the colorers without a full-sweep NC (GreedyFF, VFF,
    the frontier chain): matmul/packed feed only the full-sweep chain."""
    if args.backend in ("matmul", "packed"):
        print(
            f"--backend {args.backend} applies to full-sweep MCMC colorers only; "
            "using 'auto' here.",
            file=sys.stderr,
        )
        return "auto"
    return args.backend


def _make_colorer(kind: ColorerKind, g: Graph, args, params: MCMCParams, device, mesh=None):
    if kind == ColorerKind.MCMC_SEQ:
        from mcmc_colorer_tpu_torch.models.mcmc_sequential import SequentialMCMCColorer

        return SequentialMCMCColorer(g, params)
    if kind == ColorerKind.MCMC and mesh is not None:
        from mcmc_colorer_tpu_torch.parallel.sharded import AnnealConfig, ShardedMCMCColorer

        # frontier capacity: per chain, resample at most ~n/8 vertices
        # once the conflict set fits (rounded up to 128 by the colorer)
        active_cap = max(128, g.n // 8) if args.active else None
        return _BestOfWrapper(ShardedMCMCColorer(
            g, params, mesh, n_chains=max(args.chains, mesh.chains),
            anneal=AnnealConfig(enabled=args.anneal), active_cap=active_cap,
            backend=args.backend))
    if kind == ColorerKind.MCMC and args.chains > 1:
        from mcmc_colorer_tpu_torch.parallel.chains import EnsembleMCMCColorer

        return _BestOfWrapper(EnsembleMCMCColorer(g, params, n_chains=args.chains,
                                                  backend=args.backend, layout=args.layout,
                                                  device=device))
    if kind == ColorerKind.MCMC and args.dbg:
        # the debugger needs the host-visible segment loop: the stepped chain
        from mcmc_colorer_tpu_torch.models.chain_api import SteppedMCMC
        from mcmc_colorer_tpu_torch.utils.dbg import DebugAttach

        return _DbgWrapper(SteppedMCMC(g, params, backend=_device_backend(args),
                                       layout=args.layout, device=device), DebugAttach())
    if kind == ColorerKind.MCMC and args.active:
        from mcmc_colorer_tpu_torch.models.mcmc_active import ActiveMCMCColorer

        return ActiveMCMCColorer(g, params, backend=_device_backend(args), layout=args.layout,
                                 device=device)
    if kind == ColorerKind.MCMC:
        from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

        return MCMCColorer(g, params, backend=args.backend, layout=args.layout, device=device)
    if kind == ColorerKind.LUBY:
        from mcmc_colorer_tpu_torch.models.luby import LubyColorer

        return LubyColorer(g, active=args.active, layout=args.layout, device=device)
    if kind == ColorerKind.GREEDY_FF:
        from mcmc_colorer_tpu_torch.models.greedy_ff import GreedyFFColorer

        return GreedyFFColorer(
            g, backend=_device_backend(args), active=args.active, layout=args.layout,
            device=device,
        )
    if kind == ColorerKind.VFF:
        from mcmc_colorer_tpu_torch.models.vff import VFFColorer

        return VFFColorer(
            g, backend=_device_backend(args), active=args.active, layout=args.layout,
            device=device,
        )
    if kind == ColorerKind.GREEDY_SEQ:
        from mcmc_colorer_tpu_torch.models.greedy_seq import SequentialGreedyColorer

        return SequentialGreedyColorer(g)
    raise ValueError(kind)


class _DbgWrapper:
    """Adapts SteppedMCMC + DebugAttach to the single-result interface."""

    def __init__(self, inner, dbg):
        self.inner = inner
        self.dbg = dbg

    def run(self, seed, repetition=0, **kw):
        return self.inner.run(seed, repetition, dbg=self.dbg, **kw)


class _BestOfWrapper:
    """Adapts an ensemble (returning (best, summaries)) to the
    single-result interface."""

    def __init__(self, inner):
        self.inner = inner

    def run(self, seed, repetition=0, **kw):
        best, _summaries = self.inner.run(seed, repetition, **kw)
        return best


def _checkpoint_kwargs(colorer, args, tag: str, rep: int) -> dict:
    """``--ckpt``/``--resume`` for one run, as the JAX CLI hands them
    over (cli.py:676-700): only targets with ``save_checkpoint`` take them;
    for any other ``--resume`` exits 2 and ``--ckpt`` is ignored."""
    run_kw = {}
    if not (args.ckpt or args.resume):
        return run_kw
    if hasattr(getattr(colorer, "inner", colorer), "save_checkpoint"):
        if args.ckpt:
            run_kw["checkpoint_path"] = args.ckpt
        if args.resume and rep == 0:
            run_kw["resume_from"] = args.resume
    elif args.resume:
        # silently re-running from iteration 0 would let an operator
        # believe they resumed
        print(f"--resume: {tag} does not support checkpointing; refusing to restart "
              "silently.", file=sys.stderr)
        sys.exit(2)
    else:
        print(f"--ckpt ignored: {tag} does not support checkpointing "
              "(the resident, sharded and stepped colorers do).", file=sys.stderr)
    return run_kw


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cite_me:
        # print the BibTeX entry and exit (ArgHandle.cpp:230-232)
        print(_BIBTEX)
        return 0
    # --verbose-level: clamp to 0..3 with the reference's warnings
    # (ArgHandle.cpp:278-286); >=1 turns the TRACE gate on
    if args.verbose_level > 3:
        print("verbose-level higher than 3.", file=sys.stderr)
        args.verbose_level = 3
    if args.verbose_level < 0:
        print("verbose-level lower than 0.", file=sys.stderr)
        args.verbose_level = 0
    if args.verbose_level >= 1:
        os.environ["MCMC_COLORER_TRACE"] = "1"
    _check_refusals(args)
    try:
        device = colorer_device(args.device)
    except RuntimeError as e:  # no card: refuse, never run on the CPU instead
        _refuse(f"--device {args.device}: {e}")
    mesh = _make_mesh(args, device) if args.mcmcgpu and _sharded_route(args) else None
    if mesh is not None and mesh.rank != 0:
        args.quiet = True  # rank 0 alone prints and writes the run's files
    if not args.quiet:
        print(_LOGO)
        print(_CITATION)
        print()
    # seed drawn ONCE and used for both the simulated graph and the chains
    # (the reference seeds once, ArgHandle.cpp:272-276)
    seed = args.seed if args.seed is not None else int(time.time())
    ratio = min(16.0, max(1.0, args.num_col_ratio))
    resident = None
    resident_luby = None
    if args.resident:
        if not (0.0 < args.simulate < 1.0) or args.nodes <= 0:
            print("Simulation: need 0 < P < 1 and -n N > 0.",
                  file=sys.stderr)
            sys.exit(2)
        template = MCMCParams(
            n_colors=args.n_col or 0,
            taboo_iterations=args.taboo_iterations,
            tailcut=args.tailcut,
            proposal=ProposalKind(args.proposal),
            hastings=args.hastings,
            seq_stall_escape=args.seq_stall_escape,
        )
        if args.lubygpu:
            # NC-native Luby over the same hash graph (models/luby.py)
            from mcmc_colorer_tpu_torch.models.luby import LubyColorer

            resident_luby = LubyColorer(
                None, resident_spec=(args.nodes, args.simulate, seed), device=device
            )
        prob = args.simulate
        if not args.mcmcgpu:
            # Luby-only resident run: no MCMC palette to resolve
            g = resident_luby.host_graph() if args.check else resident_luby.graph
            params = template.replace(
                n_colors=args.n_col or default_n_colors(g.max_degree, ratio)
            )
        elif _resident_ell_route(args):
            # the hash graph's flat ELL built on the device by kernel K5 (no
            # packed A, no host sampling); --check enumerates it host-side
            from mcmc_colorer_tpu_torch.graph.container import HashGraph
            from mcmc_colorer_tpu_torch.models.mcmc import MCMCColorer

            t0 = time.perf_counter()
            hg = HashGraph(args.nodes, args.simulate, seed, device=device)
            params = template.replace(
                n_colors=args.n_col or default_n_colors(hg.max_degree, ratio)
            )
            resident = MCMCColorer(hg, params, backend=args.backend, device=device)
            if not args.quiet:
                print(
                    f"Resident ELL built on {device} in {time.perf_counter() - t0:.1f}s "
                    f"(zero bytes uploaded)."
                )
            g = hg.host_graph() if args.check else hg
        elif mesh is not None:
            # zero-upload sharded run: every rank hash-generates its own
            # strip of the packed adjacency (parallel/sharded.py)
            from mcmc_colorer_tpu_torch.parallel.sharded import AnnealConfig, ShardedMCMCColorer

            inner = ShardedMCMCColorer(
                None, template, mesh, n_chains=max(args.chains, mesh.chains),
                anneal=AnnealConfig(enabled=args.anneal),
                resident_spec=(args.nodes, args.simulate, seed), num_col_ratio=ratio,
                active_cap=max(128, args.nodes // 8) if args.active else None,
            )
            resident = _BestOfWrapper(inner)
            if not args.quiet:
                print(f"Resident strips materialised per shard ({mesh.chains}x{mesh.shards} "
                      f"mesh, zero bytes uploaded).")
            # rank 0 alone checks the colouring against the host graph
            g = inner.host_graph() if args.check and mesh.rank == 0 else inner.graph
            params = inner.params
        else:
            from mcmc_colorer_tpu_torch.models.mcmc_resident import ResidentMCMCColorer

            resident = ResidentMCMCColorer(
                args.nodes,
                args.simulate,
                graph_seed=seed,
                params=template,
                num_col_ratio=ratio,
                n_chains=max(1, args.chains),
                active=args.active,
                device=device,
            )
            if not args.quiet:
                print(
                    f"Resident graph materialised on device in "
                    f"{resident.gen_seconds:.1f}s (zero bytes uploaded)."
                )
            # --check re-derives the identical graph host-side (threaded
            # C++ hash enumeration) so validation runs against real
            # edges; plain runs use the cheap stats view
            g = resident.host_graph() if args.check else resident.stats_graph()
            params = resident.params
        n_col = params.n_colors
    else:
        g, prob = _load_graph(args, seed)
        n_col = args.n_col or default_n_colors(g.max_degree, ratio)
        params = MCMCParams(
            n_colors=n_col,
            taboo_iterations=args.taboo_iterations,
            tailcut=args.tailcut,
            proposal=ProposalKind(args.proposal),
            hastings=args.hastings,
            seq_stall_escape=args.seq_stall_escape,
        )
    graph_name = (
        g.name
        if args.graph
        else f"{args.nodes}_{args.simulate}_{ratio}"
    )
    out_dir = args.out_dir or f"{graph_name}_out"
    if not args.quiet:
        print(
            f"Graph: {graph_name} — n={g.n} m={g.n_edges} "
            f"maxDeg={g.max_degree} meanDeg={g.mean_degree:.2f}"
        )
        print(f"Colors: {n_col} (ratio {ratio}) — seed {seed} — device {device}")

    from mcmc_colorer_tpu_torch.utils import term

    rc = 0
    for kind in _algos(args):
        if resident is not None and kind == ColorerKind.MCMC:
            colorer = resident
        elif resident_luby is not None and kind == ColorerKind.LUBY:
            colorer = resident_luby
        else:
            colorer = _make_colorer(kind, g, args, params, device, mesh)
        tag = _ALGO_TAG[kind]
        for rep in range(args.repet):
            result = colorer.run(seed, repetition=rep,
                                 **_checkpoint_kwargs(colorer, args, tag, rep))
            if mesh is not None and mesh.rank != 0:
                continue  # every rank holds the same result
            log_path, _ = save_run(
                out_dir,
                graph_name,
                tag,
                rep,
                g,
                result,
                seed=seed,
                prob=prob,
                num_color_ratio=ratio,
            )
            valid = (
                check_coloring(g, result.colors) if args.check else None
            )
            if args.check and not valid:
                rc = 1
            if not args.quiet:
                extra = (
                    ""
                    if valid is None
                    else (" — VALID" if valid else " — INVALID!")
                )
                print(
                    f"{tag} rep {rep}: colors used "
                    f"{len(np.unique(result.colors))}/{result.n_colors}, "
                    f"iterations {result.iterations}, "
                    f"{result.duration_ms:.0f} ms, "
                    f"converged={result.converged}{extra} → {log_path}"
                )
            # TRACE-gated per-iteration + histogram output (the reference's
            # LOG(TRACE) / PRINTHISTOGRAM prints, coloringMCMC_prints.cu)
            if term.trace_enabled():
                if result.conflict_trace is not None:
                    term.trace(
                        f"{tag} rep {rep} conflict trace: "
                        f"{list(map(int, result.conflict_trace))}"
                    )
                # per-iteration free-color stats (the reference's
                # getStatsFreeColors TRACE lines,
                # coloringMCMC_prints.cu:117-131 / _CPU.cpp:203-207)
                fct = (result.extra or {}).get("free_color_trace")
                if fct is not None:
                    for it, (lo, hi, avg) in enumerate(fct, start=1):
                        term.trace(
                            f"{tag} rep {rep} iter {it}: free colors "
                            f"min {int(lo)} max {int(hi)} avg {avg:.2f}"
                        )
                term.trace(result.ascii_histogram())
    if mesh is not None and mesh.distributed:
        import torch.distributed as dist

        dist.destroy_process_group()
    return rc


def dataset_gen_main(argv=None) -> int:
    """``datasetGen`` equivalent (datasetGenerator.cpp:21-24):
    ``dataset-gen-torch nNodes prob outFile [seed]``."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print("Usage: dataset-gen nNodes prob outFile [seed]", file=sys.stderr)
        return 2
    n, prob, out = int(argv[0]), float(argv[1]), argv[2]
    seed = int(argv[3]) if len(argv) > 3 else 10000  # fixed default seed,
    # like the reference (datasetGenerator.cpp:39)
    from mcmc_colorer_tpu_torch.graph import native

    m = native.generate_dataset(out, n, prob, seed=seed)
    print(f"Wrote {out}: {n} nodes, {m} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
