"""Edge-list file I/O and dataset converters (host only).

Counterpart of ``mcmc_colorer_tpu/graph/io.py``.  The file contract: one
throwaway header line, then whitespace- or comma-separated
``src dst [weight]`` lines with string node ids mapped to dense ints in
first-seen order.  Each undirected edge is stored once; the loader adds
the reverse edge and drops self-loops.  Duplicate edges are kept.

``load_edge_list`` is the C++ importer (``graph/native.py``);
``load_edge_list_py`` is the pure-Python importer, kept as its oracle.
"""

from __future__ import annotations

import os

import numpy as np

from mcmc_colorer_tpu_torch.graph.container import Graph
from mcmc_colorer_tpu_torch.graph.generate import random_node_names


def _split_line(line: str) -> list[str]:
    line = line.strip()
    if "," in line:
        return [t for t in line.replace(",", " ").split() if t]
    return line.split()


def load_edge_list(path: str, name: str | None = None) -> Graph:
    """C++ two-pass streaming import with string -> dense-int id mapping."""
    from mcmc_colorer_tpu_torch.graph import native

    return native.load_edge_list(path, name=name)


def load_edge_list_py(path: str, name: str | None = None) -> Graph:
    """Pure-Python importer (the oracle of the native path)."""
    id_of: dict[str, int] = {}
    names: list[str] = []
    srcs: list[int] = []
    dsts: list[int] = []
    with open(path) as f:
        f.readline()  # one header line, skipped
        for line in f:
            toks = _split_line(line)
            if len(toks) < 2:
                continue
            ids = []
            for t in toks[:2]:
                i = id_of.get(t)
                if i is None:
                    i = id_of[t] = len(names)
                    names.append(t)
                ids.append(i)
            srcs.append(ids[0])
            dsts.append(ids[1])
    return Graph.from_edges(
        len(names),
        np.asarray(srcs, dtype=np.int64),
        np.asarray(dsts, dtype=np.int64),
        node_names=names,
        name=name or os.path.basename(path).rsplit(".", 1)[0],
    )


def write_edge_list(
    g: Graph,
    path: str,
    *,
    use_names: bool = True,
    weight: float | None = 0.1,
    rng: np.random.Generator | None = None,
) -> None:
    """Write the native format: header ``nNodes nEdges`` then one
    ``src dst weight`` line per undirected edge."""
    names = g.node_names if (use_names and g.node_names) else None
    with open(path, "w") as f:
        f.write(f"{g.n}\t{g.n_edges}\n")
        u = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
        v = g.cols.astype(np.int64)
        mask = u < v  # each undirected edge once
        us, vs = u[mask], v[mask]
        if rng is not None:
            w = rng.random(us.shape[0])
        else:
            w = np.full(us.shape[0], 0.1 if weight is None else weight)
        for a, b, ww in zip(us, vs, w):
            sa = names[a] if names else str(int(a))
            sb = names[b] if names else str(int(b))
            f.write(f"{sa}\t{sb}\t{ww:g}\n")


def generate_dataset(
    n: int, p: float, out_path: str, seed: int = 10000, named_nodes: bool = True
) -> Graph:
    """``datasetGen`` equivalent: sample ER(n, p), give the nodes random
    12-character names, write the native format."""
    from mcmc_colorer_tpu_torch.graph.generate import erdos_renyi

    g = erdos_renyi(n, p, seed=seed)
    if named_nodes:
        g.node_names = random_node_names(n, np.random.default_rng(seed))
    write_edge_list(g, out_path, rng=np.random.default_rng(seed))
    return g


# -- converters (counterparts of the reference's pyScripts) ------------------


def convert_network_repository(in_path: str, out_path: str) -> None:
    """networkrepository.com format -> native format: skip the header,
    keep a counts line, normalise to 3 columns (weight 0.1 when absent)."""
    with open(in_path) as fin, open(out_path, "w") as fout:
        fin.readline()  # header
        nums = [int(t) for t in fin.readline().split() if t.lstrip("-").isdigit()]
        n_nodes, n_edges = (min(nums), max(nums)) if nums else (0, 0)
        fout.write(f"{n_nodes} {n_edges}\n")
        for line in fin:
            toks = _split_line(line)
            if len(toks) == 2:
                fout.write(f"{toks[0]} {toks[1]} 0.1\n")
            elif len(toks) >= 3:
                fout.write(" ".join(toks[:3]) + "\n")


def convert_reddit_csv(in_path: str, out_path: str, every_other_line: bool = False) -> None:
    """Reddit CSV edge list -> native format; ``every_other_line`` keeps
    the reference script's skip of every second input line."""
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            toks = line.strip().split(",")
            if len(toks) >= 2:
                fout.write(f"{toks[0]} {toks[1]} 0.1\n")
            if every_other_line:
                fin.readline()


def strip_self_arcs(in_path: str, out_path: str) -> int:
    """Remove self-loop lines (the header is kept); returns how many."""
    cnt = 0
    with open(in_path) as fin, open(out_path, "w") as fout:
        fout.write(fin.readline())
        for line in fin:
            toks = _split_line(line)
            if len(toks) >= 2 and toks[0] == toks[1]:
                cnt += 1
            else:
                fout.write(line)
    return cnt


def write_colors(path: str, colors: np.ndarray) -> None:
    """Write the ``nodeIdx color`` assignment file."""
    with open(path, "w") as f:
        for i, c in enumerate(np.asarray(colors)):
            f.write(f"{i} {int(c)}\n")
