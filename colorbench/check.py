"""The comparison that decides ``correct``: every job's colouring judged
against the plain reference (``reference/``), after the window.

Numbers compared, each with its limit (the exact ones with the limit 0):

- ``unfinished_jobs``: jobs that returned conflicts (no valid colouring
  came);
- ``conflict_edges``: the most edges, over the jobs checked, whose ends
  share a colour in the reference's graph;
- ``off_palette``: the most vertices, over the jobs checked, whose colour
  lies outside the palette the configuration states, from the
  reference's max degree;
- ``graph_errors``: where the program's graph differs from the
  reference's: wrong bits of its packed A and vertices whose degree
  differs (the hash graph), rows whose neighbour set differs (the ELL);
- ``exact_mismatch`` (deterministic colourers only): the most vertices,
  over their jobs, whose colour differs from the reference's colouring;
- ``balance_r<ratio>`` (the chain's colourers, whose drivers say
  ``BALANCED``, at each numColRatio for which the configuration states a
  ``balance_limit``): the largest balance index, over the jobs checked
  at that ratio, of the reference's formula over the reference's
  palette; its limit was set from sound runs and the ``skip_chain``
  fault on the card.

The graph is the configuration's family's (``families/<family>.py``),
its edges derived again by the reference; the program's graph is judged
by the kind its driver reports (``reference/state_<kind>.py``).

Jobs checked: every job where the run reuses one graph; where each job
has its own graph, a sample drawn from the seed (the last job always in
it), since the reference derives each graph again.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from colorbench import seeds, spec
from colorbench.reference import er_edges, hashgraph, quality

PER_JOB_GRAPH_SAMPLE = 4


@dataclass
class Number:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class RefGraph:
    src: object      # int32 tensor on the judge's device
    dst: object
    degrees: np.ndarray
    max_degree: int


def _ref_graph(run, gseed: int, device) -> RefGraph:
    cfg = run.config
    src, dst = spec.family(cfg["family"]).reference_edges(cfg, run.graphs[gseed], device)
    deg = hashgraph.degrees(src, dst, cfg["n"]).cpu().numpy()
    return RefGraph(src, dst, deg, int(deg.max(initial=0)))


def _ratio_name(ratio) -> str:
    return f"{ratio:g}"


def judge(run, device) -> tuple[list[Number], int]:
    """(the numbers compared, the jobs checked)."""
    import torch

    cfg, jobs = run.config, run.jobs
    n = cfg["n"]
    unfinished = sum(1 for j in jobs if j.result["conflicts"] != 0)
    if run.cell.traffic["graph"] == "per_job" and jobs:
        rng = np.random.default_rng(seeds.sample_seed(run.seed))
        pick = set(rng.choice(len(jobs) - 1, size=min(PER_JOB_GRAPH_SAMPLE - 1, len(jobs) - 1),
                              replace=False).tolist()) if len(jobs) > 1 else set()
        checked = [j for j in jobs if j.index in pick] + [jobs[-1]]
    else:
        checked = list(jobs)
    states = {}
    for gseed, kind, t in run.graph_state:
        states.setdefault(gseed, []).append((kind, t))
    conflicts = off = graph_err = exact = 0
    jobs_of = run.cell.traffic["jobs"]
    exact_of = {j["colorer"]: spec.exact_reference(j["colorer"]) for j in jobs_of}
    limits = cfg.get("balance_limit", {})
    balanced = {j["colorer"]: spec.driver(cfg["path"], j["colorer"]).BALANCED for j in jobs_of}
    ratios = sorted({j.get("num_col_ratio", 1) for j in jobs_of
                     if balanced[j["colorer"]] and _ratio_name(j.get("num_col_ratio", 1)) in limits})
    balance = {r: 0.0 for r in ratios}
    exact_refs: dict = {}
    for gseed in sorted({j.graph_seed for j in checked}):
        ref = _ref_graph(run, gseed, device)
        for kind, t in states.get(gseed, []):
            graph_err += spec.state_check(kind).errors(t, ref.src, ref.dst, n)
        for j in (j for j in checked if j.graph_seed == gseed):
            res, colorer = j.result, j.spec["colorer"]
            if "degrees" in res:
                graph_err += int((np.asarray(res["degrees"])[:n] != ref.degrees).sum())
            c = res["colors"]
            if res["conflicts"] == 0:
                ct = torch.from_numpy(c).to(device)
                conflicts = max(conflicts, quality.conflict_edges(ct, ref.src, ref.dst))
            ratio = j.spec.get("num_col_ratio", 1)
            pal = quality.palette(colorer, ref.max_degree, ratio)
            off = max(off, quality.off_palette(c, pal))
            if ratio in balance and balanced[colorer]:
                balance[ratio] = max(balance[ratio], quality.balance_index(c, pal, cfg["p"]))
            ex = exact_of[colorer]
            if ex is not None:
                key = (gseed, colorer)
                if key not in exact_refs:
                    rp, cols = er_edges.csr(n, ref.src.cpu().numpy(), ref.dst.cpu().numpy())
                    exact_refs[key] = ex.expected(rp, cols)
                exact = max(exact, int((c != exact_refs[key]).sum()))
        del ref
    out = [Number("unfinished_jobs", unfinished, 0), Number("conflict_edges", conflicts, 0),
           Number("off_palette", off, 0), Number("graph_errors", graph_err, 0)]
    if any(exact_of.values()):
        out.append(Number("exact_mismatch", exact, 0))
    for r in ratios:
        out.append(Number(f"balance_r{_ratio_name(r)}", balance[r],
                          limits[_ratio_name(r)]))
    return out, len(checked)
