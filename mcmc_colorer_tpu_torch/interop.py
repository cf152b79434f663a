"""State carried between the JAX package and the port, as numpy arrays.

- The packed adjacency: JAX holds uint32 words, the port int32 words
  with the same bit patterns (``adjacency_from_jax`` / ``adjacency_to_jax``).
- The chain carry: the fields a JAX resident checkpoint holds
  (``models/mcmc_resident.py:save_checkpoint``: colors, taboo,
  iteration, conf_last, trace, done) become the port's ``ChainState``
  at C = 1 and back; with a leading chain axis (a batched resident
  carry), a ``ChainState`` of C chains (``chains_from_numpy`` /
  ``chains_to_numpy``).  JAX's
  stepped ``ChainState`` (colors, taboo, iteration, conflicts) becomes
  the port's stepped one and back (``stepped_from_numpy`` /
  ``stepped_to_numpy``).  The key is left out: the port draws from its
  own source, whose generator state the caller gives.
- Host graphs and ELL layouts: a JAX ``Graph`` becomes the port's
  (``graph_from_jax``, a copy of the CSR); an ``EllGraph`` of either
  package reads back as numpy (``ell_to_numpy``); a degree-bucketed
  layout of either package reads back as numpy (``bucketed_to_numpy``),
  and a JAX one becomes the port's (``bucketed_from_jax``), so both sides
  can run on one layout.
- The sharded ensemble: JAX's sharded state (a JAX checkpoint's fields)
  becomes the port's on any mesh (``sharded_state_from_numpy``), so a JAX
  segment can be resumed by the port.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_colorer_tpu_torch.graph.container import BucketedEll, EllSlice, Graph
from mcmc_colorer_tpu_torch.models.mcmc import ChainState


def adjacency_from_jax(packed: np.ndarray, device="cpu") -> torch.Tensor:
    """[n_pad, words] uint32 -> int32 tensor of the same bits."""
    packed = np.ascontiguousarray(packed)
    if packed.dtype != np.uint32 or packed.ndim != 2:
        raise TypeError(f"expected 2-D uint32, got {packed.dtype} {packed.shape}")
    return torch.from_numpy(packed.view(np.int32).copy()).to(device)


def adjacency_to_jax(adj: torch.Tensor) -> np.ndarray:
    """int32 tensor -> [n_pad, words] uint32 numpy array of the same bits."""
    if adj.dtype != torch.int32 or adj.dim() != 2:
        raise TypeError(f"expected 2-D int32, got {adj.dtype} {tuple(adj.shape)}")
    return adj.cpu().numpy().view(np.uint32)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def chains_from_numpy(colors, taboo, iteration, conf_last, trace, done, device="cpu"):
    """The port's ``ChainState`` from a batched (vmapped) JAX carry's
    fields, each with a leading chain axis."""
    return ChainState(
        colors=_tensor(colors, np.int32, device), taboo=_tensor(taboo, np.int32, device),
        rip=np.array(iteration, dtype=np.int64), conf_last=np.array(conf_last, np.int64),
        trace=np.array(trace, dtype=np.int32), done=np.array(done, dtype=bool),
    )


def chains_to_numpy(state: ChainState) -> dict:
    """The inverse of :func:`chains_from_numpy`, keyed by checkpoint field."""
    return {
        "colors": state.colors.cpu().numpy(), "taboo": state.taboo.cpu().numpy(),
        "iteration": state.rip.astype(np.int32), "conf_last": state.conf_last.astype(np.int32),
        "trace": state.trace.copy(), "done": state.done.copy(),
    }


def carry_from_numpy(colors, taboo, iteration, conf_last, trace, done,
                     device="cpu") -> ChainState:
    """The port's carry of one chain (C = 1) from a JAX single-chain
    carry's (or checkpoint's) fields."""
    fields = (colors, taboo, iteration, conf_last, trace, done)
    return chains_from_numpy(*(np.asarray(x)[None] for x in fields), device=device)


def carry_to_numpy(state: ChainState) -> dict:
    """The inverse of :func:`carry_from_numpy`: JAX's single-chain shapes."""
    return {k: v[0] for k, v in chains_to_numpy(state).items()}


def stepped_from_numpy(colors, taboo, iteration, conflicts, rng, device="cpu"):
    """The port's stepped ``ChainState`` (``models/chain_api.py``) from JAX's
    stepped state's fields; ``rng`` is the generator state to draw from."""
    from mcmc_colorer_tpu_torch.models.chain_api import ChainState as SteppedState

    return SteppedState(colors=_tensor(colors, np.int32, device),
                        taboo=_tensor(taboo, np.int32, device), rng=rng,
                        iteration=int(iteration), conflicts=int(conflicts))


def stepped_to_numpy(state) -> dict:
    """The stepped state's fields JAX's holds too, as numpy."""
    return {"colors": state.colors.cpu().numpy(), "taboo": state.taboo.cpu().numpy(),
            "iteration": np.int32(state.iteration), "conflicts": np.int32(state.conflicts)}


def graph_from_jax(jax_graph) -> Graph:
    """The port's ``Graph`` with a copy of a JAX ``Graph``'s CSR, names
    and name (any object with those fields will do)."""
    names = getattr(jax_graph, "node_names", None)
    return Graph(
        n=int(jax_graph.n),
        row_ptr=np.array(jax_graph.row_ptr, dtype=np.int64),
        cols=np.array(jax_graph.cols, dtype=np.int32),
        node_names=list(names) if names is not None else None,
        name=jax_graph.name,
        simple_certified=bool(getattr(jax_graph, "simple_certified", False)),
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ell_to_numpy(ell) -> tuple[np.ndarray, np.ndarray]:
    """(neighbors [n_pad, d_pad] int32, degrees [n_pad] int32) of an ELL
    layout of either package, as numpy arrays."""
    return _host(ell.neighbors), _host(ell.degrees)


def bucketed_to_numpy(bell) -> dict:
    """A degree-bucketed layout of either package as numpy arrays and ints:
    ``neighbors`` (one [h_pad, d_b] int32 array a slice), ``starts``,
    ``n_real``, ``degrees`` [n_pad] and the graph's ``n_nodes``,
    ``n_edges`` and ``max_degree``."""
    return {
        "neighbors": [_host(s.neighbors) for s in bell.slices],
        "starts": [int(s.start) for s in bell.slices],
        "n_real": [int(s.n_real) for s in bell.slices],
        "degrees": _host(bell.degrees),
        "n_nodes": int(bell.n_nodes),
        "n_edges": int(bell.n_edges),
        "max_degree": int(bell.max_degree),
    }


def bucketed_from_jax(jax_bell, device="cpu") -> BucketedEll:
    """The port's ``BucketedEll`` with a copy of a JAX ``BucketedEll``'s
    slices (each a contiguous tensor of its own) and degrees."""
    d = bucketed_to_numpy(jax_bell)
    slices = tuple(
        EllSlice(torch.from_numpy(np.array(nb, dtype=np.int32)).to(device), s, r)
        for nb, s, r in zip(d["neighbors"], d["starts"], d["n_real"])
    )
    return BucketedEll(
        slices=slices, degrees=torch.from_numpy(np.array(d["degrees"], np.int32)).to(device),
        n_nodes=d["n_nodes"], n_edges=d["n_edges"], max_degree=d["max_degree"],
    )


def sharded_state_from_numpy(colorer, fields: dict, sources):
    """The port's sharded ensemble state on ``colorer``'s mesh
    (``parallel/sharded.ShardedMCMCColorer``) from JAX's sharded state:
    the 11 fields of its ``_STATE_FIELDS``
    (``mcmc_colorer_tpu/parallel/sharded.py:377``) as numpy arrays (a JAX
    checkpoint ``.npz``), re-padded to the port's geometry.  The keys
    (``keydata``) are left out: ``sources`` are this rank's chains' sources,
    positioned where those keys were."""
    return colorer.state_from_numpy(dict(fields), sources)
