"""State carried between the JAX package and the port, as numpy arrays.

- The packed adjacency: JAX holds uint32 words, the port int32 words
  with the same bit patterns (``adjacency_from_jax`` / ``adjacency_to_jax``).
- The chain carry: the fields a JAX resident checkpoint holds
  (``models/mcmc_resident.py:save_checkpoint``: colors, taboo,
  iteration, conf_last, trace, done) become the port's ``ChainState``
  and back.  The key is left out: the port draws from its own source.
"""

from __future__ import annotations

import numpy as np
import torch

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


def carry_from_numpy(
    colors, taboo, iteration, conf_last, trace, done, device="cpu"
) -> ChainState:
    """The port's chain state from a JAX carry's (or checkpoint's) fields."""
    return ChainState(
        colors=torch.from_numpy(np.asarray(colors, dtype=np.int32).copy()).to(device),
        taboo=torch.from_numpy(np.asarray(taboo, dtype=np.int32).copy()).to(device),
        rip=int(iteration),
        conf_last=int(conf_last),
        trace=np.asarray(trace, dtype=np.int32).copy(),
        done=bool(done),
    )


def carry_to_numpy(state: ChainState) -> dict:
    """The inverse of :func:`carry_from_numpy`, keyed by checkpoint field."""
    return {
        "colors": state.colors.cpu().numpy(),
        "taboo": state.taboo.cpu().numpy(),
        "iteration": np.int32(state.rip),
        "conf_last": np.int32(state.conf_last),
        "trace": state.trace.copy(),
        "done": np.bool_(state.done),
    }
