"""Randomness: one uniform source per chain.

Counterpart of ``mcmc_colorer_tpu/utils/rng.py``.  The JAX package splits
a ``jax.random`` key tree; the port draws from an explicit
``torch.Generator`` on the run's device.  Every draw of a chain goes
through one object with ``next(n) -> float32[n]``, in the same order as
the JAX chain consumes keys:

- one call for the initial colouring (``_init_colors``);
- one call per body execution of the chain loop, including the final
  body that detects convergence (Hastings adds a second, scalar call for
  the acceptance test);
- one call per tailcut round: the coin flips of the resident NC
  tailcut (``next``), or the stall-escape colours of the flat ELL
  tailcut (``randint``, drawn every round, stalled or not, as JAX draws
  ``randint(fold_in(key, round))``).

The frontier chain (``models/mcmc_active.py``, and the resident chain
with ``active=True``) draws in the order JAX splits its key
(``key, k_it = split(key)`` an iteration, mcmc_active.py:230):

- the initial colouring, ``next(n_pad)``;
- a full iteration: ``next(n_pad)`` (mcmc_active.py:362-363); on the
  resident graph these are the do-while bodies above;
- a frontier iteration at ladder rung ``cap``: ``next(cap)``, the
  ε-flip's ``next(1)``, its vertex ``randint(1, n_pad)`` and its colour
  offset ``randint(1, max(nCol, 2), low=1)`` (:401,422,460-466), all
  four whether or not a vertex flips;
- a frontier tailcut round at rung ``cap``: ``randint(cap, nCol)``
  (:204,576); the resident chain's NC tailcut instead draws its coins
  with ``next(n_pad)`` a round, as above.

Luby (``models/luby.py``) draws from its own source, seeded the same
way, in the order JAX splits its key (``key, sub = split(key)`` then
``uniform(sub, ...)``, luby.py:263,329,397-398):

- the full loop (gather or resident): one ``next(n_pad)`` per round,
  the round that commits a colour included;
- the frontier loop: one ``next(cap)`` per round, ``cap`` the ladder
  rung of that round; the i-th uniform goes to the i-th candidate in
  ascending id order.

Tests substitute a source that replays JAX's own draws in that order, so
both packages can be fed identical uniforms.  The two generators give
different numbers for the same seed; whole-chain bit parity is not a
goal (float cumsums differ between XLA and torch, see ``models/mcmc.py``).

Ensembles (the counterpart of ``rngu.for_chain``, ``fold_in(root, c)``):
chain c draws from ``TorchUniformSource(seed, repetition, device,
chain=c)``, a stream that depends on ``(seed, repetition, c)`` alone,
never on the number of chains, and differs from every other chain's.
``ChainSources`` holds one source a chain and draws ``[C, n]`` at once,
but only for the chains still running: JAX's vmapped loops keep a
finished chain's key frozen, and a finished chain's generator here does
not advance either, so each chain of an ensemble draws exactly what a run
of that chain alone draws (its tailcut included).

A source's generator state is ``get_state()`` / ``set_state()`` (a CPU
byte tensor on either device), what a checkpoint stores.
"""

from __future__ import annotations

import numpy as np
import torch


_M32 = 0xFFFFFFFF


def generator_seed(seed: int, repetition: int, chain: int | None = None) -> int:
    """One 64-bit generator seed for ``(seed, repetition)``, one-to-one on
    32-bit pairs: the repetition in the high word, the seed XOR a mix of
    the repetition in the low word.  The CPU generator (mt19937) keeps
    only the low 32 bits of its seed, so they depend on both; CUDA's
    Philox keeps all 64.  ``chain`` c XORs the low word with ``(c + 1)``
    times an odd constant, one-to-one in c for a given pair, so the chains
    of one run draw distinct streams, none of them the chainless one."""
    s, r = seed & _M32, repetition & _M32
    low = s ^ ((r * 0x9E3779B9) & _M32)
    if chain is not None:
        low ^= ((chain + 1) * 0x85EBCA6B) & _M32
    return (r << 32) | low


class TorchUniformSource:
    """Uniform [0, 1) float32 draws from a ``torch.Generator`` seeded from
    ``(seed, repetition)``, or ``(seed, repetition, chain)`` for a chain
    of an ensemble (``generator_seed``).  The reference seeds one engine
    per run as ``seed + repetition`` (main.cu:171); here distinct
    triples get distinct seeds."""

    def __init__(self, seed: int, repetition: int, device, chain: int | None = None) -> None:
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(generator_seed(seed, repetition, chain))

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)

    def next(self, n: int) -> torch.Tensor:
        return torch.rand(
            (n,), generator=self.generator, device=self.device,
            dtype=torch.float32,
        )

    def randint(self, n: int, high: int, low: int = 0) -> torch.Tensor:
        """int32[n] uniform on [low, high)."""
        return torch.randint(
            low, high, (n,), generator=self.generator, device=self.device,
            dtype=torch.int32,
        )


class ChainSources:
    """One source a chain, drawing for a chain axis: ``next(n, running)``
    is [C, n] float32 and ``randint(n, high, low, running)`` [C, n] int32,
    where only the chains with ``running[c]`` (a host bool array; all by
    default) draw; the rows of the others are 0 and their sources do not
    advance.  ``sources`` may be any objects with the single source's
    ``next``/``randint`` (tests replay JAX's draws a chain)."""

    def __init__(self, sources, device) -> None:
        self.sources = list(sources)
        self.device = torch.device(device)

    @classmethod
    def seeded(cls, seed: int, repetition: int, n_chains: int, device,
               first: int = 0) -> "ChainSources":
        """The sources of chains ``first .. first + n_chains - 1``: chain
        c's is ``TorchUniformSource(seed, repetition, device, chain=c)``,
        whatever ``n_chains`` and ``first`` (a mesh's chain group runs its
        share of the chains)."""
        return cls([TorchUniformSource(seed, repetition, device, chain=c)
                    for c in range(first, first + n_chains)], device)

    def __len__(self) -> int:
        return len(self.sources)

    def _draw(self, n: int, dtype, running, draw) -> torch.Tensor:
        if len(self.sources) == 1 and (running is None or running[0]):
            return draw(self.sources[0])[None]  # one chain: no copy
        out = torch.zeros((len(self.sources), n), dtype=dtype, device=self.device)
        run = np.ones(len(self.sources), bool) if running is None else np.asarray(running)
        for c, src in enumerate(self.sources):
            if run[c]:
                out[c] = draw(src)
        return out

    def next(self, n: int, running=None) -> torch.Tensor:
        return self._draw(n, torch.float32, running, lambda s: s.next(n))

    def randint(self, n: int, high: int, low: int = 0, running=None) -> torch.Tensor:
        return self._draw(n, torch.int32, running, lambda s: s.randint(n, high, low))

    def get_state(self) -> list:
        return [s.get_state() for s in self.sources]

    def set_state(self, states) -> None:
        for s, st in zip(self.sources, states):
            s.set_state(st)
