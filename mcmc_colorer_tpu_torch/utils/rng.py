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
"""

from __future__ import annotations

import torch


class TorchUniformSource:
    """Uniform [0, 1) float32 draws from a ``torch.Generator`` seeded from
    ``(seed, repetition)``.  The reference seeds one engine per run as
    ``seed + repetition`` (main.cu:171); here the pair is packed into one
    64-bit seed so distinct pairs never share a stream."""

    def __init__(self, seed: int, repetition: int, device) -> None:
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            ((seed & 0xFFFFFFFF) << 32) | (repetition & 0xFFFFFFFF)
        )

    def next(self, n: int) -> torch.Tensor:
        return torch.rand(
            (n,), generator=self.generator, device=self.device,
            dtype=torch.float32,
        )

    def randint(self, n: int, high: int) -> torch.Tensor:
        """int32[n] uniform on [0, high)."""
        return torch.randint(
            0, high, (n,), generator=self.generator, device=self.device,
            dtype=torch.int32,
        )
