"""Named host ranges at the port's layer boundaries, read from a profiler.

``span(name)`` is a context manager.  Without a torch profiler session
(``torch.autograd._profiler_enabled()`` false) it returns one shared no-op
object and does nothing else: no range, no clock read, no allocation.
Inside a session it enters a range of that name, which lands in the same
kineto trace as the device's kernels, on the clock their events carry,
nested by thread.  There is no switch: a span is on exactly when a
profiler runs (any ``torch.profiler.profile`` over a colouring).

The range is an operator-scope one (``_RecordFunctionFast``), not
``torch.profiler.record_function``'s user scope: kineto copies a
user-scope range onto the device's timeline as well (a
``gpu_user_annotation`` row spanning its kernels), which a reader of the
device's busy time would count as work.  The host range is the same.

The colourers' spans (names start with ``mc.``), from the outside in:

- ``mc.run.<colourer>`` (``resident``, ``ell``, ``greedy_ff``, ``vff``):
  a colourer's ``run``, until its colours are on the host;
- ``mc.hashgen``: the hash graph's generation and degrees, until the
  max-degree host read (``ResidentMCMCColorer.__init__``);
- ``mc.chain``: the chain, from its start to its final conflict count;
- ``mc.body``: one do-while body (``extra["sweeps"]`` of them), with its
  steps ``mc.body.draw``, ``mc.body.p_eff``, ``mc.body.sweep`` and
  ``mc.body.read`` (the conflict counts to the host); in a packed sweep
  ``mc.sweep.nc`` (kernel K1) and ``mc.sweep.propose``; in an ELL sweep
  one ``mc.sweep.class`` around each K2 call (its launch and the sum of
  its rows' conflict counts), one a rectangle on the card: the flat
  ELL's one, or each degree class of the bucketed layout;
- ``mc.tailcut``, one ``mc.tailcut.round`` a round and its
  ``mc.tailcut.read``; on the ELL paths one ``mc.tailcut.class``
  around each K3 tailcut call and each lower-movable call, so two a
  rectangle a round on the card;
- ``mc.greedy.round`` / ``mc.greedy.read``: a GreedyFF round and its host
  read; ``mc.vff.round`` / ``mc.vff.read``: a VFF rebalancing round;
- ``mc.readback``: the colours to the host.

The frontier loops' rounds (``models/mcmc_active.py:round_range``) use
the same helper under their own names.
"""

from __future__ import annotations

import torch

_enabled = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span when no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str):
    """A range named ``name`` in the profiler's trace, or ``OFF``."""
    return _Range(name) if _enabled() else OFF
