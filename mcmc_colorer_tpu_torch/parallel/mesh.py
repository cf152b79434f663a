"""The (chains, shards) mesh over ``torch.distributed`` ranks.

Counterpart of ``mcmc_colorer_tpu/parallel/mesh.py``.  JAX lays one SPMD
program over a 2-D device mesh; the port runs one process a rank, and
rank r is the mesh position ``(chain group, shard) = divmod(r, shards)``:

* ``chains`` — groups of whole chains (embarrassingly parallel);
* ``shards`` — vertex partitions of one chain (colours all-gathered over
  the ranks of one chain group, the shard group).

``Mesh`` holds the two axis sizes, this rank's coordinates, its device
and its shard group, and gives the collectives JAX's names:
``all_gather_shards`` (``all_gather(..., "shards", tiled=True)``),
``all_reduce_shards`` (``psum`` over ``"shards"``) and ``gather_ranks``
(every rank's small statistics at once, over the whole world, from
which the host forms each ``psum``/``pmax`` over ``"shards"`` or
``"chains"`` that steers the loop).  A 1x1 mesh without a process group
has identity collectives: that is the mesh's own semantics, not a
fallback.  Gloo has no ``reduce_scatter``, so none is used: a sum over
the shards is an ``all_reduce`` and each rank keeps its slice, as JAX's
``psum`` then ``dynamic_slice`` does.

More than one rank is started by ``torchrun`` (or spawned processes),
and ``initialize_distributed`` joins them: ``nccl`` when every rank of a
node has a card of its own, ``gloo`` otherwise (the CPU, or ranks
sharing a card).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


def default_backend(local_world_size: int | None = None) -> str:
    """``nccl`` when CUDA is available and every rank of this node can have
    its own card, else ``gloo`` (NCCL refuses two ranks on one device).
    ``local_world_size``: the ranks on this node; by default
    ``LOCAL_WORLD_SIZE`` (set by ``torchrun``), else ``WORLD_SIZE``."""
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              os.environ.get("WORLD_SIZE", "1")))
    if torch.cuda.is_available() and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group (``dist.init_process_group``): from the
    environment ``torchrun`` sets (``init_method`` None) or from
    ``init_method`` (``tcp://localhost:<port>``, ``file://...``) with
    ``world_size`` and ``rank``, all on this node.  ``backend`` None is
    ``default_backend`` of the ranks on this node.  A no-op when the group
    already exists."""
    if dist.is_initialized():
        return
    local_world_size = world_size
    if init_method is None:
        world_size = int(os.environ.get("WORLD_SIZE", world_size or 1))
        rank = int(os.environ.get("RANK", rank or 0))
        init_method = "env://"
        local_world_size = None
    backend = backend or default_backend(local_world_size)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def factor_mesh(n_devices: int, prefer_chains: int | None = None) -> tuple[int, int]:
    """Split a device count into (chains, shards).  Prefers the requested
    chain count when it divides; otherwise the most balanced factoring
    with chains >= shards."""
    if prefer_chains and n_devices % prefer_chains == 0:
        return prefer_chains, n_devices // prefer_chains
    best = (n_devices, 1)
    c = int(n_devices**0.5)
    while c >= 1:
        if n_devices % c == 0:
            best = (n_devices // c, c)
            break
        c -= 1
    return best


def _rank_device(rank: int) -> torch.device:
    """This rank's card: ``LOCAL_RANK`` (set by ``torchrun``) or the rank,
    modulo the cards there are; without a card this raises (the colorers
    run on the CPU only when asked)."""
    from mcmc_colorer_tpu_torch.models.base import colorer_device

    colorer_device("cuda")  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass
class Mesh:
    """This rank's view of a ``(chains, shards)`` mesh: the axis sizes,
    its coordinates, its device, and its shard group (the ranks of its
    chain group, one a shard).  Without a process group (``distributed``
    False: one rank) the group is None and the collectives the identity;
    with one, they run, whatever the world size."""

    chains: int
    shards: int
    chain_index: int
    shard_index: int
    device: torch.device
    shard_group: object = None
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return {"chains": self.chains, "shards": self.shards}

    @property
    def size(self) -> int:
        return self.chains * self.shards

    @property
    def rank(self) -> int:
        return self.chain_index * self.shards + self.shard_index

    def all_gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """The shards' pieces of ``x`` concatenated along its last axis,
        in shard order (JAX's tiled ``all_gather`` over ``"shards"``)."""
        if not self.distributed:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shards)]
        dist.all_gather(parts, x, group=self.shard_group)
        return torch.cat(parts, dim=-1)

    def all_reduce_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the shard group (``psum`` over ``"shards"``)."""
        if not self.distributed:
            return x
        x = x.contiguous().clone()
        dist.all_reduce(x, group=self.shard_group)
        return x

    def gather_shards_host(self, x: torch.Tensor) -> np.ndarray:
        """[shards, *x.shape] on the host: every shard's ``x``."""
        if not self.distributed:
            return x.cpu().numpy()[None]
        return self.all_gather_shards(x.contiguous()[..., None]).movedim(-1, 0).cpu().numpy()

    def gather_ranks(self, x: torch.Tensor) -> np.ndarray:
        """[chains, shards, *x.shape] on the host: every rank's ``x`` (a
        small statistics tensor), in mesh order; one collective."""
        if not self.distributed:
            return x.cpu().numpy()[None, None]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.stack(parts).cpu().numpy().reshape(self.chains, self.shards, *x.shape)

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        if not self.distributed:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast(self, x: torch.Tensor, src_rank: int) -> torch.Tensor:
        """``x`` as rank ``src_rank`` holds it, on every rank."""
        if not self.distributed:
            return x
        x = x.contiguous().clone()
        dist.broadcast(x, src=src_rank)
        return x

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def make_mesh(chains: int | None = None, shards: int | None = None, device=None) -> Mesh:
    """Build this rank's ``(chains, shards)`` mesh over the world of
    ``torch.distributed`` (one rank when no process group exists).  Either
    size may be None, as in JAX (both None: ``factor_mesh``); their
    product must be the world size.  ``device``: this rank's device, by
    default its card (``LOCAL_RANK``); ``"cpu"`` for the plain versions."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    need = (chains or 1) * (shards or 1)
    if chains is None and shards is None:
        chains, shards = factor_mesh(world)
    elif chains is None:
        chains = world // shards
    elif shards is None:
        shards = world // chains
    if chains * shards != world:
        raise ValueError(
            f"mesh {chains}x{shards} != {world} ranks (start the ranks with torchrun "
            f"--nproc-per-node {need})"
        )
    if device is None or str(device) == "cuda":
        device = _rank_device(rank)
    device = torch.device(device)
    g, s = divmod(rank, shards)
    shard_group = None
    if distributed:
        # every rank creates every group, in the same order
        for gi in range(chains):
            grp = dist.new_group([gi * shards + si for si in range(shards)])
            if gi == g:
                shard_group = grp
    return Mesh(chains, shards, g, s, device, shard_group, distributed)
