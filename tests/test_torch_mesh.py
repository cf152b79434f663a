"""The port's mesh (``parallel/mesh.py``) against the JAX package's
(``mcmc_colorer_tpu/parallel/mesh.py``), on the CPU.

- ``factor_mesh`` equals JAX's on a table of device counts and preferred
  chain counts.
- ``make_mesh`` over a world of 1, 2 and 4 ranks (2 and 4 spawned gloo
  ranks, ``init_method="file://..."``, each spawn killed at its own
  deadline) against JAX's over the same number of the 8 virtual CPU
  devices: the same axis sizes for every (chains, shards) request, a
  ValueError where JAX raises one (the port's naming torchrun), and rank r
  at JAX's mesh position of device r, ``divmod(r, shards)``.
- The collectives on those ranks: ``all_gather_shards`` (tiled, in shard
  order), ``all_reduce_shards`` (a sum), ``gather_ranks``,
  ``gather_objects`` and ``broadcast`` give what JAX's ``all_gather`` /
  ``psum`` over the same axis give (integers, exact); without a process
  group they are the identity.
- ``default_backend`` picks NCCL when this node's ranks
  (``LOCAL_WORLD_SIZE``) each have a card, whatever the world size.
"""

import os
import pickle
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mcmc_colorer_tpu.parallel.mesh import factor_mesh as j_factor_mesh
from mcmc_colorer_tpu.parallel.mesh import make_mesh as j_make_mesh

from mcmc_colorer_tpu_torch.parallel.mesh import (
    default_backend,
    factor_mesh,
    initialize_distributed,
    make_mesh,
)

DEADLINE_S = 120.0
REQUESTS = [(None, None), (1, None), (None, 1), (2, None), (None, 2), (1, 2), (2, 1), (2, 2),
            (4, None), (None, 4), (1, 4), (4, 1), (3, None), (2, 4)]


@pytest.mark.parametrize("n", [1, 2, 4, 6, 7, 8, 12, 16])
@pytest.mark.parametrize("prefer", [None, 2, 4])
def test_factor_mesh_matches_jax(n, prefer):
    assert factor_mesh(n, prefer_chains=prefer) == j_factor_mesh(n, prefer_chains=prefer)


@pytest.mark.parametrize("env, cards, want", [
    ({"LOCAL_WORLD_SIZE": "8", "WORLD_SIZE": "16", "RANK": "9"}, 8, "nccl"),  # 2 nodes of 8
    ({"LOCAL_WORLD_SIZE": "2", "WORLD_SIZE": "2", "RANK": "1"}, 1, "gloo"),   # a shared card
    ({"WORLD_SIZE": "4", "RANK": "3"}, 4, "nccl"),  # no LOCAL_WORLD_SIZE: one node
    ({"LOCAL_WORLD_SIZE": "4", "WORLD_SIZE": "4", "RANK": "0"}, 0, "gloo"),  # no card
])
def test_default_backend_counts_this_nodes_ranks(monkeypatch, env, cards, want):
    """NCCL wherever each rank of this node has a card of its own, and
    ``initialize_distributed`` from torchrun's environment joins with it."""
    for k in ("LOCAL_WORLD_SIZE", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert default_backend() == want
    joined = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.update(backend=backend, **kw))
    initialize_distributed()
    assert joined == {"backend": want, "init_method": "env://",
                      "world_size": int(env["WORLD_SIZE"]), "rank": int(env["RANK"])}


def _port_request(chains, shards):
    try:
        m = make_mesh(chains, shards, device="cpu")
    except ValueError as e:
        return "error", str(e)
    return (m.chains, m.shards), (m.chain_index, m.shard_index)


def _jax_request(chains, shards, world):
    try:
        m = j_make_mesh(chains, shards, devices=jax.devices()[:world])
    except ValueError:
        return "error"
    return (m.shape["chains"], m.shape["shards"])


def _collectives(rank):
    """This rank's results of every collective on a (2, ms) mesh."""
    mesh = make_mesh(2, None, device="cpu")
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * rank
    out = {
        "gather": mesh.all_gather_shards(x).tolist(),
        "sum": mesh.all_reduce_shards(x).tolist(),
        "ranks": mesh.gather_ranks(torch.tensor([rank, -rank], dtype=torch.int64)).tolist(),
        "host": mesh.gather_shards_host(torch.tensor([rank + 0.5])).tolist(),
        "objects": mesh.gather_objects({"rank": rank}),
        "broadcast": mesh.broadcast(torch.tensor([rank] * 2), mesh.size - 1).tolist(),
    }
    mesh.barrier()
    return out


def _rank_main(rank, world, rdv, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{rdv}", world_size=world, rank=rank,
                           backend="gloo")
    try:
        got = {"requests": {req: _port_request(*req) for req in REQUESTS},
               "collectives": _collectives(rank)}
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp_path / "rdv"), str(out)),
                             nprocs=world, join=False, start_method="spawn")
    t_end = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > t_end:
                pytest.fail(f"spawned ranks still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [pickle.loads((out / f"{r}.pkl").read_bytes()) for r in range(world)]


def test_make_mesh_one_rank_matches_jax():
    """No process group: a 1x1 mesh whatever the request that fits, the
    collectives the identity, and JAX's refusals (naming torchrun)."""
    for req in REQUESTS:
        got, want = _port_request(*req), _jax_request(*req, 1)
        if want == "error":
            assert got[0] == "error" and "torchrun" in got[1], req
        else:
            assert got == (want, (0, 0)), req
    mesh = make_mesh(device="cpu")
    assert not mesh.distributed and mesh.shape == {"chains": 1, "shards": 1}
    x = torch.arange(4, dtype=torch.int32)
    assert mesh.all_gather_shards(x) is x and mesh.all_reduce_shards(x) is x
    assert mesh.gather_ranks(x).tolist() == [[x.tolist()]]
    assert mesh.gather_objects(3) == [3] and mesh.broadcast(x, 0) is x


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_ranks_match_jax(world, tmp_path):
    ranks = _spawn(world, tmp_path)
    for r, got in enumerate(ranks):
        for req in REQUESTS:
            want = _jax_request(*req, world)
            if want == "error":
                assert got["requests"][req][0] == "error", (r, req)
                assert "torchrun" in got["requests"][req][1]
                continue
            shape, coords = got["requests"][req]
            assert shape == want, (r, req)
            # JAX lays device r at mesh position divmod(r, shards)
            jm = j_make_mesh(*req, devices=jax.devices()[:world])
            pos = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices) == jax.devices()[r].id)
            assert coords == tuple(int(i) for i in pos[0]), (r, req)
    # collectives on the (2, world // 2) mesh against JAX's semantics
    ms = world // 2
    xs = [np.arange(6, dtype=np.int32).reshape(2, 3) + 10 * r for r in range(world)]
    for r, got in enumerate(ranks):
        g, s = divmod(r, ms)
        group = [xs[g * ms + k] for k in range(ms)]
        c = got["collectives"]
        assert c["gather"] == np.concatenate(group, axis=-1).tolist()
        assert c["sum"] == np.sum(group, axis=0).tolist()
        assert c["ranks"] == [[[k * ms + j, -(k * ms + j)] for j in range(ms)]
                              for k in range(2)]
        assert c["host"] == [[g * ms + k + 0.5] for k in range(ms)]
        assert c["objects"] == [{"rank": k} for k in range(world)]
        assert c["broadcast"] == [world - 1] * 2
