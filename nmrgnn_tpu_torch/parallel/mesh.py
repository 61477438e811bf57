"""Process groups for multi-GPU serving (``nmrgnn_tpu/parallel/mesh.py``).

The JAX package runs its shards as ``shard_map`` over a ``(data, graph)``
device mesh. The port runs one process per shard under
``torch.distributed``: ``initialize_distributed`` starts the process group
(from ``torchrun``'s environment, or a given coordinator), and ``make_mesh``
lays the world's ranks out as a ``(data, graph)`` grid and makes one
process group per row and column of it. Axes:

  * ``data``  -- replicas over frames or batches;
  * ``graph`` -- one structure split by atom rows over the ranks of a
    column (``parallel/halo.py``).

``Mesh`` is a small class holding those groups, in place of
``torch.distributed.device_mesh.DeviceMesh``: a ``DeviceMesh`` binds each
rank to a device of its own, and the gloo ranks that share one card do not
have one.
"""
from __future__ import annotations

import datetime
import math
import os
import sys
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300


def _pick_backend(local_world: int) -> Tuple[str, str]:
    """(backend, reason): NCCL when every rank of this host has a card of
    its own, else gloo (no card, or ranks sharing cards: NCCL refuses two
    ranks on one card)."""
    if not torch.cuda.is_available():
        return "gloo", "no CUDA device"
    n = torch.cuda.device_count()
    if n < local_world:
        return "gloo", f"{local_world} ranks share {n} CUDA device(s); NCCL needs one each"
    return "nccl", f"{local_world} ranks on {n} CUDA device(s), one each"


def initialize_distributed(
    coordinator: Optional[str] = None,
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[str]:
    """Start the process group; returns its backend, or None when there is
    nothing to start (no coordinator and no ``torchrun`` environment) or it
    is running already.

    ``coordinator`` is an init method (``tcp://host:port`` or
    ``file:///path``) with ``rank`` and ``world_size`` given; without it the
    group starts from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). ``backend`` None picks NCCL when
    every rank of the host has a card of its own (``LOCAL_WORLD_SIZE``
    ranks) and gloo otherwise; the choice and its reason are printed on one
    line to standard error by rank 0. Each rank takes card ``LOCAL_RANK %
    device_count``. Every collective of the group times out after
    ``timeout_s`` seconds, so a rank that fails cannot leave its peers
    waiting for ever."""
    if dist.is_initialized():
        return None
    env = os.environ
    if coordinator is None:
        if "WORLD_SIZE" not in env:
            return None
        rank = int(env["RANK"]) if rank is None else rank
        world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
        init_method = "env://"
    else:
        if rank is None or world_size is None:
            raise ValueError("a coordinator needs rank and world_size")
        init_method = coordinator
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    if backend is None:
        backend, reason = _pick_backend(local_world)
    else:
        reason = "as asked"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"torch.distributed: backend {backend}, {world_size} ranks ({reason})",
              file=sys.stderr, flush=True)
    return backend


class Mesh:
    """The world's ranks as a (data, graph) grid: rank r sits at
    (r // graph, r % graph), as the JAX package lays its devices out.
    ``shape`` maps each axis to its size; ``group(axis)`` is the process
    group of this rank's line along it (None in a single process),
    ``index(axis)`` this rank's position on it, and ``device`` the device
    its shard runs on (its card, or the CPU without one)."""

    def __init__(self, data: int, graph: int, groups: Dict[str, object], rank: int,
                 device: torch.device):
        self.shape = {"data": data, "graph": graph}
        self._groups = groups
        self.rank = rank
        self.device = device

    def group(self, axis: str):
        return self._groups.get(axis)

    def index(self, axis: str) -> int:
        return self.rank // self.shape["graph"] if axis == "data" else \
            self.rank % self.shape["graph"]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, graph={self.shape['graph']}, "
                f"rank={self.rank}, device={self.device})")


def make_mesh(data: Optional[int] = None, graph: Optional[int] = None) -> Mesh:
    """A (data, graph) mesh over the ranks of the process group (or the one
    process when none is running). With no arguments every rank is on the
    data axis; axis sizes must multiply to at most the world size (the
    ranks past data * graph hold no place, as the JAX package drops the
    devices past it). Every rank of the world must call it, in the same
    order: it makes one process group per line of each axis."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None and graph is None:
        data, graph = world, 1
    elif data is None:
        data = world // graph
    elif graph is None:
        graph = world // data
    if data < 1 or graph < 1 or data * graph > world:
        raise ValueError(f"a {data} x {graph} mesh does not fit {world} ranks")
    groups: Dict[str, object] = {}
    if dist.is_initialized():
        for d in range(data):  # graph lines: the ranks of one data index
            g = dist.new_group([d * graph + j for j in range(graph)])
            if rank // graph == d:
                groups["graph"] = g
        for j in range(graph):  # data lines
            g = dist.new_group([d * graph + j for d in range(data)])
            if rank % graph == j and rank < data * graph:
                groups["data"] = g
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(data, graph, groups, rank, device)


def best_factorization(n: int) -> Tuple[int, int]:
    """(data, graph) split: the most even factor pair, data >= graph."""
    best = (n, 1)
    for g in range(1, int(math.isqrt(n)) + 1):
        if n % g == 0:
            best = (n // g, g)
    return best
