"""Halo-exchange graph partitioning (``nmrgnn_tpu/parallel/halo.py``):
one structure split by atom rows over the ranks of the mesh's ``graph``
axis, each MP layer moving only the boundary rows a shard's real edges
reference.

The plans are host numpy, equal to the JAX package's field for field:
per shard pair (s -> t), exactly which of s's rows t's REAL edges
reference, exchanged with one send/receive pair per ring offset o with any
boundary traffic (every shard sends its H_o boundary rows to (s + o) % D).
Neighbor lists are rewritten to index a local workspace = [own rows |
received rows, grouped by offset]. With RCM-ordered atoms the kept offsets
are {1, D-1}, so the volume is about 2 * H * F a shard, independent of D.

The forwards run one process per shard under ``torch.distributed``
(``parallel/mesh.py``): every rank holds the whole structure on the host
(as every JAX process does), runs its own rows and returns the full [N]
peaks. The exchange is ``dist.batch_isend_irecv`` (``ring_exchange``), the
sum ``all_reduce`` (``psum``) and the peaks come from
``all_gather_into_tensor``. Under gloo, CUDA buffers go through the host
(gloo's send and receive take host tensors); under NCCL they are sent as
they are.

The attention family's padding slots follow ``gnn.apply``: each padding
slot sends the row its index names. The JAX package's partitioned forwards
add that mass at row 0 (``halo.py:680-689``, ``:1113-1125``), which equals
it only where padding slots name row 0; here the rows that padding slots
name (``models/infer.padding_rows``) may live on any shard, and their wv
projections are summed over the graph group in one [R, F] ``all_reduce``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as nnf

from ..config import ModelConfig
from ..graph import Graph
from ..models.gnn import compute_dtype, dense
from ..models.infer import _padding_slots, padding_rows
from ..ops import banded
from ..ops.activations import get_activation
from ..ops.edge import edge_features
from ..ops.edgefn import EdgeCheb
from ..ops.message_passing import attention_weights, mp_aggregate
from .mesh import Mesh


class HaloPlan(NamedTuple):
    """Host-precomputed ring-exchange plan for one (structure, D).

    ``offsets`` is the static tuple of ring offsets carrying any
    boundary traffic (RCM-ordered structures keep only {1, D-1});
    ``send_idx[i][s]`` lists the local row ids shard s sends to shard
    (s + offsets[i]) % D, ascending, zero-padded to ``halo_sizes[i]``.
    The per-shard workspace is [m own rows | offset-0 rows | offset-1
    rows | ...]; ``local_nlist`` indexes it. Only REAL edges create
    entries — masked/padding references map to local slot 0 and
    contribute nothing (e == 0 in every consumer)."""

    offsets: tuple           # static ring offsets, ascending, each in 1..D-1
    send_idx: tuple          # per offset: i32[D, H_o]
    local_nlist: np.ndarray  # i32[D, m, K] workspace-relative neighbor ids
    halo_sizes: tuple        # per offset: H_o (padded to halo_multiple)
    n_shards: int
    rows_per_shard: int

    @property
    def halo_rows(self) -> int:
        """Rows each shard sends AND receives per exchange."""
        return int(sum(self.halo_sizes))

    @property
    def workspace_rows(self) -> int:
        return self.rows_per_shard + self.halo_rows


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class PlanShapeMismatch(ValueError):
    """A ``like`` plan's shape envelope cannot cover this frame."""


def make_halo_plan(
    nlist: np.ndarray,
    n_shards: int,
    halo_multiple: int = 8,
    edges=None,
    force_offsets=None,
    force_halo_sizes=None,
) -> HaloPlan:
    """Build the ring-exchange plan on host. Atom count must divide
    n_shards. ``edges`` (distances; > 0 = real) restricts
    the halo to rows actually consumed — padding/masked references map
    to local slot 0 and are excluded from the exchange entirely. Without
    ``edges`` every reference counts (a superset; correct but larger).

    Vectorized per requester shard (unique + searchsorted) — no
    per-boundary-edge Python loop, so whole-protein multi-host plans
    build in O(D * N*K log) numpy time.

    ``force_offsets``/``force_halo_sizes``: adopt an existing plan's
    ring-shape envelope (offset set + per-offset capacities) so a new
    trajectory frame's plan shares the old plan's SHAPES — its arrays
    then ride as traced operands through the old compilation
    (train/partitioned.py frame grouping). Raises PlanShapeMismatch
    when this frame's traffic does not fit the envelope."""
    nlist = np.asarray(nlist)
    n, k = nlist.shape
    if n % n_shards:
        raise ValueError(f"{n} atoms not divisible by {n_shards} shards")
    m = n // n_shards
    D = n_shards
    real = (
        np.ones_like(nlist, bool) if edges is None else np.asarray(edges) > 0
    )
    owner = nlist // m  # [n, K] owner shard of each referenced row

    # pass 1: per (owner s -> requester t) pair, the sorted unique real
    # external rows; per ring offset o = (t - s) % D, the max pair count
    pair_rows: dict = {}
    counts = np.zeros(D, np.int64)
    for t in range(D):
        sel = slice(t * m, (t + 1) * m)
        refs, own, rt = nlist[sel], owner[sel], real[sel]
        u = np.unique(refs[rt & (own != t)])
        uo = u // m
        gs = np.searchsorted(uo, np.arange(D))
        ge = np.searchsorted(uo, np.arange(D), side="right")
        for s in range(D):
            if ge[s] > gs[s]:
                pair_rows[(s, t)] = u[gs[s] : ge[s]]
                counts[(t - s) % D] = max(counts[(t - s) % D], ge[s] - gs[s])

    if force_offsets is not None:
        need = {int(o): int(counts[o]) for o in range(1, D) if counts[o] > 0}
        cap = dict(zip(force_offsets, force_halo_sizes))
        for o, c in need.items():
            if cap.get(o, 0) < c:
                raise PlanShapeMismatch(
                    f"offset {o} needs {c} rows, envelope has {cap.get(o, 0)}"
                )
        offsets = tuple(force_offsets)
        halo_sizes = tuple(force_halo_sizes)
    else:
        offsets = tuple(int(o) for o in range(1, D) if counts[o] > 0)
        halo_sizes = tuple(
            int(_round_up(int(counts[o]), halo_multiple)) for o in offsets
        )
    send_idx = tuple(np.zeros((D, h), np.int32) for h in halo_sizes)
    base = {}
    acc = m
    for i, o in enumerate(offsets):
        base[o] = acc
        acc += halo_sizes[i]
        for s in range(D):
            rows = pair_rows.get((s, (s + o) % D))
            if rows is not None:
                send_idx[i][s, : len(rows)] = rows - s * m  # local to owner

    local_nlist = np.zeros((D, m, k), np.int32)
    for t in range(D):
        sel = slice(t * m, (t + 1) * m)
        refs, own, rt = nlist[sel], owner[sel], real[sel]
        inside = own == t
        slot = np.where(inside, refs - t * m, 0)
        for s in range(D):
            if s == t or (s, t) not in pair_rows:
                continue
            rows = pair_rows[(s, t)]
            pick = rt & (own == s)
            slot[pick] = base[(t - s) % D] + np.searchsorted(rows, refs[pick])
        local_nlist[t] = slot.astype(np.int32)
    return HaloPlan(
        offsets=offsets,
        send_idx=send_idx,
        local_nlist=local_nlist,
        halo_sizes=halo_sizes,
        n_shards=D,
        rows_per_shard=m,
    )


class BandedHaloPlan(NamedTuple):
    """Halo plan + per-shard interior band plan: the multi-GPU kernel path.

    Per shard the MP aggregation splits into
      acc = band(M_interior, own_nodes)            all T row tiles
          + band(M_halo, received_rows)            boundary tiles only
    summed BEFORE the activation, so numerics equal the single-device
    forward while the interior band's kernel runs independently of the
    exchange (the overlap window).

    The halo stage is compacted: only ``num_boundary_tiles`` (uniform
    across shards, padded with zero-contribution tiles) participate,
    each with its own window of width ``halo_window`` into the received
    halo rows — with RCM ordering that is O(window/m) of the tiles, so
    the halo stage costs a small fraction of the interior band instead
    of a dense [T, E, B, D*H] block."""

    halo: HaloPlan
    lo: np.ndarray           # i32[D, T] per-shard interior window starts
    window: int              # W (lanes), <= rows_per_shard
    block_rows: int          # B
    boundary_ids: np.ndarray  # i32[D, Tb] tile indices with halo refs
    halo_lo: np.ndarray      # i32[D, Tb] window starts into halo rows
    halo_window: int         # Wh (lanes), <= D * H

    @property
    def num_tiles(self) -> int:
        return self.halo.rows_per_shard // self.block_rows

    @property
    def num_boundary_tiles(self) -> int:
        return self.boundary_ids.shape[1]

    @property
    def halo_lanes(self) -> int:
        """Rows of the per-shard halo workspace the halo band indexes
        (received rows, zero-padded up to the halo window width)."""
        return max(self.halo.halo_rows, self.halo_window)


def make_banded_halo_plan(
    nlist: np.ndarray,
    edges: np.ndarray,
    n_shards: int,
    block_rows: int = 128,
    align: int = 128,
    w_buckets=(256, 384, 512, 640, 768, 896, 1024, 1280, 1536, 2048),
    like: "BandedHaloPlan" = None,
) -> BandedHaloPlan:
    """Build the banded multi-GPU plan. The graph should be RCM-ordered
    (data.reorder.rcm_order) so interior windows stay narrow and halos
    concentrate at shard boundaries; atom count must be a multiple of
    n_shards * block_rows.

    ``like``: adopt an existing plan's SHAPE envelope (ring offsets +
    halo capacities, window, halo window, boundary-tile count) so
    same-trajectory frames produce shape-identical plans. Raises
    PlanShapeMismatch when this frame
    escapes the envelope (callers fall back to a fresh plan)."""
    nlist = np.asarray(nlist)
    edges = np.asarray(edges)
    n, k = nlist.shape
    if like is not None and (
        like.halo.n_shards != n_shards
        or like.halo.rows_per_shard * n_shards != n
        or like.block_rows != block_rows
    ):
        raise PlanShapeMismatch("shard/row geometry differs from `like`")
    # halo slots padded to full lanes so the halo block matmul is tiled
    base = make_halo_plan(
        nlist, n_shards, halo_multiple=align, edges=edges,
        force_offsets=like.halo.offsets if like is not None else None,
        force_halo_sizes=like.halo.halo_sizes if like is not None else None,
    )
    m = base.rows_per_shard
    if m % block_rows:
        raise ValueError(
            f"rows per shard {m} not a multiple of block_rows {block_rows}"
        )
    t = m // block_rows
    dh = base.halo_rows
    lo = np.zeros((n_shards, t), np.int64)
    need = np.zeros((n_shards, t), np.int64)
    h_lo = np.zeros((n_shards, t), np.int64)
    h_need = np.zeros((n_shards, t), np.int64)
    is_boundary = np.zeros((n_shards, t), bool)
    for s in range(n_shards):
        lnl = base.local_nlist[s]
        real = edges[s * m : (s + 1) * m] > 0
        interior = real & (lnl < m)
        external = real & (lnl >= m)
        for i in range(t):
            sel = slice(i * block_rows, (i + 1) * block_rows)
            idx = lnl[sel][interior[sel]]
            if len(idx):
                lo_i = (int(idx.min()) // align) * align
                lo[s, i] = lo_i
                need[s, i] = int(idx.max()) - lo_i + 1
            hdx = lnl[sel][external[sel]] - m
            if len(hdx):
                is_boundary[s, i] = True
                hlo_i = (int(hdx.min()) // align) * align
                h_lo[s, i] = hlo_i
                h_need[s, i] = int(hdx.max()) - hlo_i + 1

    def bucket(w, cap):
        for b in w_buckets:
            if w <= b:
                w = b
                break
        else:
            w = _round_up(w, 512)
        return max(min(w, cap), 128)

    w = bucket(int(need.max()) if need.size else align, m)
    if like is not None:
        if w > like.window:
            raise PlanShapeMismatch(
                f"interior window needs {w}, envelope has {like.window}"
            )
        w = like.window
    lo = np.minimum(lo, max(m - w, 0))

    # boundary-tile compaction: uniform count across shards (SPMD), padded
    # with non-boundary tiles whose halo band is all-zero (no refs >= m)
    tb = max(int(is_boundary.sum(axis=1).max()), 1)
    if like is not None:
        if tb > like.num_boundary_tiles:
            raise PlanShapeMismatch(
                f"{tb} boundary tiles, envelope has {like.num_boundary_tiles}"
            )
        tb = like.num_boundary_tiles
    boundary_ids = np.zeros((n_shards, tb), np.int64)
    for s in range(n_shards):
        ids = np.nonzero(is_boundary[s])[0]
        fill = np.nonzero(~is_boundary[s])[0]
        pad_id = fill[0] if len(fill) else (ids[0] if len(ids) else 0)
        padded = np.concatenate([ids, np.full(tb - len(ids), pad_id)])
        boundary_ids[s] = padded
    wh = bucket(int(h_need.max()) if h_need.size else align, dh)
    if like is not None:
        if wh > like.halo_window:
            raise PlanShapeMismatch(
                f"halo window needs {wh}, envelope has {like.halo_window}"
            )
        wh = like.halo_window
    h_lo = np.minimum(h_lo, max(dh - wh, 0))
    halo_lo = np.take_along_axis(h_lo, boundary_ids, axis=1)
    return BandedHaloPlan(
        halo=base,
        lo=lo.astype(np.int32),
        window=w,
        block_rows=block_rows,
        boundary_ids=boundary_ids.astype(np.int32),
        halo_lo=halo_lo.astype(np.int32),
        halo_window=wh,
    )



# -- collectives ----------------------------------------------------------------


def _staged(group) -> bool:
    """Whether CUDA buffers go through the host: under gloo, whose send
    and receive take host tensors."""
    return dist.get_backend(group) == "gloo"


class _Exchange:
    """A posted ring exchange: ``wait()`` returns the received rows
    [halo_lanes, F], concatenated in offset order and zero-padded."""

    def __init__(self, works, recvs, device, lanes: int, like: torch.Tensor):
        self._works, self._recvs = works, recvs
        self._device, self._lanes, self._like = device, lanes, like

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        F = self._like.shape[1]
        h = (torch.cat(self._recvs, 0) if self._recvs
             else torch.zeros((0, F), dtype=self._like.dtype))
        h = h.to(self._device, non_blocking=False)
        pad = self._lanes - h.shape[0]
        return nnf.pad(h, (0, 0, 0, pad)) if pad > 0 else h


def ring_exchange(nodes: torch.Tensor, send_idx: Sequence[torch.Tensor], offsets: Sequence[int],
                  group, lanes: int = 0) -> _Exchange:
    """Post the ring exchange of this shard's boundary rows and return at
    once; ``.wait()`` gives the received rows [max(lanes, sum H_o), F].

    For each kept offset o (``plan.offsets``, in order, the same on every
    rank), shard s sends ``nodes[send_idx[i]]`` ([H_o] local row ids,
    this shard's row of the plan's ``send_idx[i]``) to (s + o) % D and
    receives H_o rows from (s - o) % D, one ``P2POp`` pair each, all in one
    ``dist.batch_isend_irecv``. At D = 2 offsets 1 and D - 1 coincide and
    the plan keeps one. Under gloo the rows are staged through the host."""
    D = dist.get_world_size(group)
    s = dist.get_rank(group)
    staged = _staged(group)
    ops, recvs = [], []
    for sidx, o in zip(send_idx, offsets):
        buf = nodes.index_select(0, sidx.to(nodes.device).long())
        if staged:
            buf = buf.cpu()
        rbuf = torch.empty_like(buf)
        dst = dist.get_global_rank(group, (s + o) % D)
        src = dist.get_global_rank(group, (s - o) % D)
        ops += [dist.P2POp(dist.isend, buf.contiguous(), dst, group),
                dist.P2POp(dist.irecv, rbuf, src, group)]
        recvs.append(rbuf)
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Exchange(works, recvs, nodes.device, lanes, nodes)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (``jax.lax.psum``), on
    ``x``'s device; staged through the host under gloo."""
    y = x.cpu() if _staged(group) and x.is_cuda else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


# all_gather_into_tensor, under the name newer PyTorch releases give it
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[D * m, ...]: every rank's ``x`` [m, ...] in rank order
    (``all_gather_into_tensor``), on ``x``'s device; staged through the host
    under gloo."""
    src = x.cpu() if _staged(group) and x.is_cuda else x.contiguous()
    out = torch.empty((dist.get_world_size(group) * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_single(out, src.contiguous(), group=group)
    return out.to(x.device)


# -- the forwards ------------------------------------------------------------------


def _graph_group(mesh: Mesh, axis: str, n_shards: int):
    group = mesh.group(axis)
    if group is None or dist.get_world_size(group) != n_shards:
        raise ValueError(f"the plan has {n_shards} shards, the mesh's {axis!r} axis "
                         f"{mesh.shape.get(axis)} (is the process group running?)")
    return group


def _own(graph: Graph, s: int, m: int, device) -> Graph:
    """Shard s's rows [s m, (s + 1) m) of the whole graph, on ``device``."""
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
    return Graph(*[torch.as_tensor(np.asarray(a[s * m:(s + 1) * m]) if not isinstance(
        a, torch.Tensor) else a[s * m:(s + 1) * m]).to(device=device, dtype=dt).contiguous()
        for a, dt in zip(graph, dtypes)])


def _shard_readout(params, config: ModelConfig, atoms, nodes) -> torch.Tensor:
    """FC block, head and de-standardization in float32, as the JAX
    package's partitioned forwards compute them (``_dense`` at its default
    type): peaks f32[m]."""
    fc_act = get_activation(config.fc_activation)
    for p in params["fc"][:-1]:
        nodes = dense(p, nodes, fc_act) + nodes
    nodes = dense(params["fc"][-1], nodes, fc_act)
    full = dense(params["out"], nodes)
    std, avg = params["peak_std"].detach(), params["peak_avg"].detach()
    return torch.sum(full * atoms * std + atoms * avg, dim=-1)


def _edge_stage(params, config: ModelConfig, edges) -> torch.Tensor:
    """f32[m, K, E]: RBF + EdgeFC in float32, masked by ``edges > 0``
    (the JAX partitioned forwards' exact edge stage)."""
    return edge_features(edges, params["edge_fc"], rbf_low=config.rbf_low,
                         rbf_high=config.rbf_high, activation_name=config.fc_activation)


class _PaddingTerm:
    """The attention padding term of one shard in the ``gnn.apply`` form:
    the rows ``rows`` (global ids, sorted) that padding slots name, and
    this shard's slots' one-hot [m, K, R] over them."""

    def __init__(self, graph: Graph, own_nlist, real, s: int, m: int, device):
        pad_rows = padding_rows(graph.nlist, graph.edges)
        self.rows = torch.as_tensor(pad_rows, dtype=torch.int64).to(device)
        self.slots = (_padding_slots(own_nlist, real, self.rows) if self.rows.numel() else None)
        self.lo, self.hi = s * m, (s + 1) * m

    def add(self, upd, a, nodes, wv, group) -> torch.Tensor:
        """``upd`` + c @ (nodes[rows] @ wv): c [m, R] this shard's padding
        weights; the rows' projections summed over the group (each row
        lives on one shard)."""
        if self.slots is None:
            return upd
        mine = (self.rows >= self.lo) & (self.rows < self.hi)
        local = torch.zeros((self.rows.shape[0], nodes.shape[1]), dtype=nodes.dtype,
                            device=nodes.device)
        local[mine] = nodes[self.rows[mine] - self.lo]
        proj = psum(local @ wv, group)                        # [R, F]
        c = torch.einsum("ij,ijp->ip", a, self.slots)         # [m, R]
        return upd + c @ proj


def shard_arrays(plan, s: int, device) -> tuple:
    """Shard ``s``'s rows of a plan's index arrays, on ``device`` (int32):
    (send_idx per offset, local_nlist) of a ``HaloPlan``, and of a
    ``BandedHaloPlan`` also (lo, boundary_ids, halo_lo)."""
    base = plan.halo if isinstance(plan, BandedHaloPlan) else plan
    out = ([torch.as_tensor(si[s]).to(device) for si in base.send_idx],
           torch.as_tensor(base.local_nlist[s]).to(device))
    if isinstance(plan, BandedHaloPlan):
        out += tuple(torch.as_tensor(a[s]).to(device)
                     for a in (plan.lo, plan.boundary_ids, plan.halo_lo))
    return out


def apply_partitioned_halo(
    params,
    config: ModelConfig,
    graph: Graph,
    plan: HaloPlan,
    mesh: Mesh,
    axis: str = "graph",
    arrays=None,
) -> torch.Tensor:
    """Forward with halo-exchange message passing in plain PyTorch, both
    MP families; peaks f32[N] of the whole structure on every rank.

    ``graph`` is the whole structure (host arrays or tensors), padded to
    ``plan.n_shards * plan.rows_per_shard`` atoms; this rank runs the rows
    of its position on ``axis``, on the device of ``params``. Each MP layer
    exchanges the boundary rows (``ring_exchange``), gathers the workspace
    [own rows | received rows] by the plan's local neighbor lists and
    aggregates as ``gnn.apply`` does (the JAX package's XLA path, taken by a
    shard past ``ServingModel._partitioned_fits_vmem``). Attention: the
    softmax runs over the shard's own rows and edge features; padding
    slots in the ``gnn.apply`` form (the rows they name found from
    ``graph``). ``arrays``: this shard's plan arrays on the device
    (``shard_arrays``), if at hand."""
    D, m = plan.n_shards, plan.rows_per_shard
    group = _graph_group(mesh, axis, D)
    s = dist.get_rank(group)
    dev = params["embed"]["kernel"].device
    atoms, gnl, edges, inv = _own(graph, s, m, dev)
    send, lnl = arrays if arrays is not None else shard_arrays(plan, s, dev)
    mp_act = get_activation(config.mp_activation)
    cd = compute_dtype(config)
    real = edges > 0
    e = _edge_stage(params, config, edges)
    nodes = dense(params["embed"], atoms)
    attention = config.mp_type == "attention"
    term = _PaddingTerm(graph, gnl, real, s, m, dev) if attention else None
    for p in params["mp"]:
        recv = ring_exchange(nodes, send, plan.offsets, group).wait()
        workspace = torch.cat([nodes, recv], 0)
        if attention:
            a = attention_weights(p["wq"], p["wk"], nodes, e, inv)     # [m, K]
            gathered = workspace[lnl.long()]                           # [m, K, F]
            upd = torch.einsum("ij,ijl->il", torch.where(real, a, 0.0), gathered) @ p["wv"]
            upd = term.add(upd, a, nodes, p["wv"], group)
        else:
            upd = mp_aggregate(workspace, lnl, e, inv, p["w"], cd)
        nodes = mp_act(upd) + nodes
    return all_gather_rows(_shard_readout(params, config, atoms, nodes), group)


def apply_partitioned_banded(
    params,
    config: ModelConfig,
    graph: Graph,
    plan: BandedHaloPlan,
    mesh: Mesh,
    axis: str = "graph",
    use_kernels: bool = True,
    differentiable: bool = False,
    training: bool = False,
    cheb: Optional[EdgeCheb] = None,
    arrays=None,
) -> torch.Tensor:
    """Multi-GPU forward with per-shard banded MP through the kernels and
    the halo exchange overlapped with the interior band; peaks f32[N] of
    the whole structure on every rank, equal to the single-device forward
    in float32.

    ``graph`` is the whole structure, RCM-ordered and padded to
    ``D * rows_per_shard`` atoms (``make_banded_halo_plan``); this rank runs
    the rows of its position on ``axis``, on the device of ``params``.
    With ``use_kernels`` (the default) the band builds and the MP layers go
    through the kernel wrappers of ``ops/banded.py``, B7a
    (``build_band_tracedlo``), B7b (``build_band_poly_tracedlo``) and B6
    (``mp_banded_partial``): the CUDA kernels on the card, their plain
    versions on the CPU; ``use_kernels=False`` runs the plain versions.
    See ``_make_banded_shard_fwd`` for a shard's steps.

    ``cheb`` (the bilinear family, inference) replaces the exact edge
    stage by its Chebyshev evaluation inside the band builds (B7b), as
    single-card "fast" serving does. ``arrays``: this shard's plan arrays
    on the device (``shard_arrays``), if at hand. ``differentiable``
    and ``training`` (partitioned training) belong to the next slice of the
    port and raise."""
    if differentiable or training:
        raise NotImplementedError(
            "partitioned training (differentiable=, training=) is not ported yet: "
            "it is the next slice (ROADMAP queue A)")
    if cheb is not None and config.mp_type == "attention":
        raise ValueError(
            "cheb (compressed edge stage) is bilinear-family-only: the attention family "
            "consumes the exact edge features")
    D, m = plan.halo.n_shards, plan.halo.rows_per_shard
    group = _graph_group(mesh, axis, D)
    s = dist.get_rank(group)
    shard_fwd = _make_banded_shard_fwd(config, plan, group, use_kernels, cheb)
    dev = params["embed"]["kernel"].device
    own = _own(graph, s, m, dev)
    send, lnl, lo, bids, hlo = arrays if arrays is not None else shard_arrays(plan, s, dev)
    term = (_PaddingTerm(graph, own.nlist, own.edges > 0, s, m, dev)
            if config.mp_type == "attention" else None)
    with torch.no_grad():
        peaks = shard_fwd(params, send, own, lnl, lo, bids, hlo, term)
    return all_gather_rows(peaks, group)


def _make_banded_shard_fwd(config: ModelConfig, plan: BandedHaloPlan, group,
                           use_kernels: bool = True, cheb: Optional[EdgeCheb] = None):
    """The per-shard banded forward: takes this shard's rows and plan
    arrays and returns its [m] peaks.

    Bilinear family, exact: the RBF + EdgeFC edge stage in plain PyTorch
    (float32, as the JAX package's XLA stage), then two B7a launches, the
    interior band over the shard's own rows and the halo band over its
    boundary tiles with ``nlist - m`` (interior indices go negative and
    match nothing). Fast (``cheb``): two B7b launches straight from the
    distances instead. The bands' chunk occupancy is made once each. Then
    per MP layer:
      1. post the ring exchange of the boundary rows;
      2. B6 over the interior band (own rows; no dependency on the
         exchange);
      3. wait for the exchange;
      4. B6 over the halo band on the received rows;
      5. ``index_add_`` of its rows into the boundary tiles' rows;
      6. nodes = act(acc * inv_degree) + nodes (float32).
    Attention: per layer the softmax weights (float32) of the real slots
    built into two E = 1 bands (two B7a), two B6 launches with wv, the
    padding term (``_PaddingTerm``), the activation and the residual.

    Overlap: under NCCL the exchange runs on NCCL's own stream, so the
    interior B6 overlaps it on the card. Under gloo the send rows are
    copied to the host first (which waits for the previous layer), gloo's
    threads move them while the interior B6 runs on the card, and the
    received rows are copied back after the wait."""
    base = plan.halo
    m = base.rows_per_shard
    B, W = plan.block_rows, plan.window
    DH, Wh = plan.halo_lanes, plan.halo_window
    cd = compute_dtype(config)
    mp_act = get_activation(config.mp_activation)
    attention = config.mp_type == "attention"
    if use_kernels:
        build, build_poly = banded.build_band_tracedlo, banded.build_band_poly_tracedlo
        partial, occupancy = banded.mp_banded_partial, banded.band_occupancy
    else:
        build, build_poly = banded.build_band_tracedlo_plain, banded.build_band_poly_tracedlo_plain
        partial, occupancy = banded.mp_banded_partial_plain, None

    def shard_fwd(params, send, own: Graph, lnl, lo, bids, hlo, term):
        atoms, _, edges, inv = own
        dev = atoms.device
        real = edges > 0
        rows = (bids.long()[:, None] * B + torch.arange(B, device=dev)[None, :]).reshape(-1)
        lnl_h = lnl[rows] - m  # boundary tiles' rows, indices into the received rows
        edges_h = edges[rows]
        occ_int = occ_halo = None
        if occupancy is not None:
            occ_int = occupancy(lnl, edges, lo, W, B, m)
            occ_halo = occupancy(lnl_h, edges_h, hlo, Wh, B, rows.shape[0])
        e = None
        if cheb is not None:
            M_int = build_poly(lnl, edges, cheb, lo, W, B, out_dtype=cd)
            M_halo = build_poly(lnl_h, edges_h, cheb, hlo, Wh, B, out_dtype=cd)
        else:
            e = _edge_stage(params, config, edges)
            if not attention:
                M_int = build(lnl, e, lo, W, B, out_dtype=cd)
                M_halo = build(lnl_h, e[rows].contiguous(), hlo, Wh, B, out_dtype=cd)
        nodes = dense(params["embed"], atoms)  # [m, F] float32
        inv_col = inv[:, None]
        for p in params["mp"]:
            pending = ring_exchange(nodes, send, base.offsets, group, lanes=DH)  # 1)
            if attention:
                a = attention_weights(p["wq"], p["wk"], nodes, e, inv)
                a_band = torch.where(real, a, 0.0)[..., None]
                wv3 = p["wv"][:, :, None]
                Ma_int = build(lnl, a_band, lo, W, B, out_dtype=cd)
                Ma_halo = build(lnl_h, a_band[rows].contiguous(), hlo, Wh, B, out_dtype=cd)
                acc = partial(Ma_int, lo, nodes.to(cd), wv3, occ_int)
                halo_nodes = pending.wait()
                acc.index_add_(0, rows, partial(Ma_halo, hlo, halo_nodes.to(cd), wv3, occ_halo))
                upd = term.add(acc, a, nodes, p["wv"], group)
                nodes = mp_act(upd) + nodes
            else:
                acc = partial(M_int, lo, nodes.to(cd), p["w"], occ_int)         # 2)
                halo_nodes = pending.wait()                                      # 3)
                acc_halo = partial(M_halo, hlo, halo_nodes.to(cd), p["w"], occ_halo)  # 4)
                acc.index_add_(0, rows, acc_halo)                                # 5)
                nodes = mp_act(acc * inv_col) + nodes                            # 6)
        return _shard_readout(params, config, atoms, nodes)

    return shard_fwd
