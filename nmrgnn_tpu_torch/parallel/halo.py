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
from ..models.gnn import compute_dtype, dense, readout
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
#
# Each collective that training differentiates through is a
# torch.autograd.Function with the transpose ``shard_map`` gives the JAX
# package's (``nmrgnn_tpu/parallel/halo.py:570-592``, ``:686``, its peaks'
# out_specs). The public functions take the Function only when autograd
# records, so the serving forwards (under ``torch.no_grad``) run the plain
# calls.


def _staged(group) -> bool:
    """Whether CUDA buffers go through the host: under gloo, whose send
    and receive take host tensors."""
    return dist.get_backend(group) == "gloo"


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _ring(bufs: Sequence[torch.Tensor], offsets: Sequence[int], group, reverse: bool):
    """One send/receive pair per offset in one ``batch_isend_irecv``: buffer
    i goes to (s + o_i) % D (``reverse``: to (s - o_i) % D) and as many rows
    come from the other side; returns the posted works and the receive
    buffers (on the host under gloo)."""
    D = dist.get_world_size(group)
    s = dist.get_rank(group)
    staged = _staged(group)
    ops, recvs = [], []
    for buf, o in zip(bufs, offsets):
        o = -o if reverse else o
        buf = (buf.cpu() if staged else buf).contiguous()
        rbuf = torch.empty_like(buf)
        ops += [dist.P2POp(dist.isend, buf, dist.get_global_rank(group, (s + o) % D), group),
                dist.P2POp(dist.irecv, rbuf, dist.get_global_rank(group, (s - o) % D), group)]
        recvs.append(rbuf)
    works = dist.batch_isend_irecv(ops) if ops else []
    return works, recvs


class _Exchange:
    """A posted ring exchange: ``wait()`` returns the received rows
    [lanes, F], concatenated in offset order and zero-padded; differentiable
    in the posted ``nodes`` when autograd records them (``_RingExchange``)."""

    def __init__(self, nodes, send_idx, offsets, group, lanes: int):
        self.nodes, self.send_idx, self.offsets = nodes, send_idx, offsets
        self.group, self.lanes = group, lanes
        self._works, self._recvs = _ring(
            [nodes.detach().index_select(0, si) for si in send_idx], offsets, group, False)

    def received(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        F = self.nodes.shape[1]
        h = (torch.cat(self._recvs, 0) if self._recvs
             else torch.zeros((0, F), dtype=self.nodes.dtype))
        h = h.to(self.nodes.device, non_blocking=False)
        pad = self.lanes - h.shape[0]
        return nnf.pad(h, (0, 0, 0, pad)) if pad > 0 else h

    def wait(self) -> torch.Tensor:
        if _records(self.nodes):
            return _RingExchange.apply(self.nodes, self)
        return self.received()


class _RingExchange(torch.autograd.Function):
    """The received rows of a posted exchange, with the reverse ring as
    backward (``ppermute``'s transpose): the cotangent of the rows received
    at offset o goes back to (s - o) % D, which adds the rows it gets into
    its ``nodes`` cotangent at ``send_idx`` (out of place: a row can be
    sent at several offsets). The zero-padded lanes get no gradient."""

    @staticmethod
    def forward(ctx, nodes, ex):
        ctx.ex = ex
        return ex.received()

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        sizes = [int(si.shape[0]) for si in ex.send_idx]
        segs = list(torch.split(g[:sum(sizes)], sizes, 0)) if sizes else []
        works, recvs = _ring(segs, ex.offsets, ex.group, True)
        for w in works:
            w.wait()
        gn = torch.zeros_like(ex.nodes)
        for si, r in zip(ex.send_idx, recvs):
            gn = gn.index_add(0, si, r.to(g.device, g.dtype))
        return gn, None


def ring_exchange(nodes: torch.Tensor, send_idx: Sequence[torch.Tensor], offsets: Sequence[int],
                  group, lanes: int = 0) -> _Exchange:
    """Post the ring exchange of this shard's boundary rows and return at
    once; ``.wait()`` gives the received rows [max(lanes, sum H_o), F].

    For each kept offset o (``plan.offsets``, in order, the same on every
    rank), shard s sends ``nodes[send_idx[i]]`` ([H_o] local row ids,
    this shard's row of the plan's ``send_idx[i]``) to (s + o) % D and
    receives H_o rows from (s - o) % D, one ``P2POp`` pair each, all in one
    ``dist.batch_isend_irecv``. At D = 2 offsets 1 and D - 1 coincide and
    the plan keeps one. Under gloo the rows are staged through the host.
    When autograd records ``nodes``, ``.wait()`` is differentiable: its
    backward is the reverse ring (``_RingExchange``)."""
    send_idx = [si.to(nodes.device).long() for si in send_idx]
    return _Exchange(nodes, send_idx, offsets, group, lanes)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x.clone()
    y = x.cpu() if _staged(group) and x.is_cuda else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


class _PSum(torch.autograd.Function):
    """``psum`` with its transpose: the cotangent is summed over the group
    too, because each rank consumes the sum on its own rows and so holds a
    cotangent of its own."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (``jax.lax.psum``), on
    ``x``'s device; staged through the host under gloo. Differentiable
    (``_PSum``) when autograd records ``x``; ``group`` None is one process."""
    return _PSum.apply(x, group) if _records(x) else _psum(x, group)


# all_gather_into_tensor, under the name newer PyTorch releases give it
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x.clone()
    src = x.cpu() if _staged(group) and x.is_cuda else x.contiguous()
    out = torch.empty((dist.get_world_size(group) * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_single(out, src.contiguous(), group=group)
    return out.to(x.device)


class _AllGatherRows(torch.autograd.Function):
    """``all_gather_rows`` whose backward is this rank's slice of the
    cotangent: every rank computes the same loss from the gathered rows
    (the JAX package's loss on the whole [N] peaks), so a reduce-scatter
    would count each gradient once a rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.rank = x.shape[0], 0 if group is None else dist.get_rank(group)
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[D * m, ...]: every rank's ``x`` [m, ...] in rank order
    (``all_gather_into_tensor``), on ``x``'s device; staged through the host
    under gloo. Differentiable when autograd records ``x``, with this
    rank's slice of the cotangent as backward (``_AllGatherRows``)."""
    return _AllGatherRows.apply(x, group) if _records(x) else _all_gather(x, group)


def psum_grads(grads: Sequence[torch.Tensor], group) -> list:
    """The gradients of replicated parameters summed over the group, in one
    ``all_reduce`` of their concatenation (the transpose of ``shard_map``'s
    replicated ``P()`` inputs); ``group`` None or of one rank: as given."""
    grads = list(grads)
    if group is None or dist.get_world_size(group) == 1 or not grads:
        return grads
    flat = _psum(torch.cat([g.reshape(-1).float() for g in grads]), group)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
        i += g.numel()
    return out


def shard_seed(rng: int, stream: int, shard: int) -> int:
    """The seed of shard ``shard``'s ``stream`` (1 noise, 2 dropout) under
    the step key ``rng``: the JAX package folds the shard index into the
    key (``halo.py:597-601``, ``:709-713``); torch cannot draw threefry
    numbers, so the shard's generator is seeded from (rng, stream, shard)."""
    return int(np.random.SeedSequence([int(rng), stream, shard]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def shard_draws(config: ModelConfig, rng, shard: int, m: int, K: int, device,
                noise=None, dropout_mask=None):
    """(noise [m, K] or None, dropout_mask [m, F // 2] or None) of shard
    ``shard``'s rows in a training forward: this shard's rows of the given
    whole-structure draws, else draws from ``torch.Generator``s on
    ``device`` seeded by ``shard_seed(rng, 1 | 2, shard)``."""
    rows = slice(shard * m, (shard + 1) * m)
    F2 = config.atom_feature_size // 2

    def gen(stream):
        if rng is None:
            raise ValueError("training=True requires rng (or the draws)")
        return torch.Generator(device=device).manual_seed(shard_seed(rng, stream, shard))

    out_noise = out_mask = None
    if config.noise > 0:
        out_noise = (torch.as_tensor(noise)[rows].to(device) if noise is not None
                     else torch.randn((m, K), generator=gen(1), device=device))
    if config.dropout:
        keep = 1.0 - config.dropout_rate
        out_mask = (torch.as_tensor(dropout_mask)[rows].to(device) if dropout_mask is not None
                    else torch.rand((m, F2), generator=gen(2), device=device) < keep)
    return out_noise, out_mask


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


def _shard_readout(params, config: ModelConfig, atoms, nodes, dropout_mask=None) -> torch.Tensor:
    """``gnn.readout`` in float32, as the JAX package's partitioned
    forwards compute it (``_dense`` at its default type): peaks f32[m]."""
    return readout(params, config.replace(compute_dtype="float32"), atoms, nodes,
                   dropout_mask=dropout_mask)


def _edge_stage(params, config: ModelConfig, edges, noise=None) -> torch.Tensor:
    """f32[m, K, E]: RBF + EdgeFC in float32 of ``edges`` plus ``noise``
    times ``config.noise`` (the training noise, or None), masked by the
    distances before the noise (the JAX partitioned forwards' exact edge
    stage)."""
    mask = (edges > 0).to(torch.float32)[..., None]
    d = edges if noise is None else edges + config.noise * noise
    return edge_features(d, params["edge_fc"], rbf_low=config.rbf_low,
                         rbf_high=config.rbf_high, activation_name=config.fc_activation,
                         mask=mask)


class _PaddingTerm:
    """The attention padding term of one shard in the ``gnn.apply`` form:
    the rows ``rows`` (global ids, sorted) that padding slots name
    (``pad_rows``, else found from ``graph``), and this shard's slots'
    one-hot [m, K, R] over them."""

    def __init__(self, graph: Graph, own_nlist, real, s: int, m: int, device, pad_rows=None):
        if pad_rows is None:
            pad_rows = padding_rows(graph.nlist, graph.edges)
        pad_rows = np.asarray(pad_rows, np.int64)
        self.rows = torch.as_tensor(pad_rows).to(device)
        self.slots = (_padding_slots(own_nlist, real, self.rows) if self.rows.numel() else None)
        mine = (pad_rows >= s * m) & (pad_rows < (s + 1) * m)
        # the positions among ``rows`` of this shard's rows, and their local ids
        self.pick = torch.as_tensor(np.nonzero(mine)[0]).to(device)
        self.local = torch.as_tensor(pad_rows[mine] - s * m).to(device)

    def add(self, upd, a, nodes, wv, group) -> torch.Tensor:
        """``upd`` + c @ (nodes[rows] @ wv): c [m, R] this shard's padding
        weights; the rows' projections summed over the group (each row
        lives on one shard; under autograd the sum's backward sums the
        shards' cotangents, ``_PSum``)."""
        if self.slots is None:
            return upd
        local = torch.zeros((self.rows.shape[0], nodes.shape[1]), dtype=nodes.dtype,
                            device=nodes.device).index_copy(
                                0, self.pick, nodes.index_select(0, self.local))
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
    rng=None,
    noise=None,
    dropout_mask=None,
    pad_rows=None,
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
    on the device (``shard_arrays``), if at hand. ``pad_rows``: the rows the
    attention family's padding slots name (``models/infer.padding_rows``),
    else found from ``graph``.

    ``differentiable`` runs B7a and B6 through their autograd wrappers
    (``build_band_tracedlo_df``, ``mp_banded_partial_df``: the kernels
    forward, plain PyTorch backward) and the collectives through theirs
    (the exchange's backward is the reverse ring, the peaks' all-gather
    hands back this rank's slice), so that ``torch.autograd`` flows through
    the whole partitioned forward: graph-partitioned training. The
    gradient of each replicated parameter is then this rank's share; sum
    them over the axis's group (``psum_grads``).

    ``training`` applies the distance noise before the edge stage and the
    readout dropout, with shard-local draws (``shard_draws``: generators
    seeded from (``rng``, stream, shard), as the JAX package folds the
    shard index into its key; the whole-structure draws differ from a
    single-device run's but have its distribution), or this shard's rows of
    the whole-structure ``noise`` [N, K] and ``dropout_mask`` [N, F // 2]
    where given. The padding mask and the bands' occupancy come from the
    distances before the noise."""
    if cheb is not None and (differentiable or training or config.mp_type == "attention"):
        raise ValueError(
            "cheb (compressed edge stage) is inference-only and bilinear-family-only: the "
            "poly build has no backward and the attention family consumes the exact edge "
            "features")
    D, m = plan.halo.n_shards, plan.halo.rows_per_shard
    group = _graph_group(mesh, axis, D)
    s = dist.get_rank(group)
    shard_fwd = _make_banded_shard_fwd(config, plan, group, use_kernels, cheb, differentiable)
    dev = params["embed"]["kernel"].device
    own = _own(graph, s, m, dev)
    send, lnl, lo, bids, hlo = arrays if arrays is not None else shard_arrays(plan, s, dev)
    term = (_PaddingTerm(graph, own.nlist, own.edges > 0, s, m, dev, pad_rows)
            if config.mp_type == "attention" else None)
    draws = (shard_draws(config, rng, s, m, own.nlist.shape[1], dev, noise, dropout_mask)
             if training else (None, None))
    with torch.enable_grad() if differentiable else torch.no_grad():
        peaks = shard_fwd(params, send, own, lnl, lo, bids, hlo, term, *draws)
    return all_gather_rows(peaks, group)


def _make_banded_shard_fwd(config: ModelConfig, plan: BandedHaloPlan, group,
                           use_kernels: bool = True, cheb: Optional[EdgeCheb] = None,
                           differentiable: bool = False):
    """The per-shard banded forward: takes this shard's rows and plan
    arrays (and its training draws, or None) and returns its [m] peaks.

    Bilinear family, exact: the RBF + EdgeFC edge stage in plain PyTorch
    (float32, as the JAX package's XLA stage), then two B7a launches, the
    interior band over the shard's own rows and the halo band over its
    boundary tiles with ``nlist - m`` (interior indices go negative and
    match nothing). Fast (``cheb``): two B7b launches straight from the
    distances instead. The bands' chunk occupancy is made once each, from
    the distances before any noise. Then per MP layer:
      1. post the ring exchange of the boundary rows;
      2. B6 over the interior band (own rows; no dependency on the
         exchange);
      3. wait for the exchange;
      4. B6 over the halo band on the received rows;
      5. add its rows into the boundary tiles' rows (``index_add_``, or
         out of place under autograd);
      6. nodes = act(acc * inv_degree) + nodes (float32).
    Attention: per layer the softmax weights (float32) of the real slots
    built into two E = 1 bands (two B7a), two B6 launches with wv, the
    padding term (``_PaddingTerm``), the activation and the residual.
    ``differentiable``: B7a and B6 through ``build_band_tracedlo_df`` and
    ``mp_banded_partial_df`` (the plain versions under autograd without
    ``use_kernels``).

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
    if differentiable and use_kernels:
        build, build_poly = banded.build_band_tracedlo_df, None
        partial, occupancy = banded.mp_banded_partial_df, banded.band_occupancy
    elif use_kernels:
        build, build_poly = banded.build_band_tracedlo, banded.build_band_poly_tracedlo
        partial, occupancy = banded.mp_banded_partial, banded.band_occupancy
    else:
        build, build_poly = banded.build_band_tracedlo_plain, banded.build_band_poly_tracedlo_plain
        partial, occupancy = banded.mp_banded_partial_plain, None

    def add_rows(acc, rows, part):
        return acc.index_add(0, rows, part) if differentiable else acc.index_add_(0, rows, part)

    def shard_fwd(params, send, own: Graph, lnl, lo, bids, hlo, term, noise=None,
                  dropout_mask=None):
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
            e = _edge_stage(params, config, edges, noise)
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
                acc = add_rows(acc, rows, partial(Ma_halo, hlo, halo_nodes.to(cd), wv3,
                                                  occ_halo))
                upd = term.add(acc, a, nodes, p["wv"], group)
                nodes = mp_act(upd) + nodes
            else:
                acc = partial(M_int, lo, nodes.to(cd), p["w"], occ_int)         # 2)
                halo_nodes = pending.wait()                                      # 3)
                acc_halo = partial(M_halo, hlo, halo_nodes.to(cd), p["w"], occ_halo)  # 4)
                acc = add_rows(acc, rows, acc_halo)                              # 5)
                nodes = mp_act(acc * inv_col) + nodes                            # 6)
        return _shard_readout(params, config, atoms, nodes, dropout_mask)

    return shard_fwd


def _take(tables, idx):
    """Entry ``idx`` (an int) or entries ``idx`` (an int array) of stacked
    operands: a Graph of them, a tensor, an array or a sequence (None
    passes through)."""
    if tables is None:
        return None
    if isinstance(tables, Graph):
        return Graph(*[_take(a, idx) for a in tables])
    if isinstance(tables, torch.Tensor) and not isinstance(idx, int):
        return tables[torch.as_tensor(np.asarray(idx), device=tables.device)]
    return tables[idx]


def apply_partitioned_banded_batch(
    params,
    config: ModelConfig,
    graphs: Graph,
    plan: BandedHaloPlan,
    mesh: Mesh,
    axis: str = "graph",
    data_axis: str = "data",
    use_kernels: bool = True,
    differentiable: bool = False,
    arrays=None,
    training: bool = False,
    rngs=None,
    cheb: Optional[EdgeCheb] = None,
    noise=None,
    dropout_mask=None,
    pad_rows=None,
) -> torch.Tensor:
    """Data-batched partitioned forward: S = ``mesh.shape[data_axis]``
    structures of the plan's shapes, one a data index, each split over
    the ``axis`` ranks of its line (``apply_partitioned_banded``), so that
    a (data=2, graph=4) mesh computes two whole structures at once.

    ``graphs`` (a Graph of [S, N, ...]), ``rngs`` [S], ``noise`` [S, N, K],
    ``dropout_mask`` [S, N, F // 2] and ``pad_rows`` (S sequences) carry a
    leading structure dim; ``arrays`` is S per-structure tuples of this
    shard's plan arrays (``shard_arrays``) or None for the plan's. Returns
    peaks f32[S, N] on every rank: the structures' peaks gathered over the
    data group (differentiable as ``all_gather_rows``).

    The JAX form runs in one process only (``halo.py:755-758``); here every
    rank is a process, so the restriction has no counterpart."""
    S = int(mesh.shape[data_axis])
    if len(graphs.atoms) != S:
        raise ValueError(f"batch dim {len(graphs.atoms)} != mesh {data_axis} size {S}")
    d = mesh.index(data_axis)
    peaks = apply_partitioned_banded(
        params, config, _take(graphs, d), plan, mesh, axis=axis, use_kernels=use_kernels,
        differentiable=differentiable, training=training, cheb=cheb,
        arrays=_take(arrays, d), rng=_take(rngs, d), noise=_take(noise, d),
        dropout_mask=_take(dropout_mask, d), pad_rows=_take(pad_rows, d))
    return all_gather_rows(peaks[None], mesh.group(data_axis) if S > 1 else None)


def _as_device(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a).to(
        device=device, dtype=dtype)


def make_partitioned_train_step(
    config: ModelConfig,
    loss_idx,
    plan: BandedHaloPlan,
    mesh: Mesh,
    axis: str = "graph",
    loss_balance: float = 1.0,
    training: bool = False,
    data_axis: Optional[str] = None,
    use_kernels: bool = True,
):
    """Whole-structure (graph-partitioned) training step: NameLoss and
    ``torch.autograd`` through the differentiable partitioned forward
    (``apply_partitioned_banded(differentiable=True)``: B7a and B6 through
    their autograd wrappers, the exchange's reverse ring), the replicated
    parameters' gradients summed over the ``axis`` group (``psum_grads``),
    then the optimizer's step.

    Returns ``step(params, opt, graph, y, w, rng=None, arrays=None,
    noise=None, dropout_mask=None, pad_rows=None) -> loss`` (a device
    tensor; no host wait). ``opt`` is a ``torch.optim.Adam`` over
    ``gnn.trainable_leaves(params)`` (``Trainer.optimizer``): the JAX
    package's optax ``tx`` and its state in one object; ``params`` are
    updated in place. ``y`` is the [N, 3] label block (shift, name index,
    labeled flag), ``w`` the [N] sample weights, both padded like the
    graph. ``training`` turns on the noise and dropout with shard-local
    draws (``rng`` a step's int key, or the whole-structure draws);
    ``arrays``, ``pad_rows``: as ``apply_partitioned_banded``'s.

    ``data_axis`` (e.g. "data"): the data-batched step. Every structure
    operand gains a leading dim S = ``mesh.shape[data_axis]``, each data
    index trains its own structure (``apply_partitioned_banded_batch``),
    the loss is the mean of the S NameLosses (computed on every rank from
    the gathered [S, N] peaks) and the gradient their mean: each rank's
    share summed over the graph group, then over the data group."""
    from ..models import gnn
    from ..train.losses import name_loss
    from ..train.trainer import fold_sample_weight

    groups = [mesh.group(axis)] + ([mesh.group(data_axis)] if data_axis else [])

    def loss_fn(params, graph, y, w, rng, arrays, noise, dropout_mask, pad_rows):
        dev = params["embed"]["kernel"].device
        y, w = _as_device(y, dev), _as_device(w, dev)
        kw = dict(axis=axis, use_kernels=use_kernels, differentiable=True, training=training,
                  arrays=arrays, noise=noise, dropout_mask=dropout_mask, pad_rows=pad_rows)
        if data_axis is None:
            peaks = apply_partitioned_banded(params, config, graph, plan, mesh, rng=rng, **kw)
            return name_loss(fold_sample_weight(y, w), peaks, loss_idx, s=loss_balance)
        peaks = apply_partitioned_banded_batch(params, config, graph, plan, mesh,
                                               data_axis=data_axis, rngs=rng, **kw)
        yt = fold_sample_weight(y, w)
        return torch.stack([name_loss(yt[i], peaks[i], loss_idx, s=loss_balance)
                            for i in range(peaks.shape[0])]).mean()

    def step(params, opt, graph, y, w, rng=None, arrays=None, noise=None, dropout_mask=None,
             pad_rows=None) -> torch.Tensor:
        leaves = gnn.trainable_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(params, graph, y, w, rng, arrays, noise, dropout_mask, pad_rows)
        grads = torch.autograd.grad(loss, leaves)
        for g in groups:
            grads = psum_grads(grads, g)
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
        return loss.detach()

    return step


def make_partitioned_epoch_fn(
    config: ModelConfig,
    loss_idx,
    plan: BandedHaloPlan,
    mesh: Mesh,
    axis: str = "graph",
    loss_balance: float = 1.0,
    training: bool = True,
    data_axis: Optional[str] = None,
    ema_decay: float = 0.0,
    use_kernels: bool = True,
):
    """Whole-epoch training over a device-resident frame table (the JAX
    package's ``lax.scan`` of the step): the partitioned train step over F
    same-shape structures in ``order``, the EMA updated each step when
    ``ema_decay`` > 0, the losses kept on the device (no host wait a step;
    the caller reads them back once an epoch).

    Returns ``epoch(params, opt, ema, graphs, ys, ws, rngs, arrays, order,
    pad_rows=None) -> losses``: ``graphs`` a Graph of [F, N, ...] tensors,
    ``ys`` [F, N, 3], ``ws`` [F, N], ``rngs`` [F] int keys, ``arrays`` F
    tuples of this shard's plan arrays (``shard_arrays``, each frame's own
    device tensors), ``order`` the epoch's int shuffle [F], ``pad_rows``
    (attention) F sequences.
    ``params`` and ``ema`` (a params tree, or None) are updated in place.
    With ``data_axis`` F must divide by S = ``mesh.shape[data_axis]``: each
    step takes the next S frames of the shuffle, one a data index, giving
    losses f32[F / S] (each the mean of S); otherwise f32[F]."""
    from ..models import gnn

    step = make_partitioned_train_step(config, loss_idx, plan, mesh, axis=axis,
                                       loss_balance=loss_balance, training=training,
                                       data_axis=data_axis, use_kernels=use_kernels)
    S = int(mesh.shape[data_axis]) if data_axis is not None else 1

    def epoch(params, opt, ema, graphs, ys, ws, rngs, arrays, order, pad_rows=None):
        order = np.asarray(order)
        xs = order if data_axis is None else order.reshape(-1, S)
        losses = []
        for idx in xs:
            pick = int(idx) if data_axis is None else idx
            frames = [pick] if data_axis is None else [int(i) for i in idx]
            arr = [arrays[f] for f in frames]
            pad = None if pad_rows is None else [pad_rows[f] for f in frames]
            losses.append(step(
                params, opt, _take(graphs, pick), _take(ys, pick), _take(ws, pick),
                rng=_take(None if rngs is None else np.asarray(rngs), pick),
                arrays=arr[0] if data_axis is None else arr,
                pad_rows=None if pad is None else (pad[0] if data_axis is None else pad)))
            if ema_decay > 0 and ema is not None:
                with torch.no_grad():
                    for e, p in zip(gnn.tree_leaves(ema), gnn.tree_leaves(params)):
                        e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        return torch.stack(losses)

    return epoch


def make_partitioned_eval_fn(
    config: ModelConfig,
    loss_idx,
    metric_specs,
    plan: BandedHaloPlan,
    mesh: Mesh,
    axis: str = "graph",
    loss_balance: float = 1.0,
    use_kernels: bool = True,
):
    """Whole-set evaluation over a device-resident frame table: returns
    ``evaluate(params, graphs, ys, ws, arrays, pad_rows=None) -> (losses
    f32[F], moments f32[F, n_specs, 7])`` (``train/trainer._moments``), device
    tensors with no host wait; the caller reads them back once. Operands as
    ``make_partitioned_epoch_fn``'s; ``metric_specs`` the (name, kind,
    label indices) of ``trainer.metric_kinds``."""
    from ..train.losses import name_loss
    from ..train.trainer import _moments, fold_sample_weight

    def evaluate(params, graphs, ys, ws, arrays, pad_rows=None):
        dev = params["embed"]["kernel"].device
        idxs = [torch.as_tensor(idx, dtype=torch.int64, device=dev) for _, _, idx in metric_specs]
        losses, moments = [], []
        with torch.no_grad():
            for f in range(len(graphs.atoms)):
                peaks = apply_partitioned_banded(
                    params, config, _take(graphs, f), plan, mesh, axis=axis,
                    use_kernels=use_kernels, arrays=arrays[f],
                    pad_rows=None if pad_rows is None else pad_rows[f])
                yt = fold_sample_weight(_as_device(ys[f], dev), _as_device(ws[f], dev))
                losses.append(name_loss(yt, peaks, loss_idx, s=loss_balance))
                moments.append(torch.stack([_moments(yt, peaks, idx) for idx in idxs]))
        return torch.stack(losses), torch.stack(moments)

    return evaluate
