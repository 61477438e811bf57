"""RCM-banded message passing (``nmrgnn_tpu/ops/banded.py``) on Hopper.

After a reverse Cuthill-McKee reorder, the real neighbors of each 128-row
tile of a protein lie inside a window of W atom indices starting at lo_t.
The edge values are layer-invariant, so the band

    M[t, n, b, w] = sum_k e[tB + b, k, n] * [nlist[tB + b, k] == lo_t + w]

is built once per forward, and every MP layer is then two dense products
per tile and channel, fused with inv_degree, the activation and the
residual:

    out[tile] = act(sum_n (M[t, n] @ nodes[lo_t : lo_t + W]) @ W_n * inv)
                + nodes[tile]

The "fast" precision builds the band from the Chebyshev-compressed edge
stage (``ops/edgefn.py``) in bfloat16, and on a skewed window
distribution buckets the tiles into a few window classes
(``band_plan_classes``): each class gets its own band, and each MP layer
runs the partial product (no epilogue) once per class.

Past the JAX package's node-table budget (``plan_fits_vmem``) a structure
takes the "banded_hbm" path: the MP layer reads the node table from device
memory tile by tile (``mp_banded_hbm``), and the fast precision's class
forward runs the whole layer, epilogue included, once per class
(``mp_banded_hbm_cls``). On the card every MP layer reads its table from
device memory: the four MP wrappers launch one kernel (``csrc/mp.cuh``,
instantiated by ``csrc/hbm.cu``), each counting its own launches as the
TPU kernel it replaces. The band is under 2% dense, so the kernel stages
only the 16-column window chunks that hold a nonzero of a block's rows and
walks their nonzeros: it reads the band's chunk occupancy
(``band_occupancy``, made once per band by the forwards from nlist, the
distances and the window starts; ``band_occupancy_from_band`` for a call
with the JAX package's signature, one pass over M).

``mp_banded_poly_fused`` builds the Chebyshev band and runs MP layer 1 in
one kernel (``apply_banded(fused_first=True)``), and the ``*_tracedlo``
builds take a caller-given window start per tile (the partitioned
forward's interior and halo bands, whose indices may be shifted negative).

The kernels are instantiated for a few widths; the wrappers adapt every
other width exactly (the width helpers below and the MP kernel's in
``ops/mp.py``: the node table padded, edge channels in groups, the EdgeFC
padded), so every configuration the JAX package's path rule sends to a
kernel runs through it on the card.

Each wrapper below (``_cuda.kernel``) takes the plain PyTorch version for
a tensor on the CPU and launches its CUDA kernel (``csrc/banded.cu``,
``poly.cu``, ``hbm.cu``, ``fused_first.cu``) for a tensor on the card; it
never falls back from the card to the plain version. Each counts its
launches in ``.launches``.

========================  ==========================================  ==========
wrapper                   replaces (TPU kernel)                       bound
========================  ==========================================  ==========
build_band                _build_band_kernel, banded.py:484-548       bytes (M)
build_band_tracedlo       build_band_tracedlo, banded.py:788-830      bytes (M)
build_band_fused          _fused_edge_band_kernel, banded.py:1107     operations
mp_banded                 _mp_banded_kernel, banded.py:555-579        operations
                          (float32; bfloat16: bytes)
build_band_poly           _poly_band_kernel, banded.py:1268, 1418     bytes (M)
build_band_poly_tracedlo  build_band_poly_tracedlo, banded.py:1363    bytes (M)
mp_banded_poly_fused      _poly_mp_fused_kernel, banded.py:1451-1604  as mp_banded
build_band_poly_cls       build_band_poly_cls, banded.py:1645-1700    bytes (M)
mp_banded_partial         _mp_banded_partial_kernel, banded.py:833    as mp_banded
mp_banded_hbm             _mp_banded_hbm_kernel, banded.py:656-773    as mp_banded
mp_banded_hbm_cls         _mp_banded_hbm_cls_kernel, banded.py:1703   as mp_banded
band_occupancy            none (feeds the MP kernel)                  bytes (nlist)
band_occupancy_from_band  none (feeds the MP kernel)                  bytes (M)
permute_tile_bounds       none (serving's request preparation)        bytes (graph)
========================  ==========================================  ==========

The band plans are host-side numpy, as in the JAX package, computed from
each tile's bounds (``tile_bounds`` on the host, ``permute_tile_bounds``
on the device).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as nnf

from ._cuda import (as_long, at, bf16_flag, check, col, device_index, dtype_suffix, kernel,
                    launch)
from .activations import activation_code, get_activation
from .edge import edge_features
from .edgefn import EdgeCheb, cheb_x
from .mp import (MAX_E, MP_CHUNK, chain, channel_groups, mp_group_size, mp_split, mp_tiles_ok,
                 occupancy_bits, occupancy_words, operands, pack_bits, pad_columns)


class BandPlan(NamedTuple):
    """Per-structure banding plan. ``lo`` is a numpy array on the host;
    ``plan_on_device`` gives a copy whose ``lo`` is an int32 tensor."""

    lo: object       # i32[T] window start per row tile (aligned, in range)
    window: int      # W: window width (multiple of 128)
    block_rows: int  # B: rows per tile
    n_padded: int    # N rounded up to a multiple of B

    @property
    def num_tiles(self) -> int:
        return self.n_padded // self.block_rows


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_W_BUCKETS = (256, 384, 512, 640, 768, 896, 1024, 1280, 1536, 2048, 3072, 4096)


def _bucket(w: int, w_buckets) -> int:
    for b in w_buckets:
        if w <= b:
            return b
    return _round_up(int(w), 512)


# Every planner below reads a frame's neighbor lists only through its tile
# bounds: for each row tile, the smallest and largest index of the tile's
# real neighbors (distance > 0; a NaN distance is none). The rest is
# arithmetic over the tiles. ``tile_bounds`` reduces host arrays to them;
# serving takes them from ``permute_tile_bounds`` on the device, at half a
# tile's rows, and ``coarsen_bounds`` joins the halves.

_NO_MIN = int(np.iinfo(np.int32).max)  # the bounds of a tile with no real neighbor
_NO_MAX = int(np.iinfo(np.int32).min)


def tile_bounds(nlist: np.ndarray, edges: np.ndarray, block_rows: int) -> np.ndarray:
    """int64 [T, 2], T = ceil(N / block_rows): each tile's smallest and
    largest real neighbor index over the rows of ``nlist`` i32[N, K] (or
    over every frame of a stack [F, N, K]); (int32 max, int32 min) for a
    tile with none."""
    nlist = np.asarray(nlist)
    real = np.asarray(edges) > 0
    axes = tuple(a for a in range(nlist.ndim) if a != nlist.ndim - 2)
    rows = np.stack([np.where(real, nlist, _NO_MIN).min(axis=axes, initial=_NO_MIN),
                     np.where(real, nlist, _NO_MAX).max(axis=axes, initial=_NO_MAX)], 1)
    return coarsen_bounds(rows, block_rows)


def coarsen_bounds(bounds: np.ndarray, factor: int) -> np.ndarray:
    """Tile bounds of ``factor`` times taller tiles: each group of
    ``factor`` consecutive tiles joined (int64 [ceil(T / factor), 2])."""
    b = np.asarray(bounds, np.int64)
    if factor == 1:
        return b
    t = -(-b.shape[0] // factor)
    out = np.empty((t * factor, 2), np.int64)
    out[:, 0], out[:, 1] = _NO_MIN, _NO_MAX
    out[:b.shape[0]] = b
    out = out.reshape(t, factor, 2)
    return np.stack([out[:, :, 0].min(1), out[:, :, 1].max(1)], 1)


def _tile_windows(bounds: np.ndarray, n: int, block_rows: int, align: int):
    """(n_pad, real, lo, need) of the tiles of a plan over ``n`` rows: the
    padded rows, which tiles have a real neighbor, their aligned window
    starts (0 for the others) and the columns from there to their largest
    neighbor (0 for the others)."""
    n_pad = _round_up(max(n, block_rows), block_rows)
    t = n_pad // block_rows
    b = np.empty((t, 2), np.int64)
    b[:, 0], b[:, 1] = _NO_MIN, _NO_MAX
    b[:min(t, len(bounds))] = np.asarray(bounds, np.int64)[:t]
    real = b[:, 0] <= b[:, 1]
    lo = np.where(real, (b[:, 0] // align) * align, 0)
    need = np.where(real, b[:, 1] - lo + 1, 0)
    return n_pad, real, lo, need


def band_plan_from_bounds(
    bounds: np.ndarray,
    n: int,
    block_rows: int = 128,
    align: int = 128,
    w_buckets=_W_BUCKETS,
) -> BandPlan:
    """``band_plan`` of a frame of ``n`` rows from its tile bounds at
    ``block_rows``."""
    n_pad, _, lo, need = _tile_windows(bounds, n, block_rows, align)
    w = _bucket(int(need.max()), w_buckets)
    w = min(w, n_pad) if n_pad >= 128 else w
    w = max(w, 128)
    # keep windows inside [0, n_pad); moving lo down only grows coverage
    lo = np.minimum(lo, max(n_pad - w, 0))
    return BandPlan(
        lo=lo.astype(np.int32), window=w, block_rows=block_rows, n_padded=n_pad
    )


def band_plan(
    nlist: np.ndarray,
    edges: np.ndarray,
    block_rows: int = 128,
    align: int = 128,
    w_buckets=_W_BUCKETS,
) -> BandPlan:
    """Per-tile window starts and the bucketed window width. Only real
    edges (distance > 0) constrain the windows."""
    return band_plan_from_bounds(tile_bounds(nlist, edges, block_rows),
                                 np.shape(nlist)[0], block_rows, align, w_buckets)


def band_plan_frames(
    nlist_stack: np.ndarray,   # i32[F, N, K]
    edges_stack: np.ndarray,   # f32[F, N, K]
    block_rows: int = 128,
    align: int = 128,
    w_buckets=_W_BUCKETS,
) -> BandPlan:
    """The union band plan over a stack of frames (same atoms and order,
    per-frame neighbor lists): every frame's real neighbors fall inside
    its windows, so one plan serves the whole batch."""
    return band_plan_from_bounds(tile_bounds(nlist_stack, edges_stack, block_rows),
                                 np.shape(nlist_stack)[1], block_rows, align, w_buckets)


def plan_covers_bounds(plan: BandPlan, bounds: np.ndarray, n: int) -> bool:
    """``plan_covers`` of a frame of ``n`` rows from its tile bounds at
    the plan's ``block_rows``: every tile's smallest and largest real
    neighbor inside its window."""
    if _round_up(max(n, plan.block_rows), plan.block_rows) != plan.n_padded:
        return False
    return _inside(bounds, np.asarray(plan.lo, np.int64), plan.window, plan.num_tiles)


def _inside(bounds: np.ndarray, lo: np.ndarray, window, t: int) -> bool:
    b = np.asarray(bounds, np.int64)[:t]
    lo, window = lo[:len(b)], np.broadcast_to(window, (t,))[:len(b)]
    real = b[:, 0] <= b[:, 1]
    return bool(np.all(~real | ((b[:, 0] >= lo) & (b[:, 1] < lo + window))))


def plan_covers(plan: BandPlan, nlist: np.ndarray, edges: np.ndarray) -> bool:
    """Whether a (new frame's) real neighbors all fall inside the plan's
    per-tile windows: the verify half of verify-and-reuse across frames."""
    return plan_covers_bounds(plan, tile_bounds(nlist, edges, plan.block_rows),
                              np.shape(nlist)[0])


class BandClass(NamedTuple):
    """One window-width class of row tiles (see band_plan_classes)."""

    ids: object   # i32[Tc] tile indices of this class
    lo: object    # i32[Tc] window starts, gathered per class
    window: int   # Wc


class BandClassPlan(NamedTuple):
    """The row tiles bucketed into at most ``max_classes`` window widths,
    so that narrow tiles do not pay the widest tile's band in the build
    and MP kernels. ``plan_on_device`` gives a copy whose ids and lo are
    int32 tensors."""

    classes: tuple   # of BandClass, ascending window
    block_rows: int
    n_padded: int

    @property
    def num_tiles(self) -> int:
        return self.n_padded // self.block_rows


def band_plan_classes_from_bounds(
    bounds: np.ndarray,
    n: int,
    block_rows: int = 128,
    align: int = 128,
    max_classes: int = 3,
    w_buckets=_W_BUCKETS,
) -> BandClassPlan:
    """``band_plan_classes`` of a frame of ``n`` rows from its tile bounds
    at ``block_rows``."""
    n_pad, real, lo, need = _tile_windows(bounds, n, block_rows, align)
    need = np.where(real, need, 1)
    t = len(need)

    w_max = min(_bucket(int(need.max()), w_buckets), max(n_pad, 128))
    cands = [b for b in w_buckets if 128 <= b < w_max]

    def lanes(widths):
        # each tile pays the first class width that holds it
        # (none past the widest, as in the JAX package)
        widths = np.asarray(widths, np.int64)
        at = np.searchsorted(widths, need)
        return int(np.where(at < len(widths), widths[np.minimum(at, len(widths) - 1)], 0).sum())

    best = (float("inf"), [w_max])
    for k in range(max_classes):
        for combo in itertools.combinations(cands, k):
            widths = sorted(combo) + [w_max]
            total = lanes(widths)
            if total < best[0]:
                best = (total, widths)
    classes = []
    assigned = np.full(t, -1)
    for ci, b in enumerate(best[1]):
        pick = (assigned < 0) & (need <= b)
        assigned[pick] = ci
        ids = np.nonzero(pick)[0]
        if len(ids) == 0:
            continue
        lo_c = np.minimum(lo[ids], np.maximum(n_pad - b, 0))
        classes.append(BandClass(ids=ids.astype(np.int32), lo=lo_c.astype(np.int32),
                                 window=int(min(b, max(n_pad, 128)))))
    return BandClassPlan(classes=tuple(classes), block_rows=block_rows, n_padded=n_pad)


def band_plan_classes(
    nlist: np.ndarray,
    edges: np.ndarray,
    block_rows: int = 128,
    align: int = 128,
    max_classes: int = 3,
    w_buckets=_W_BUCKETS,
) -> BandClassPlan:
    """Bucket the row tiles into up to ``max_classes`` window widths from
    ``w_buckets``, choosing the class boundaries that minimise the total
    band lanes (every combination of the candidate widths is tried)."""
    return band_plan_classes_from_bounds(tile_bounds(nlist, edges, block_rows),
                                         np.shape(nlist)[0], block_rows, align, max_classes,
                                         w_buckets)


def class_plan_covers_bounds(plan: BandClassPlan, bounds: np.ndarray, n: int) -> bool:
    """``class_plan_covers`` of a frame of ``n`` rows from its tile bounds
    at the plan's ``block_rows``."""
    if _round_up(max(n, plan.block_rows), plan.block_rows) != plan.n_padded:
        return False
    lo_full = np.zeros(plan.num_tiles, np.int64)
    w_full = np.zeros(plan.num_tiles, np.int64)  # a tile in no class holds nothing
    for c in plan.classes:
        lo_full[np.asarray(c.ids)] = np.asarray(c.lo)
        w_full[np.asarray(c.ids)] = c.window
    return _inside(bounds, lo_full, w_full, plan.num_tiles)


def class_plan_covers(plan: BandClassPlan, nlist: np.ndarray, edges: np.ndarray) -> bool:
    """Whether a (new frame's) real neighbors all fall inside each tile's
    class window: verify-and-reuse of a class plan across frames."""
    return class_plan_covers_bounds(plan, tile_bounds(nlist, edges, plan.block_rows),
                                    np.shape(nlist)[0])


# ---------------------------------------------------------------------------
# The path rule. These are the JAX package's VMEM budgets
# (nmrgnn_tpu/ops/banded.py:273-339, 440-477), kept as plain host
# arithmetic under the same names: they decide which path, and so which
# numerics, a structure takes (serving's "banded" or "banded_hbm", the
# class forwards, the batched frames), so that the port serves a structure
# as the JAX package does. They are not limits of the Hopper kernels,
# which take any window.


def plan_fits_vmem(
    plan: BandPlan,
    n_features: int,
    n_edge_channels: int = 3,
    dtype_bytes: int = 4,
    budget_bytes: int = 12 * 1024 * 1024,
) -> bool:
    """Whether the node-table-resident MP working set (the whole node
    table, one band tile double-buffered, the weights, the f32 scratch)
    fits the TPU's per-core budget: the rule for the "banded" path."""
    nodes = plan.n_padded * n_features * dtype_bytes
    band_tile = 2 * n_edge_channels * plan.block_rows * plan.window * dtype_bytes
    w = n_edge_channels * n_features * n_features * dtype_bytes
    scratch = n_edge_channels * plan.block_rows * n_features * 4
    return nodes + band_tile + w + scratch < budget_bytes


def hbm_plan_fits_vmem(
    plan: BandPlan,
    n_features: int,
    n_edge_channels: int = 3,
    dtype_bytes: int = 4,
    budget_bytes: int = 12 * 1024 * 1024,
) -> bool:
    """Whether the per-tile working set of the HBM node-table MP layer
    (double-buffered [W, F] windows, [B, F] residual rows, [E, B, W] band
    tiles and [B, F] output tiles, and the weights) fits the TPU's budget:
    the rule for the "banded_hbm" path and its class plans."""
    B, W = plan.block_rows, plan.window
    F, E, b = n_features, n_edge_channels, dtype_bytes
    win = 2 * W * F * b
    res = 2 * B * F * b
    band = 2 * E * B * W * b
    weights = E * F * F * b
    out = 2 * B * F * b
    return win + res + band + weights + out < budget_bytes


def _fused_build_arrays(plan: BandPlan, edge_hidden: int, n_edge_channels: int,
                        neighbor_k: int, out_bytes: int):
    """(per-slot MLP activations, float32 band accumulators, double-buffered
    output tile) of the fused edge + band build on the TPU, in bytes."""
    B, W = plan.block_rows, plan.window
    return (B * neighbor_k * edge_hidden * 4, n_edge_channels * B * W * 4,
            2 * n_edge_channels * B * W * out_bytes)


def fused_build_fits(
    plan: BandPlan,
    edge_hidden: int,
    n_edge_channels: int = 3,
    neighbor_k: int = 16,
    out_bytes: int = 4,
    budget_bytes: int = 15 * 1024 * 1024,
) -> bool:
    """The calibrated estimate of the fused build's scoped memory on the
    TPU, 3.24 x (accumulators + output tiles) - 2 MiB + activations, under
    the budget."""
    x, accs, out2 = _fused_build_arrays(plan, edge_hidden, n_edge_channels, neighbor_k,
                                        out_bytes)
    return 3.24 * (accs + out2) - 2 * 1024 * 1024 + x < budget_bytes


def fused_build_ok(
    plan: BandPlan,
    edge_hidden: int,
    n_edge_channels: int = 3,
    neighbor_k: int = 16,
    out_bytes: int = 4,
    budget_bytes: int = 15 * 1024 * 1024,
) -> bool:
    """The fused-build rule as the JAX package applies it off a TPU: reject
    when the raw arrays alone pass 16 MiB, else the estimate
    (``fused_build_fits``). On a TPU the JAX package consults a compile
    probe in the band between 60% and 100% of the budget; there is none
    here, so the choice equals the JAX package's on a CPU backend."""
    naive = sum(_fused_build_arrays(plan, edge_hidden, n_edge_channels, neighbor_k,
                                    out_bytes))
    return naive <= 16 * 1024 * 1024 and fused_build_fits(
        plan, edge_hidden, n_edge_channels, neighbor_k, out_bytes, budget_bytes)


def _class_plan_on_device(plan: BandClassPlan, device) -> BandClassPlan:
    """The class plan with every class's ids and lo as int32 tensors on
    ``device``. Host arrays are checked first: the classes partition the
    tiles, and every window lies in [0, n_padded)."""
    if all(isinstance(c.ids, torch.Tensor) and isinstance(c.lo, torch.Tensor)
           for c in plan.classes):
        return plan._replace(classes=tuple(
            c._replace(ids=c.ids.to(device=device, dtype=torch.int32),
                       lo=c.lo.to(device=device, dtype=torch.int32))
            for c in plan.classes))
    ids = [np.asarray(c.ids) for c in plan.classes]
    los = [np.asarray(c.lo) for c in plan.classes]
    if not np.array_equal(np.sort(np.concatenate(ids)), np.arange(plan.num_tiles)):
        raise ValueError("the classes' tile ids must partition the plan's tiles")
    for c, i, lo in zip(plan.classes, ids, los):
        if lo.shape != i.shape:
            raise ValueError(f"a class has {i.shape} ids but lo of shape {lo.shape}")
        if lo.min() < 0 or lo.max() + c.window > plan.n_padded:
            raise ValueError("class windows must lie inside [0, n_padded)")
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)  # noqa: E731
    return plan._replace(classes=tuple(
        c._replace(ids=as_dev(i), lo=as_dev(lo)) for c, i, lo in zip(plan.classes, ids, los)))


def plan_on_device(plan, device):
    """The plan with ``lo`` (and a class plan's ``ids``) checked on the
    host and copied to ``device`` once, so the kernels of a forward do not
    each copy it. The MP kernel reads nodes[lo_t : lo_t + W], so every
    window must lie in [0, N_pad)."""
    if isinstance(plan, BandClassPlan):
        return _class_plan_on_device(plan, device)
    if isinstance(plan.lo, torch.Tensor):
        return plan._replace(lo=plan.lo.to(device=device, dtype=torch.int32))
    lo = np.asarray(plan.lo)
    if lo.shape != (plan.num_tiles,):
        raise ValueError(f"plan.lo has shape {lo.shape}, expected ({plan.num_tiles},)")
    if plan.num_tiles and (lo.min() < 0 or lo.max() + plan.window > plan.n_padded):
        raise ValueError("plan windows must lie inside [0, n_padded)")
    return plan._replace(
        lo=torch.as_tensor(np.ascontiguousarray(lo, np.int32), device=device)
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path, and the oracle each kernel is held
# against on the card (counterparts of build_band_xla / mp_banded_xla,
# nmrgnn_tpu/ops/banded.py:1826-1867).


def _tiles_of(m: int, block_rows: int) -> int:
    """The tiles of ``m`` rows, which must be whole ``block_rows``-row
    tiles (the JAX package asserts it, ``banded.py:803``, ``:1386``)."""
    if m % block_rows:
        raise ValueError(f"{m} rows are not whole {block_rows}-row tiles")
    return m // block_rows


def build_band_tracedlo_plain(
    nlist: torch.Tensor,       # i32[M, K], M a multiple of block_rows
    edge_feats: torch.Tensor,  # f32[M, K, E]
    lo,                        # i32[M / block_rows] window starts (tensor or numpy)
    window: int,
    block_rows: int = 128,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype`` by a one-hot compare against
    lo_t + w, summed over K in slot order in float32 and rounded once. An
    index outside [lo_t, lo_t + W), negative ones included, matches
    nothing."""
    m, k = nlist.shape
    T = _tiles_of(m, block_rows)
    e = edge_feats.shape[-1]
    ev = edge_feats.float().view(T, block_rows, k, e).permute(0, 3, 1, 2)  # [T, E, B, K]
    return _band_in_slot_order(nlist.reshape(T, block_rows, k), as_long(lo, edge_feats.device), ev,
                               window, out_dtype)


def _band_in_slot_order(nlist_t, lo, ev, window: int, out_dtype) -> torch.Tensor:
    """M [Tg, E, B, W] from tiles nlist_t [Tg, B, K], window starts lo [Tg]
    and edge values ev [Tg, E, B, K]: slot by slot in slot order, each
    slot's values added in float32 to the column its index matches (none
    outside [lo, lo + W)), from 0, then rounded once to ``out_dtype``, as
    the TPU kernels (``_poly_build_tile``, :1440-1448) and the CUDA builds
    (``csrc/common.cuh``'s ``band_rows``) sum them, bit for bit."""
    rel = nlist_t.to(torch.int64) - lo[:, None, None]
    cols = torch.arange(window, device=ev.device)
    tg, e, b, k = ev.shape
    acc = torch.zeros((tg, e, b, window), dtype=torch.float32, device=ev.device)
    for j in range(k):
        mask = (rel[:, :, j, None] == cols).to(torch.float32)  # [Tg, B, W]
        acc += mask[:, None] * ev[..., j, None]
    return acc.to(out_dtype)


def build_band_plain(
    nlist: torch.Tensor,       # i32[N, K]
    edge_feats: torch.Tensor,  # f32[N, K, E], 0 on padding slots
    plan: BandPlan,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype``: the rows padded to the plan (-1),
    then ``build_band_tracedlo_plain`` with the plan's window starts."""
    pad = plan.n_padded - nlist.shape[0]
    nlist_p = nnf.pad(nlist.to(torch.int64), (0, 0, 0, pad), value=-1)
    e_p = nnf.pad(edge_feats, (0, 0, 0, 0, 0, pad))
    return build_band_tracedlo_plain(nlist_p, e_p, plan.lo, plan.window, plan.block_rows,
                                     out_dtype)


def build_band_fused_plain(
    nlist: torch.Tensor,
    edges: torch.Tensor,
    edge_fc_params: Sequence[dict],
    plan: BandPlan,
    *,
    rbf_low: float,
    rbf_high: float,
    activation_name: str = "softplus",
    out_dtype=torch.float32,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype`` from raw distances: the edge stage
    with its products' operands in ``compute_dtype`` (float32 sums), then
    the band in float32, rounded once."""
    e = edge_features(edges, edge_fc_params, rbf_low=rbf_low, rbf_high=rbf_high,
                      activation_name=activation_name, compute_dtype=compute_dtype)
    return build_band_plain(nlist, e, plan, out_dtype)


def permute_tile_bounds_plain(
    atoms: torch.Tensor,       # f32[N, V]
    nlist: torch.Tensor,       # i32[N, K]
    edges: torch.Tensor,       # f32[N, K]
    inv_degree: torch.Tensor,  # f32[N]
    order,                     # i32[N] new position -> old index, or None
    inverse,                   # i32[N] old index -> new position, or None
    rows: int,
):
    """(atoms, nlist, edges, inv_degree, bounds): the graph permuted as
    ``data.reorder.permute_graph(..., pin_zero=False)`` permutes it (rows
    gathered through ``order``, indices renamed through ``inverse``, a
    negative index counted from the end), and ``tile_bounds`` of the
    permuted graph at ``rows`` rows a tile, int32 [ceil(N / rows), 2]. With
    ``order`` None the graph is returned as it is, with its bounds."""
    if order is not None:
        o = order.long()
        atoms, edges, inv_degree = atoms[o], edges[o], inv_degree[o]
        nlist = inverse[nlist[o].long()].to(nlist.dtype)
    n, k = nlist.shape
    t = -(-n // rows)
    real = edges > 0
    nl = nlist.long()
    lo = torch.full((t * rows,), _NO_MIN, dtype=torch.int64, device=nl.device)
    hi = torch.full((t * rows,), _NO_MAX, dtype=torch.int64, device=nl.device)
    if k:
        lo[:n] = torch.where(real, nl, _NO_MIN).amin(1)
        hi[:n] = torch.where(real, nl, _NO_MAX).amax(1)
    bounds = torch.stack([lo.view(t, rows).amin(1), hi.view(t, rows).amax(1)], 1)
    return atoms, nlist, edges, inv_degree, bounds.to(torch.int32)


# The band occupancy: which 16-column window chunks of each band row hold
# a nonzero. The MP kernel stages and multiplies only the chunks a block's
# rows occupy (``csrc/mp.cuh``); here it is one bit per grid row and chunk,
# int32 [Tg * B, ceil(W / 512)], bit b of word j for chunk 32 j + b
# (``ops/mp.py``'s ``occupancy_words``, ``pack_bits``, ``occupancy_bits``).


def band_occupancy_plain(
    nlist: torch.Tensor,   # i32[N, K]
    edges: torch.Tensor,   # f32[N, K] distances, 0 on padding slots
    lo,                    # i32[Tg] window starts (tensor or numpy)
    window: int,
    block_rows: int,
    n_padded: int,
    ids=None,              # i32[Tg] tile ids (None: tile i)
) -> torch.Tensor:
    """int32 [Tg * B, NW]: grid row i * B + r occupies chunk
    (nlist[src, k] - lo[i]) // 16 for each slot k with a positive distance
    whose index lies in [lo[i], lo[i] + W), src = ids[i] * B + r (ids
    None: i * B + r). Rows at or past N, and a tile id outside
    [0, n_padded / B), occupy nothing. Exact for every band build of this
    module: each gives a slot with distance <= 0 the value 0."""
    dev = edges.device
    n, k = nlist.shape
    B = block_rows
    lo_t = as_long(lo, dev)
    tg = lo_t.shape[0]
    tiles = torch.arange(tg, device=dev) if ids is None else as_long(ids, dev)
    if tiles.shape != (tg,):
        raise ValueError(f"{tiles.shape[0]} tile ids for {tg} window starts")
    src = tiles.clamp(min=0)[:, None] * B + torch.arange(B, device=dev)  # [Tg, B]
    ok = ((tiles >= 0) & (tiles < n_padded // B))[:, None] & (src < n)
    src = src.clamp(max=max(n - 1, 0))
    rel = nlist.to(torch.int64)[src] - lo_t[:, None, None]  # [Tg, B, K]
    hit = ok[..., None] & (edges[src] > 0) & (rel >= 0) & (rel < window)
    nw = window // MP_CHUNK
    chunk = torch.where(hit, rel // MP_CHUNK, nw).view(tg * B, k)
    bits = torch.zeros((tg * B, nw + 1), dtype=torch.bool, device=dev)
    bits.scatter_(1, chunk, True)
    return pack_bits(bits[:, :nw])


def band_occupancy_from_band_plain(M: torch.Tensor) -> torch.Tensor:
    """int32 [T * B, NW]: the chunks of each band row of M [T, E, B, W]
    that hold a nonzero (in any channel)."""
    T, E, B, W = M.shape
    bits = (M != 0).any(1).view(T * B, W // MP_CHUNK, MP_CHUNK).any(-1)
    return pack_bits(bits)


def _occupied(M: torch.Tensor, occupancy) -> torch.Tensor:
    """M with the chunks ``occupancy`` leaves out set to zero (M itself
    when it is None): what the MP kernel reads of a band."""
    if occupancy is None:
        return M
    T, E, B, W = M.shape
    if tuple(occupancy.shape) != (T * B, occupancy_words(W)):
        raise ValueError(f"occupancy of shape {tuple(occupancy.shape)} does not match the band "
                         f"{tuple(M.shape)}")
    keep = occupancy_bits(occupancy.to(M.device), W).repeat_interleave(MP_CHUNK, 1)
    return M * keep.view(T, 1, B, W).to(M.dtype)


def mp_banded_partial_plain(
    M: torch.Tensor,      # [T, E, B, W]
    lo,                   # i32[T] window starts (tensor or numpy)
    table: torch.Tensor,  # [Nt, F] window source, any Nt >= max(lo) + W
    w: torch.Tensor,      # [F, F, E]
    occupancy=None,       # int32 [T * B, NW] (band_occupancy), or None
) -> torch.Tensor:
    """Partial MP aggregation f32[T * B, F] = sum_n (M_n @ table window) @
    w_n, with no inv_degree, activation or residual. Operands are in
    ``table.dtype`` and h is rounded to it before the second product, as
    the kernel body rounds it (``_mp_banded_partial_kernel``, :848-851).
    Given ``occupancy``, only the band chunks it marks are read."""
    M = _occupied(M, occupancy)
    T, E, B, W = M.shape
    F = table.shape[-1]
    dev = table.device
    cd = table.dtype
    idx = as_long(lo, dev)[:, None] + torch.arange(W, device=dev)  # [T, W]
    h = torch.einsum("tebw,twf->tebf", M.float(), table[idx].float()).to(cd).float()
    out = torch.einsum("tebf,efm->tbm", h, w.permute(2, 0, 1).to(cd).float())
    return out.reshape(T * B, F)


def _mp_epilogue(acc, tiles, nodes, inv_degree, activation_name):
    """act(acc * inv_degree) + residual over the rows of ``tiles`` (acc
    f32[Tg * B, F], tile ``tiles[i]`` in rows [i * B, (i + 1) * B)), in
    float32, rounded once to ``nodes.dtype``."""
    F = nodes.shape[-1]
    B = acc.shape[0] // tiles.shape[0]
    rows = (tiles[:, None] * B + torch.arange(B, device=nodes.device)).reshape(-1)
    out = acc * inv_degree[rows][:, None]
    return (get_activation(activation_name)(out) + nodes[rows].float()).to(nodes.dtype).view(-1, F)


def mp_banded_plain(
    M: torch.Tensor,           # [T, E, B, W]
    plan: BandPlan,
    nodes: torch.Tensor,       # [N_pad, F], float32 or bfloat16
    w: torch.Tensor,           # [F, F, E]
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # int32 [T * B, NW], or None
) -> torch.Tensor:
    """One MP layer (activation(aggregate) + residual) over the band, in
    ``nodes.dtype``: operands in that type, products and sums in float32,
    h rounded to it before the second product, the residual added in
    float32 and the sum rounded once (``_mp_banded_kernel``, :572-579)."""
    acc = mp_banded_partial_plain(M, plan.lo, nodes, w, occupancy)
    tiles = torch.arange(M.shape[0], device=nodes.device)
    return _mp_epilogue(acc, tiles, nodes, inv_degree, activation_name)


def mp_banded_hbm_plain(
    M: torch.Tensor,           # [T, E, B, W]
    plan: BandPlan,
    nodes: torch.Tensor,       # [N_pad, F], float32 or bfloat16
    w: torch.Tensor,           # [F, F, E]
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # int32 [T * B, NW], or None
) -> torch.Tensor:
    """The MP layer with the node table in device memory: the same
    function as ``mp_banded_plain`` (``_mp_banded_hbm_kernel``,
    :656-714, has ``_mp_banded_kernel``'s numerics)."""
    return mp_banded_plain(M, plan, nodes, w, inv_degree, activation_name, occupancy)


def mp_banded_hbm_cls_plain(
    M: torch.Tensor,           # [Tc, E, B, Wc]
    cls: BandClass,
    block_rows: int,
    nodes: torch.Tensor,       # [N_pad, F], float32 or bfloat16
    w: torch.Tensor,           # [F, F, E]
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # int32 [Tc * B, NW], or None
) -> torch.Tensor:
    """One MP layer over one window class's tiles: class-contiguous rows
    [Tc * B, F] in ``nodes.dtype``, row block i the update of tile
    ``cls.ids[i]`` (window start ``cls.lo[i]``, its residual rows and
    inv_degree), with ``mp_banded_plain``'s rounding
    (``_mp_banded_hbm_cls_kernel``, :1703-1756)."""
    if M.shape[2] != block_rows:
        raise ValueError(f"band of shape {tuple(M.shape)} has no {block_rows}-row tiles")
    acc = mp_banded_partial_plain(M, cls.lo, nodes, w, occupancy)
    return _mp_epilogue(acc, as_long(cls.ids, nodes.device), nodes, inv_degree, activation_name)


def poly_edge_values(cheb: EdgeCheb, d: torch.Tensor) -> torch.Tensor:
    """f32[..., E]: the Chebyshev edge stage as the band-build kernels
    compute it (``_poly_build_tile``, :1425-1438): clamp, the forward
    recurrence T_p = 2x T_{p-1} - T_{p-2} summed in degree order, every
    product and sum rounded separately, then the d > 0 mask."""
    x = cheb_x(cheb, d)
    c = torch.as_tensor(cheb.coeffs, dtype=torch.float32, device=d.device)
    e = c[0] + c[1] * x[..., None]
    x2 = 2.0 * x
    tp_prev, tp = torch.ones_like(x), x
    for p in range(2, c.shape[0]):
        tp_prev, tp = tp, x2 * tp - tp_prev
        e = e + c[p] * tp[..., None]
    return e * (d > 0).to(torch.float32)[..., None]


def _poly_band(nlist_t, d_t, lo, cheb: EdgeCheb, window: int, out_dtype) -> torch.Tensor:
    """M [Tg, E, B, W] from tiles nlist_t / d_t [Tg, B, K] with window
    starts lo [Tg]: the Chebyshev edge values summed in slot order."""
    ev = poly_edge_values(cheb, d_t).permute(0, 3, 1, 2)  # [Tg, E, B, K]
    return _band_in_slot_order(nlist_t, lo, ev, window, out_dtype)


def _padded_tiles(nlist, edges, block_rows: int, n_padded: int):
    pad = n_padded - nlist.shape[0]
    k = nlist.shape[1]
    nlist_p = nnf.pad(nlist.to(torch.int64), (0, 0, 0, pad), value=-1)
    d_p = nnf.pad(edges, (0, 0, 0, pad))
    t = n_padded // block_rows
    return nlist_p.view(t, block_rows, k), d_p.view(t, block_rows, k)


def build_band_poly_plain(
    nlist: torch.Tensor,   # i32[N, K]
    edges: torch.Tensor,   # f32[N, K] raw distances
    cheb: EdgeCheb,
    plan: BandPlan,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype`` from raw distances through the
    Chebyshev-compressed edge stage."""
    nl, d = _padded_tiles(nlist, edges, plan.block_rows, plan.n_padded)
    return _poly_band(nl, d, as_long(plan.lo, edges.device), cheb, plan.window, out_dtype)


def build_band_poly_tracedlo_plain(
    nlist: torch.Tensor,   # i32[M, K], M a multiple of block_rows
    edges: torch.Tensor,   # f32[M, K] raw distances
    cheb: EdgeCheb,
    lo,                    # i32[M / block_rows] window starts (tensor or numpy)
    window: int,
    block_rows: int = 128,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype``: the Chebyshev band build with the
    caller's window starts; out-of-window indices match nothing."""
    m, k = nlist.shape
    T = _tiles_of(m, block_rows)
    return _poly_band(nlist.view(T, block_rows, k), edges.view(T, block_rows, k),
                      as_long(lo, edges.device), cheb, window, out_dtype)


def mp_banded_poly_fused_plain(
    nlist: torch.Tensor,       # i32[N, K]
    edges: torch.Tensor,       # f32[N, K] raw distances
    cheb: EdgeCheb,
    plan: BandPlan,
    nodes: torch.Tensor,       # [N_pad, F], float32 or bfloat16
    w: torch.Tensor,           # [F, F, E] layer-1 weights
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    out_dtype=torch.float32,
):
    """(M [T, E, B, W] in ``out_dtype``, nodes_1 [T * B, F] in
    ``nodes.dtype``): ``build_band_poly_plain`` then ``mp_banded_plain``.
    Layer 1 takes the float32 band rounded to ``nodes.dtype``, not to
    ``out_dtype`` (``_poly_mp_fused_kernel``, :1489-1491)."""
    M = build_band_poly_plain(nlist, edges, cheb, plan, torch.float32)
    nodes_1 = mp_banded_plain(M.to(nodes.dtype), plan, nodes, w, inv_degree, activation_name)
    return M.to(out_dtype), nodes_1


def build_band_poly_cls_plain(
    nlist: torch.Tensor,   # i32[N, K]
    edges: torch.Tensor,   # f32[N, K] raw distances
    cheb: EdgeCheb,
    cls: BandClass,
    block_rows: int,
    n_padded: int,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M_c [Tc, E, B, Wc]: the Chebyshev band build over one class's tiles
    (tile ``cls.ids[i]`` into ``M_c[i]``, with window start ``cls.lo[i]``)."""
    nl, d = _padded_tiles(nlist, edges, block_rows, n_padded)
    ids = as_long(cls.ids, edges.device)
    return _poly_band(nl[ids], d[ids], as_long(cls.lo, edges.device), cheb, cls.window,
                      out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.

MAX_K = 8192        # neighbor slots the band builds stage (common.cuh's kBandMaxK)
_FUSED_H = (128, 256, 512, 1024, 2048)  # EdgeFC widths the fused kernel is instantiated for
_FUSED_TC_H = (128, 256)  # of them, those with a tensor-core (bfloat16) instantiation
_FUSED_OUT = 128 * 128  # edge slots x H of one EdgeFC pass of the fused kernel
_FUSED_MAX_K = 4096  # neighbor slots a block of the fused kernel keeps (one atom)
POLY_MAX_COEFFS = 1024  # (degree + 1) * E the Chebyshev build stages
_BUILD_ROWS = 4  # rows of a tile a block of the band builds takes
_BUILD_STAGE = 40 * 1024  # slot bytes a block of the band builds stages without opting in


# -- Widths ------------------------------------------------------------------
# The kernels are instantiated for a few widths. Every other width that the
# JAX package's path rule sends to a kernel is adapted to them exactly, on
# the card, by these plain functions on tensors (the MP kernel's node
# widths, channel groups and F-split: ``ops/mp.py``):
# * edge channels E: a band build launch takes at most MAX_E channels; more
#   run as channel groups, each writing its channels of one M;
# * the EdgeFC width H of the fused build: zero-padded to 128, 256, 512,
#   1,024 or 2,048 (a padded hidden unit's act(0) meets a zero row of the
#   next kernel, a padded RBF centre a zero row of the first), the RBF
#   spacing kept from the true H;
# * neighbor slots K: the band builds stage fewer rows a block as K grows
#   (build_rows); the fused build runs a block's slots through its EdgeFC
#   in passes (fused_rows).


def fused_width(H: int) -> int:
    """The fused kernel's EdgeFC width a width ``H`` is padded to: 128,
    256, 512, 1,024 or 2,048.

    ``fused_build_ok``'s activations term lets H reach 4,048 at 64-row
    tiles and K = 16, but the JAX kernel holds its hidden kernels [Lh, H,
    H] whole in its 16 MiB of scoped VMEM, double-buffered (2 * H * H * 4
    bytes for even one of them), so no H past 1,448 compiles there; past
    2,048 this raises."""
    for h in _FUSED_H:
        if H <= h:
            return h
    raise NotImplementedError(f"the fused build takes an EdgeFC up to {_FUSED_H[-1]} wide, "
                              f"not {H}")


def pad_edge_fc(edge_fc_params: Sequence[dict], width: int) -> list:
    """EdgeFC parameters (``models/gnn`` layout: hidden kernels [H, H],
    the final one [H, E]) with H zero-padded to ``width``: every hidden
    kernel's rows and columns and bias, the final kernel's rows."""
    out = []
    for p in edge_fc_params[:-1]:
        k = p["kernel"]
        out.append({"kernel": nnf.pad(k, (0, width - k.shape[1], 0, width - k.shape[0])),
                    "bias": pad_columns(p["bias"], width)})
    k = edge_fc_params[-1]["kernel"]
    out.append({"kernel": nnf.pad(k, (0, 0, 0, width - k.shape[0])),
                "bias": edge_fc_params[-1]["bias"]})
    return out


def fused_rows(K: int, H: int, block_rows: int) -> int:
    """Atoms a block of the fused kernel takes at padded width ``H``: the
    largest power of two whose K slots fit one EdgeFC pass (16384 / H
    slots) and that divides the tile's rows, else 1, whose K slots then
    run in several passes; a K that does not fill a pass leaves its last
    slots masked.

    K is taken up to 4,096, the slots a block keeps in shared memory
    beside a pass's buffers: the reach of ``fused_build_ok`` for any EdgeFC
    of 16 or more units (its activations term B * K * H * 4 bytes passes
    16 MiB past K = 65,536 / H at 64-row tiles)."""
    if not 1 <= K <= _FUSED_MAX_K:
        raise NotImplementedError(f"the fused build takes K up to {_FUSED_MAX_K}, not {K}")
    rows = _FUSED_OUT // H // K
    rows = 1 << (rows.bit_length() - 1) if rows else 1
    while block_rows % rows:
        rows //= 2
    return rows


def fused_compute(compute_bf16: bool, H: int, K: int) -> int:
    """The fused kernel's compute code at padded width ``H``: 0 float32
    on the CUDA cores; in bfloat16, 1 on the tensor cores (H 128, or 256
    with K <= 1,024 slots beside its staged hidden kernel) and else 2,
    bfloat16 operands on the CUDA cores (each product exact, float32 sums,
    as on the tensor cores)."""
    if not compute_bf16:
        return 0
    return 1 if H == 128 or (H == 256 and K <= 1024) else 2


def poly_group_size(degree: int) -> int:
    """Edge channels one Chebyshev build launch takes at ``degree``: its
    (degree + 1) * E coefficients stay within POLY_MAX_COEFFS."""
    size = min(MAX_E, POLY_MAX_COEFFS // (degree + 1))
    if size < 1:
        raise NotImplementedError(f"the Chebyshev builds take degree < {POLY_MAX_COEFFS}")
    return size


def build_rows(block_rows: int, K: int = 16, E: int = MAX_E) -> int:
    """Rows of one tile a block of the band builds (``csrc/banded.cu``,
    ``csrc/poly.cu``) takes: 4 (the best or near it on the card among 1
    to 32, at 2,482 and at 44,676 atoms), or the largest power of two
    below it that divides ``block_rows`` and whose rows * K slots of E
    values stage in _BUILD_STAGE bytes (one row past that: the kernel
    opts in to more shared memory).

    The band builds take K up to 8,192 (``MAX_K``); the JAX package's
    budgets set no bound on K for them."""
    rows = _BUILD_ROWS
    while block_rows % rows or (rows > 1 and rows * K * (E + 1) * 4 > _BUILD_STAGE):
        rows //= 2
    return rows


def _device_lo(plan: BandPlan, device) -> torch.Tensor:
    lo = plan_on_device(plan, device).lo
    check("plan.lo", lo, torch.int32, (plan.num_tiles,), device)
    return lo


def _launch_build(nlist, edge_feats, lo, window: int, block_rows: int,
                  out_dtype) -> torch.Tensor:
    """Checks and launches the band build of ``csrc/banded.cu`` over the
    whole tiles of ``nlist`` with window starts ``lo``."""
    dev = edge_feats.device
    m, k = nlist.shape
    e = edge_feats.shape[-1]
    T = _tiles_of(m, block_rows)
    check("nlist", nlist, torch.int32, (m, k), dev)
    check("edge_feats", edge_feats, torch.float32, (m, k, e), dev)
    check("lo", lo, torch.int32, (T,), dev)
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(f"build_band kernel takes K <= {MAX_K}")
    out_bf16 = bf16_flag("out_dtype", out_dtype)
    M = torch.empty((T, e, block_rows, window), dtype=out_dtype, device=dev)
    for c0, c1 in channel_groups(e):
        launch("nmr_build_band", dev, nlist.data_ptr(),
               at(edge_feats, 2, c0), lo.data_ptr(), at(M, 1, c0), T, block_rows, k,
               c1 - c0, window,
               build_rows(block_rows, k, c1 - c0), out_bf16, e, e)
    return M


@kernel(build_band_plain, on="edge_feats")
def build_band(
    nlist: torch.Tensor,       # i32[N, K]
    edge_feats: torch.Tensor,  # f32[N, K, E] (EdgeFC output; 0 on padding)
    plan: BandPlan,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype`` (float32 or bfloat16): the dense
    band of the MP operator, summed in float32 and rounded once.

    Replaces ``_build_band_kernel`` (nmrgnn_tpu/ops/banded.py:484-548). On
    the card, a block stages the indices and values of ``build_rows`` rows
    of a tile and a warp writes each row, 16 bytes a lane, comparing only
    the columns its indices reach; it is bound by writing M (T*E*B*W
    values)."""
    dev = edge_feats.device
    n = nlist.shape[0]
    if n > plan.n_padded:
        raise ValueError(f"{n} rows, the plan {plan.n_padded}")
    pad = plan.n_padded - n
    nlist_p = nnf.pad(nlist, (0, 0, 0, pad), value=-1)
    e_p = nnf.pad(edge_feats, (0, 0, 0, 0, 0, pad))
    return _launch_build(nlist_p, e_p, _device_lo(plan, dev), plan.window, plan.block_rows,
                         out_dtype)


@kernel(permute_tile_bounds_plain, on="nlist", forward=False)
def permute_tile_bounds(
    atoms: torch.Tensor,       # f32[N, V]
    nlist: torch.Tensor,       # i32[N, K]
    edges: torch.Tensor,       # f32[N, K]
    inv_degree: torch.Tensor,  # f32[N]
    order,                     # i32[N] new position -> old index, or None
    inverse,                   # i32[N] old index -> new position, or None
    rows: int,
):
    """(atoms, nlist, edges, inv_degree, bounds): a request's graph in the
    serving order and its tile bounds at ``rows`` rows a tile, int32
    [ceil(N / rows), 2] (``permute_tile_bounds_plain``), in one launch.

    No TPU kernel: the JAX package permutes and plans on the host. On the
    card a block takes one tile: it gathers the tile's rows through
    ``order``, renames their indices through ``inverse`` and reduces its
    real neighbors' smallest and largest index; bound by reading and
    writing the graph once. An index outside [-N, N) is left as it is
    (``permute_graph`` raises on it). With ``order`` None it reads nlist
    and edges for the bounds alone and returns the graph as it is. It
    counts its launches apart from the forwards' (``KERNEL_WRAPPERS``)."""
    dev = nlist.device
    n, k = nlist.shape
    v = atoms.shape[-1]
    if n < 1 or rows < 1:
        raise ValueError(f"permute_tile_bounds takes at least one row and tile row, not {n}, "
                         f"{rows}")
    check("atoms", atoms, torch.float32, (n, v), dev)
    check("nlist", nlist, torch.int32, (n, k), dev)
    check("edges", edges, torch.float32, (n, k), dev)
    check("inv_degree", inv_degree, torch.float32, (n,), dev)
    bounds = torch.empty((-(-n // rows), 2), dtype=torch.int32, device=dev)
    if order is None:
        out, ptrs = (atoms, nlist, edges, inv_degree), [None] * 6
    else:
        check("order", order, torch.int32, (n,), dev)
        check("inverse", inverse, torch.int32, (n,), dev)
        out = tuple(torch.empty_like(t) for t in (atoms, nlist, edges, inv_degree))
        ptrs = [order.data_ptr(), inverse.data_ptr()] + [t.data_ptr() for t in out]
    launch("nmr_permute_tile_bounds", dev, atoms.data_ptr(), nlist.data_ptr(),
           edges.data_ptr(), inv_degree.data_ptr(), *ptrs, bounds.data_ptr(), n, v, k, rows)
    return (*out, bounds)


@kernel(build_band_tracedlo_plain, on="edge_feats")
def build_band_tracedlo(
    nlist: torch.Tensor,       # i32[M, K], M a multiple of block_rows
    edge_feats: torch.Tensor,  # f32[M, K, E]
    lo,                        # i32[M / block_rows] window starts (any values)
    window: int,
    block_rows: int = 128,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype``: ``build_band`` with the caller's
    window start per tile and no padding. An index outside
    [lo_t, lo_t + W), negative ones included, matches no column, so the
    partitioned forward builds its interior band (halo indices excluded)
    and its halo band (indices shifted by -m: interior ones go negative)
    with it (``nmrgnn_tpu/parallel/halo.py:609-645``).

    Replaces ``build_band_tracedlo`` (nmrgnn_tpu/ops/banded.py:788-830).
    On the card it launches ``build_band``'s kernel, which reads ``lo``
    from device memory; bound by writing M."""
    T = _tiles_of(nlist.shape[0], block_rows)
    lo = device_index("lo", lo, T, edge_feats.device)
    return _launch_build(nlist, edge_feats, lo, window, block_rows, out_dtype)


@kernel(build_band_fused_plain, on="edges")
def build_band_fused(
    nlist: torch.Tensor,             # i32[N, K]
    edges: torch.Tensor,             # f32[N, K] raw distances
    edge_fc_params: Sequence[dict],  # [{"kernel", "bias"}] (models/gnn layout)
    plan: BandPlan,
    *,
    rbf_low: float,
    rbf_high: float,
    activation_name: str = "softplus",
    out_dtype=torch.float32,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype`` straight from raw distances: RBF +
    EdgeFC + band, the EdgeFC products' operands in ``compute_dtype``
    (float32 or bfloat16) with float32 sums.

    Replaces ``_fused_edge_band_kernel`` (nmrgnn_tpu/ops/banded.py:
    1107-1254). On the card, a block runs the EdgeFC MLP for 128 edge
    slots out of shared memory and writes their band rows; the [N, K, H]
    activations never reach device memory. Two blocks share an SM. In
    float32 each hidden layer's kernel streams through a ``cp.async`` ring
    into 8 x 8 register tiles on the CUDA cores; in bfloat16 the
    activations are held as bfloat16 and the hidden layers run on the
    tensor cores (``mma.sync``, each product exact, float32 sums, as
    ``ops/edge.py``'s ``as_operand`` computes them). It is bound by the
    EdgeFC products (2*N*K*H*H per hidden layer; float32 CUDA cores, or
    bfloat16 tensor cores). The EdgeFC is zero-padded to the kernel's
    width (128, 256, 512, 1,024 or 2,048; past 256, and at H = 256 with
    more than 1,024 slots, bfloat16 operands run on the CUDA cores,
    ``fused_compute``), more than 4 channels run as groups, and a block's
    slots run through the EdgeFC in passes of 16384 / H (``fused_rows``):
    a K that does not fill a pass leaves its last slots masked."""
    dev = edges.device
    n, k = nlist.shape
    B, W, T = plan.block_rows, plan.window, plan.num_tiles
    h, e = edge_fc_params[-1]["kernel"].shape
    gap = (rbf_high - rbf_low) / (h - 1)  # the RBF spacing of the true width
    hp = fused_width(h)
    rows = fused_rows(k, hp, B)
    if hp != h:
        edge_fc_params = pad_edge_fc(edge_fc_params, hp)
    hidden, final = list(edge_fc_params[:-1]), edge_fc_params[-1]
    check("nlist", nlist, torch.int32, (n, k), dev)
    check("edges", edges, torch.float32, (n, k), dev)
    if n > plan.n_padded:
        raise ValueError(f"{n} rows, the plan {plan.n_padded}")
    if hidden:
        wh = torch.stack([p["kernel"] for p in hidden]).contiguous()
        bh = torch.stack([p["bias"] for p in hidden]).contiguous()
    else:  # never read with no hidden layer
        wh = torch.zeros((1, hp, hp), dtype=torch.float32, device=dev)
        bh = torch.zeros((1, hp), dtype=torch.float32, device=dev)
    lh = len(hidden)
    check("hidden kernels", wh, torch.float32, (max(lh, 1), hp, hp), dev)
    check("hidden biases", bh, torch.float32, (max(lh, 1), hp), dev)
    check("final kernel", final["kernel"].contiguous(), torch.float32, (hp, e), dev)
    check("final bias", final["bias"].contiguous(), torch.float32, (e,), dev)
    act = activation_code(activation_name)
    out_bf16 = bf16_flag("out_dtype", out_dtype)
    compute = fused_compute(bf16_flag("compute_dtype", compute_dtype), hp, k)
    if compute == 1:  # the tensor cores' B fragments: [Lh, H_out, H_in], k contiguous
        wh = wh.transpose(1, 2).to(torch.bfloat16).contiguous()
    elif compute == 2:  # bfloat16 operands on the CUDA cores: [Lh, H_in, H_out], rounded
        wh = wh.to(torch.bfloat16).to(torch.float32)
    pad = plan.n_padded - n
    nlist_p = nnf.pad(nlist, (0, 0, 0, pad), value=-1)
    edges_p = nnf.pad(edges, (0, 0, 0, pad))
    lo = _device_lo(plan, dev)
    M = torch.empty((T, e, B, W), dtype=out_dtype, device=dev)
    for c0, c1 in channel_groups(e):  # the hidden layers run again for each group
        wf = final["kernel"][:, c0:c1].contiguous()
        bf = final["bias"][c0:c1].contiguous()
        args = (nlist_p.data_ptr(), edges_p.data_ptr(), lo.data_ptr(), wh.data_ptr(),
                bh.data_ptr(), wf.data_ptr(), bf.data_ptr(), at(M, 1, c0), plan.n_padded, B, k,
                c1 - c0, W, hp, lh, float(np.float32(rbf_low)), float(np.float32(gap)),
                float(np.float32(1.0 / gap)), act, out_bf16)
        if hp in _FUSED_TC_H:
            launch("nmr_build_band_fused", dev, *args, compute, rows, e)
        else:  # csrc/fused_wide.cu: compute 0 or 2, as its b16ops flag
            launch("nmr_build_band_fused_wide", dev, *args, int(compute == 2), rows, e)
    return M


def _mp_occupancy(M, occupancy) -> torch.Tensor:
    """The band's occupancy on the card: the one given (checked), or one
    pass over M (``band_occupancy_from_band``)."""
    if occupancy is None:
        return band_occupancy_from_band(M)
    T, _, B, W = M.shape
    check("occupancy", occupancy, torch.int32, (T * B, occupancy_words(W)), M.device)
    return occupancy


def _mp_tiles(what: str, B: int, W: int, n_table: int = 0) -> None:
    """Raise unless the MP kernel takes these tiles (``mp_tiles_ok``) and,
    for a layer that ends in the epilogue, its node table's ``n_table``
    rows are whole tiles."""
    if not mp_tiles_ok(B, W):
        raise NotImplementedError(
            f"{what} kernel takes B a multiple of the rows per block, W a multiple of "
            f"{MP_CHUNK}")
    if n_table % B:
        raise ValueError(f"the node table's {n_table} rows are not whole {B}-row tiles")


def _mp_partial(M, occ, lo, table, w_b, suffix):
    """The partial launch of an MP chain over the band M (``mp.chain``'s
    step): input block ``i``'s columns of ``table`` against w's block
    (i, j), channels [c0, c1) of M, plus the float32 ``acc`` (or None);
    returns its float32 [Tg * B, fb] sum."""
    def step(i, j, c0, c1, acc):
        Tg, E, B, W = M.shape
        n_table, fp = table.shape
        fb = w_b.shape[-1]
        out = torch.empty((Tg * B, fb), dtype=torch.float32, device=table.device)
        launch("nmr_mp_banded_partial" + suffix, table.device, at(M, 1, c0), occ.data_ptr(),
               lo.data_ptr(), col(table, i * fb), at(w_b[i, j], 0, c0), out.data_ptr(), Tg,
               c1 - c0, B, W, fb, n_table, fp, E, None if acc is None else acc.data_ptr())
        return out
    return step


def _launch_mp(M, lo, ids, nodes, w, inv_degree, activation_name, what,
               occupancy) -> torch.Tensor:
    """Checks and launches the MP layer of ``csrc/hbm.cu`` over M's grid
    tiles (``ids`` None: tile i updates tile i): for each output block of
    the F-split, its chain of partial sums over the input blocks and
    channel groups, and its last launch (input block j, the last group)
    with the epilogue."""
    dev = nodes.device
    Tg, E, B, W = M.shape
    n_table, F = nodes.shape
    _mp_tiles(what, B, W, n_table)
    suffix, act, table, w_b = operands("nodes", nodes, w, E, inv_degree, activation_name)
    fp = table.shape[1]
    fb = w_b.shape[-1]
    check("M", M, nodes.dtype, (Tg, E, B, W), dev)
    occ = _mp_occupancy(M, occupancy)

    def final(i, j, c0, c1, acc):
        out = torch.empty((Tg * B, fb), dtype=nodes.dtype, device=dev)
        launch("nmr_mp_banded" + suffix, dev, at(M, 1, c0), occ.data_ptr(), lo.data_ptr(),
               None if ids is None else ids.data_ptr(), col(table, j * fb),
               at(w_b[j, j], 0, c0), inv_degree.data_ptr(), out.data_ptr(), Tg, c1 - c0, B,
               W, fb, n_table, fp, act, E, None if acc is None else acc.data_ptr())
        return out

    return chain(w_b.shape[0], channel_groups(E, mp_group_size(fp)), F,
                 _mp_partial(M, occ, lo, table, w_b, suffix), final)


def _mp_layer(M, plan: BandPlan, nodes, w, inv_degree, activation_name, what,
              occupancy) -> torch.Tensor:
    """The MP layer of every tile of ``plan`` on the card."""
    T, _, B, W = M.shape
    if (T, B, W) != (plan.num_tiles, plan.block_rows, plan.window):
        raise ValueError(f"band of shape {tuple(M.shape)} does not match the plan")
    if nodes.shape[0] != T * B:
        raise ValueError(f"nodes has {nodes.shape[0]} rows, the plan {T * B}")
    return _launch_mp(M, _device_lo(plan, nodes.device), None, nodes, w, inv_degree,
                      activation_name, what, occupancy)


@kernel(mp_banded_plain, on="nodes")
def mp_banded(
    M: torch.Tensor,           # [T, E, B, W] from a band build, in nodes.dtype
    plan: BandPlan,
    nodes: torch.Tensor,       # [N_pad, F] (padded to plan.n_padded), f32 or bf16
    w: torch.Tensor,           # [F, F, E] (cast to nodes.dtype)
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # int32 [T * B, NW] (band_occupancy), or None
) -> torch.Tensor:
    """One MP layer (activation(aggregate) + residual) over the band, in
    ``nodes.dtype`` (float32, or bfloat16 with float32 accumulation).

    Replaces ``_mp_banded_kernel`` (nmrgnn_tpu/ops/banded.py:555-579). On
    the card (``csrc/mp.cuh``, instantiated by ``csrc/hbm.cu``), a block
    takes 32 rows of one tile and half the output columns, stages only the
    window chunks its rows' band occupies and walks their nonzeros, then
    multiplies h_n by its slice of W_n: float32 FMAs on the CUDA cores, or
    bfloat16 ``mma.sync`` on the tensor cores. ``occupancy`` is the band's
    chunk occupancy, made once per band by the forwards
    (``band_occupancy``); without it the wrapper derives it from M
    (``band_occupancy_from_band``, one pass over M). Bound by the second
    product (2*T*E*B*F*F operations) in float32 and by its bytes in
    bfloat16."""
    return _mp_layer(M, plan, nodes, w, inv_degree, activation_name, "mp_banded", occupancy)


def _poly_inputs(nlist, edges, cheb: EdgeCheb, n_padded: int, what: str):
    """Checked inputs of a Chebyshev build on the card: (nlist and edges
    padded to ``n_padded`` rows with -1 and 0, the float32 coefficients
    [degree + 1, E], and the scalars (degree, d_lo, d_hi, d_hi - d_lo))."""
    dev = edges.device
    n, k = nlist.shape
    check("nlist", nlist, torch.int32, (n, k), dev)
    check("edges", edges, torch.float32, (n, k), dev)
    coeffs = torch.as_tensor(cheb.coeffs, dtype=torch.float32, device=dev).contiguous()
    deg1, e = coeffs.shape
    if not 1 <= k <= MAX_K or n > n_padded or deg1 < 2:
        raise NotImplementedError(f"{what} kernel takes K <= {MAX_K} and degree >= 1")
    poly_group_size(deg1 - 1)
    pad = n_padded - n
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return (nnf.pad(nlist, (0, 0, 0, pad), value=-1), nnf.pad(edges, (0, 0, 0, pad)), coeffs,
            (deg1 - 1, f32(cheb.d_lo), f32(cheb.d_hi), f32(cheb.d_hi - cheb.d_lo)))


def _launch_poly(nlist, edges, cheb: EdgeCheb, lo, ids, tiles: int, window: int,
                 block_rows: int, n_padded: int, out_dtype) -> torch.Tensor:
    """Checks and launches the Chebyshev band build of ``csrc/poly.cu``
    over ``tiles`` grid tiles (``ids`` None: tile i reads tile i)."""
    nlist_p, edges_p, coeffs, scalars = _poly_inputs(nlist, edges, cheb, n_padded,
                                                     "build_band_poly")
    M = torch.empty((tiles, coeffs.shape[1], block_rows, window), dtype=out_dtype,
                    device=edges.device)
    _poly_groups(nlist_p, edges_p, coeffs, scalars, lo, ids, M,
                 channel_groups(coeffs.shape[1], poly_group_size(scalars[0])), n_padded)
    return M


def _poly_groups(nlist_p, edges_p, coeffs, scalars, lo, ids, M, groups, n_padded: int):
    """Launches the Chebyshev band build of ``csrc/poly.cu`` for M's
    channel ``groups``, each with its own coefficients' columns, into M
    (its dtype) over M's grid tiles (``ids`` None: tile i reads tile i)."""
    tiles, e, B, W = M.shape
    out_bf16 = bf16_flag("out_dtype", M.dtype)
    for c0, c1 in groups:
        c = coeffs[:, c0:c1].contiguous()
        launch("nmr_build_band_poly", M.device, nlist_p.data_ptr(), edges_p.data_ptr(),
               lo.data_ptr(), None if ids is None else ids.data_ptr(), c.data_ptr(),
               at(M, 1, c0), tiles, n_padded // B, B, nlist_p.shape[1], c1 - c0, W,
               build_rows(B, nlist_p.shape[1], c1 - c0), *scalars, out_bf16, e)


@kernel(build_band_poly_plain, on="edges")
def build_band_poly(
    nlist: torch.Tensor,   # i32[N, K]
    edges: torch.Tensor,   # f32[N, K] raw distances
    cheb: EdgeCheb,        # coefficients as numpy or a tensor on the card
    plan: BandPlan,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype`` (float32 or bfloat16) straight from
    raw distances, through the Chebyshev-compressed edge stage.

    Replaces ``_poly_band_kernel`` + ``_poly_build_tile`` (nmrgnn_tpu/ops/
    banded.py:1268-1290, 1418-1448). On the card, a block takes
    ``build_rows`` rows of a tile, every thread evaluating a slot's
    recurrence into shared memory, and a warp writes each row, 16 bytes a
    lane; it is bound by writing M."""
    return _launch_poly(nlist, edges, cheb, _device_lo(plan, edges.device), None,
                        plan.num_tiles, plan.window, plan.block_rows, plan.n_padded, out_dtype)


@kernel(build_band_poly_tracedlo_plain, on="edges")
def build_band_poly_tracedlo(
    nlist: torch.Tensor,   # i32[M, K], M a multiple of block_rows
    edges: torch.Tensor,   # f32[M, K] raw distances
    cheb: EdgeCheb,
    lo,                    # i32[M / block_rows] window starts (any values)
    window: int,
    block_rows: int = 128,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M [T, E, B, W] in ``out_dtype``: ``build_band_poly`` with the
    caller's window start per tile and no padding; out-of-window indices,
    negative ones included, match nothing (``build_band_tracedlo``'s rule).

    Replaces ``build_band_poly_tracedlo`` (nmrgnn_tpu/ops/banded.py:
    1363-1415). On the card it launches ``build_band_poly``'s kernel
    (``csrc/poly.cu``), which reads ``lo`` from device memory; bound by
    writing M."""
    m = nlist.shape[0]
    T = _tiles_of(m, block_rows)
    lo = device_index("lo", lo, T, edges.device)
    return _launch_poly(nlist, edges, cheb, lo, None, T, window, block_rows, m, out_dtype)


@kernel(mp_banded_poly_fused_plain, on="nodes")
def mp_banded_poly_fused(
    nlist: torch.Tensor,       # i32[N, K]
    edges: torch.Tensor,       # f32[N, K] raw distances
    cheb: EdgeCheb,            # coefficients as numpy or a tensor on the card
    plan: BandPlan,
    nodes: torch.Tensor,       # [N_pad, F] embedded node table, f32 or bf16
    w: torch.Tensor,           # [F, F, E] layer-1 weights (cast to nodes.dtype)
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    out_dtype=torch.float32,
):
    """(M [T, E, B, W] in ``out_dtype``, nodes_1 [T * B, F] in
    ``nodes.dtype``): the Chebyshev band build and MP layer 1 in one
    kernel; the same function as ``build_band_poly`` followed by
    ``mp_banded``, with layer 1 on the float32 band rounded to
    ``nodes.dtype``.

    Replaces ``_poly_mp_fused_kernel`` + ``mp_banded_poly_fused``
    (nmrgnn_tpu/ops/banded.py:1451-1604). On the card it is ``mp_banded``'s
    kernel (``csrc/mp.cuh``, instantiated by ``csrc/fused_first.cu``) with
    the band built in the block from the raw distances instead of read: the
    block marks the chunks its rows' slots fall in, builds and multiplies
    only those, and writes every entry of M once, zeros included. Bound as
    ``mp_banded``, plus writing M."""
    dev = nodes.device
    B, W, T = plan.block_rows, plan.window, plan.num_tiles
    n_pad, F = nodes.shape
    nlist_p, edges_p, coeffs, scalars = _poly_inputs(nlist, edges, cheb, plan.n_padded,
                                                     "mp_banded_poly_fused")
    e = coeffs.shape[1]
    if n_pad != plan.n_padded:
        raise ValueError(f"nodes has {n_pad} rows, the plan {plan.n_padded}")
    _mp_tiles("mp_banded_poly_fused", B, W, n_pad)
    suffix, act, table, w_b = operands("nodes", nodes, w, e, inv_degree, activation_name)
    fp = table.shape[1]
    fb, nb = mp_split(fp)
    m_bf16 = bf16_flag("out_dtype", out_dtype)
    lo = _device_lo(plan, dev)
    M = torch.empty((T, e, B, W), dtype=out_dtype, device=dev)
    groups = channel_groups(e, min(mp_group_size(fp), poly_group_size(scalars[0])))
    # the channels the partial launches read (the groups but the last, and
    # every group under an F-split): B4's kernel builds them (in
    # nodes.dtype for the layer, as the fused kernel rounds its float32
    # band); the fused launch writes its group's channels again, the same
    # values (one builder, common.cuh's band_rows order)
    read = groups[:-1] if nb == 1 else groups
    Mh = occ = None
    if read:
        _poly_groups(nlist_p, edges_p, coeffs, scalars, lo, None, M, read, n_pad)
        Mh = M
        if out_dtype != nodes.dtype:
            Mh = torch.empty((T, read[-1][1], B, W), dtype=nodes.dtype, device=dev)
            _poly_groups(nlist_p, edges_p, coeffs, scalars, lo, None, Mh, read, n_pad)
        occ = band_occupancy(nlist_p, edges_p, lo, W, B, n_pad)
    c = coeffs[:, groups[-1][0]:groups[-1][1]].contiguous()

    def final(i, j, c0, c1, acc):
        out = torch.empty((T * B, fb), dtype=nodes.dtype, device=dev)
        launch("nmr_mp_banded_poly_fused" + suffix, dev, nlist_p.data_ptr(),
               edges_p.data_ptr(), c.data_ptr(), lo.data_ptr(), col(table, j * fb),
               at(w_b[j, j], 0, c0), inv_degree.data_ptr(), out.data_ptr(), at(M, 1, c0), T,
               c1 - c0, B, W, fb, fp, nlist.shape[1], *scalars, m_bf16, act, e,
               None if acc is None else acc.data_ptr())
        return out

    return M, chain(nb, groups, F, _mp_partial(Mh, occ, lo, table, w_b, suffix), final)


@kernel(build_band_poly_cls_plain, on="edges")
def build_band_poly_cls(
    nlist: torch.Tensor,   # i32[N, K]
    edges: torch.Tensor,   # f32[N, K] raw distances
    cheb: EdgeCheb,
    cls: BandClass,        # ids and lo as numpy or int32 tensors on the card
    block_rows: int,
    n_padded: int,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """M_c [Tc, E, B, Wc]: ``build_band_poly`` over one window class's
    tiles, tile ``cls.ids[i]`` into ``M_c[i]``.

    Replaces ``build_band_poly_cls`` (nmrgnn_tpu/ops/banded.py:1645-1700).
    On the card it is the kernel of ``build_band_poly`` reading its rows
    through the ids array (an id out of range reads nothing); it is bound
    by writing M_c."""
    dev = edges.device
    tc = len(cls.ids)
    ids = device_index("cls.ids", cls.ids, tc, dev)
    lo = device_index("cls.lo", cls.lo, tc, dev)
    return _launch_poly(nlist, edges, cheb, lo, ids, tc, cls.window, block_rows, n_padded,
                        out_dtype)


@kernel(mp_banded_partial_plain, on="table")
def mp_banded_partial(
    M: torch.Tensor,      # [T, E, B, W], in table.dtype
    lo,                   # i32[T] window starts (numpy, or int32 on the card)
    table: torch.Tensor,  # [Nt, F] window source, f32 or bf16, Nt >= max(lo) + W
    w: torch.Tensor,      # [F, F, E] (cast to table.dtype)
    occupancy=None,       # int32 [T * B, NW] (band_occupancy), or None
) -> torch.Tensor:
    """Partial MP aggregation f32[T * B, F] = sum_n (M_n @ table window) @
    w_n: no inv_degree, activation or residual.

    Replaces ``_mp_banded_partial_kernel`` (nmrgnn_tpu/ops/banded.py:
    833-894). On the card it is the MP kernel of ``mp_banded`` without its
    epilogue (``csrc/hbm.cu``), with the same occupancy rule; window rows
    outside the table read as zeros. Bound as ``mp_banded``."""
    T, E, B, W = M.shape
    n_table, F = table.shape
    _mp_tiles("mp_banded_partial", B, W)
    suffix, _, table_p, w_b = operands("table", table, w, E)
    check("M", M, table.dtype, (T, E, B, W), table.device)
    if not isinstance(lo, torch.Tensor):
        lo_np = np.asarray(lo)
        if lo_np.size and (lo_np.min() < 0 or lo_np.max() + W > n_table):
            raise ValueError("windows must lie inside the table")
    lo = device_index("lo", lo, T, table.device)
    occ = _mp_occupancy(M, occupancy)
    return chain(w_b.shape[0], channel_groups(E, mp_group_size(table_p.shape[1])), F,
                 _mp_partial(M, occ, lo, table_p, w_b, suffix))


@kernel(mp_banded_hbm_plain, on="nodes")
def mp_banded_hbm(
    M: torch.Tensor,           # [T, E, B, W] from a band build, in nodes.dtype
    plan: BandPlan,
    nodes: torch.Tensor,       # [N_pad, F] node table, f32 or bf16
    w: torch.Tensor,           # [F, F, E] (cast to nodes.dtype)
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # int32 [T * B, NW] (band_occupancy), or None
) -> torch.Tensor:
    """One MP layer (activation(aggregate) + residual) with the node table
    read from device memory tile by tile; the same function as
    ``mp_banded``, bit for bit.

    Replaces ``_mp_banded_hbm_kernel`` (nmrgnn_tpu/ops/banded.py:656-773).
    On the card it launches ``mp_banded``'s kernel (``csrc/hbm.cu``),
    which already reads the table from device memory, the next occupied
    chunk of window and band in flight while the current one is used: on
    Hopper no path holds the table on chip, so the TPU's resident and HBM
    kernels are one kernel here. Bound as ``mp_banded``."""
    return _mp_layer(M, plan, nodes, w, inv_degree, activation_name, "mp_banded_hbm",
                     occupancy)


@kernel(mp_banded_hbm_cls_plain, on="nodes")
def mp_banded_hbm_cls(
    M: torch.Tensor,           # [Tc, E, B, Wc] from build_band_poly_cls, in nodes.dtype
    cls: BandClass,            # ids and lo as numpy or int32 tensors on the card
    block_rows: int,
    nodes: torch.Tensor,       # [N_pad, F] node table, f32 or bf16
    w: torch.Tensor,           # [F, F, E] (cast to nodes.dtype)
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # int32 [Tc * B, NW] (band_occupancy with the ids), or None
) -> torch.Tensor:
    """One MP layer over one window class's tiles with the node table in
    device memory: class-contiguous rows [Tc * B, F] in ``nodes.dtype``,
    row block i the update of tile ``cls.ids[i]``.

    Replaces ``_mp_banded_hbm_cls_kernel`` (nmrgnn_tpu/ops/banded.py:
    1703-1823). On the card it is ``mp_banded_hbm``'s kernel reading its
    residual rows and inv_degree through the ids array; an id out of range
    given on the card reads nothing and writes zeros, one given as numpy
    raises. Bound as ``mp_banded_hbm``."""
    dev = nodes.device
    tc, _, B, W = M.shape
    if B != block_rows or len(cls.ids) != tc or cls.window != W:
        raise ValueError(f"band of shape {tuple(M.shape)} does not match the class")
    n_tiles = nodes.shape[0] // B
    for name, a, hi in (("cls.ids", cls.ids, n_tiles - 1),
                        ("cls.lo", cls.lo, nodes.shape[0] - W)):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            if a.size and (a.min() < 0 or a.max() > hi):
                raise ValueError(f"{name} out of range [0, {hi}]")
    ids = device_index("cls.ids", cls.ids, tc, dev)
    lo = device_index("cls.lo", cls.lo, tc, dev)
    return _launch_mp(M, lo, ids, nodes, w, inv_degree, activation_name, "mp_banded_hbm_cls",
                      occupancy)


@kernel(band_occupancy_plain, on="edges")
def band_occupancy(
    nlist: torch.Tensor,   # i32[N, K]
    edges: torch.Tensor,   # f32[N, K] distances, 0 on padding slots
    lo,                    # i32[Tg] window starts (numpy, or int32 on the card)
    window: int,
    block_rows: int,
    n_padded: int,
    ids=None,              # i32[Tg] tile ids of a class (None: tile i)
) -> torch.Tensor:
    """int32 [Tg * B, NW]: the chunk occupancy of the band that any build
    of this module makes from (nlist, edges) with these window starts (and
    ids), for the MP kernels (``band_occupancy_plain`` says which bits).
    The forwards make it once per band and hand it to every layer.

    A kernel of the port with no TPU counterpart: it feeds the MP kernel
    that replaces B1, B5, B6 and B9 (``csrc/mp.cuh``). On the card one
    warp takes a band row, its lanes the row's slots, and writes the
    row's words with a warp OR; bound by reading nlist and the distances."""
    dev = edges.device
    n, k = nlist.shape
    tg = len(lo)
    check("nlist", nlist, torch.int32, (n, k), dev)
    check("edges", edges, torch.float32, (n, k), dev)
    if window % MP_CHUNK or n_padded % block_rows:
        raise ValueError(f"window {window} is not whole {MP_CHUNK}-column chunks, or "
                         f"{n_padded} rows not whole {block_rows}-row tiles")
    lo = device_index("lo", lo, tg, dev)
    ids = None if ids is None else device_index("ids", ids, tg, dev)
    occ = torch.empty((tg * block_rows, occupancy_words(window)), dtype=torch.int32, device=dev)
    launch("nmr_band_occupancy", dev, nlist.data_ptr(), edges.data_ptr(), lo.data_ptr(),
           None if ids is None else ids.data_ptr(), occ.data_ptr(), tg, n,
           n_padded // block_rows, block_rows, k, window)
    return occ


@kernel(band_occupancy_from_band_plain, on="M")
def band_occupancy_from_band(M: torch.Tensor) -> torch.Tensor:
    """int32 [T * B, NW]: the chunk occupancy of a band M [T, E, B, W]
    read from M itself, for an MP call given no occupancy (the JAX
    package's signature).

    A kernel of the port with no TPU counterpart, feeding the MP kernel
    (``csrc/mp.cuh``): one warp a band row, a lane a chunk, one pass over
    M; bound by reading M."""
    dev = M.device
    T, E, B, W = M.shape
    suffix = dtype_suffix("M", M.dtype)
    check("M", M, M.dtype, (T, E, B, W), dev)
    if W % MP_CHUNK:
        raise ValueError(f"window {W} is not whole {MP_CHUNK}-column chunks")
    occ = torch.empty((T * B, occupancy_words(W)), dtype=torch.int32, device=dev)
    launch("nmr_band_occupancy_from_band" + suffix, dev, M.data_ptr(), occ.data_ptr(), T, E,
           B, W)
    return occ

# ---------------------------------------------------------------------------
# Differentiable wrappers (``nmrgnn_tpu/ops/banded.py:897-1104``): training
# through the kernels. Each is a ``torch.autograd.Function`` whose forward is
# the kernel wrapper above (the CUDA kernel on the card, the plain version on
# the CPU) and whose backward is the JAX package's backward form in plain
# PyTorch. The JAX package computes those backwards in XLA, outside any
# Pallas kernel:
#   * a band build's backward reads the band's cotangent back at each slot:
#     de[i, k, :] = dM[tile(i), :, i % B, nlist[i, k] - lo[tile(i)]] where
#     that column lies in the window, else 0 (a gather along the window axis);
#   * an MP layer's backward is the VJP of its plain version in float32
#     (``mp_banded_plain``, ``mp_banded_partial_plain``), recomputed under
#     autograd: band-form products and a window scatter-add, no [N, K, F]
#     gather.
# Operands are made contiguous inside the forwards: the kernels take
# contiguous, aligned tensors, and autograd may hand views.


def _band_vjp(gM: torch.Tensor, nlist: torch.Tensor, lo_rows: torch.Tensor,
              window: int) -> torch.Tensor:
    """de f32[N, K, E] from the band's cotangent gM [T, E, B, W]: row i's
    slot k reads gM at its tile's column nlist[i, k] - lo_rows[i] when that
    lies in [0, W), and is 0 otherwise."""
    n, k = nlist.shape
    T, E, B, W = gM.shape
    rel = nlist.to(torch.int64) - lo_rows[:, None]
    valid = (rel >= 0) & (rel < window)
    gmr = gM.float().permute(0, 2, 3, 1).reshape(T * B, W, E)[:n]       # [N, W, E]
    de = torch.gather(gmr, 1, rel.clamp(0, window - 1)[..., None].expand(n, k, E))
    return de * valid[..., None].to(de.dtype)


class _BuildBandDF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_feats, nlist, plan, out_dtype):
        ctx.save_for_backward(nlist)
        ctx.plan = plan
        return build_band(nlist, edge_feats.contiguous(), plan, out_dtype)

    @staticmethod
    def backward(ctx, gM):
        (nlist,) = ctx.saved_tensors
        plan = ctx.plan
        lo_rows = as_long(plan.lo, nlist.device).repeat_interleave(plan.block_rows)[:nlist.shape[0]]
        return _band_vjp(gM, nlist, lo_rows, plan.window), None, None, None


def build_band_df(
    nlist: torch.Tensor,       # i32[N, K]
    edge_feats: torch.Tensor,  # f32[N, K, E], differentiated
    plan: BandPlan,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """``build_band`` with a gradient to ``edge_feats``
    (``nmrgnn_tpu/ops/banded.py:1015-1054``): forward B2, backward the
    window gather of ``_band_vjp``."""
    return _BuildBandDF.apply(edge_feats, nlist.to(torch.int32).contiguous(), plan, out_dtype)


class _BuildBandTracedloDF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_feats, nlist, lo, window, block_rows, out_dtype):
        ctx.save_for_backward(nlist, lo)
        ctx.window, ctx.block_rows = window, block_rows
        return build_band_tracedlo(nlist, edge_feats.contiguous(), lo, window, block_rows,
                                   out_dtype)

    @staticmethod
    def backward(ctx, gM):
        nlist, lo = ctx.saved_tensors
        lo_rows = lo.repeat_interleave(ctx.block_rows)
        return _band_vjp(gM, nlist, lo_rows, ctx.window), None, None, None, None, None


def build_band_tracedlo_df(
    nlist: torch.Tensor,       # i32[M, K], M a multiple of block_rows
    edge_feats: torch.Tensor,  # f32[M, K, E], differentiated
    lo,                        # i32[M / block_rows] window starts (any values)
    window: int,
    block_rows: int = 128,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """``build_band_tracedlo`` with a gradient to ``edge_feats``
    (``nmrgnn_tpu/ops/banded.py:958-1001``): forward B7a, backward the
    window gather of ``_band_vjp`` with the caller's window starts."""
    lo = as_long(lo, edge_feats.device)
    if lo.shape != (_tiles_of(nlist.shape[0], block_rows),):
        raise ValueError(f"{lo.shape[0]} window starts for {nlist.shape[0]} rows")
    return _BuildBandTracedloDF.apply(edge_feats, nlist.to(torch.int32).contiguous(), lo,
                                      window, block_rows, out_dtype)


def _plain_vjp(fn, inputs, needs, g):
    """The cotangents of ``fn(*inputs)`` (float32 copies, recomputed under
    autograd) against ``g``, for the inputs ``needs`` marks; None for the
    others."""
    with torch.enable_grad():
        xs = [x.detach().float().requires_grad_(need) for x, need in zip(inputs, needs)]
        out = fn(*xs)
        wanted = [x for x, need in zip(xs, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)) if wanted else ())
    return [next(grads) if need else None for need in needs]


class _MPBandedDF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, M, nodes, w, inv_degree, plan, activation_name, occupancy):
        ctx.save_for_backward(M, nodes, w, inv_degree)
        ctx.plan, ctx.activation_name = plan, activation_name
        return mp_banded(M.contiguous(), plan, nodes.contiguous(), w, inv_degree.contiguous(),
                         activation_name, occupancy)

    @staticmethod
    def backward(ctx, g):
        M, nodes, w, inv_degree = ctx.saved_tensors
        plan, act = ctx.plan, ctx.activation_name
        grads = _plain_vjp(lambda M, nodes, w, inv: mp_banded_plain(M, plan, nodes, w, inv, act),
                           (M, nodes, w, inv_degree), ctx.needs_input_grad[:4], g)
        out = [None if d is None else d.to(x.dtype) for d, x in zip(grads, (M, nodes, w, inv_degree))]
        return (*out, None, None, None)


def mp_banded_df(
    M: torch.Tensor,           # [T, E, B, W]
    plan: BandPlan,
    nodes: torch.Tensor,       # [N_pad, F]
    w: torch.Tensor,           # [F, F, E]
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # int32 [T * B, NW] (band_occupancy), or None
) -> torch.Tensor:
    """``mp_banded`` with gradients to M, nodes, w and inv_degree (those
    autograd asks for) (``nmrgnn_tpu/ops/banded.py:1057-1091``): forward
    B1, backward the VJP of ``mp_banded_plain`` in float32, as
    ``jax.vjp`` of ``mp_banded_xla``. ``occupancy`` must cover every
    nonzero of M (``band_occupancy`` from the distances before any
    training noise): the backward reads all of M."""
    return _MPBandedDF.apply(M, nodes, w, inv_degree, plan, activation_name, occupancy)


class _MPBandedPartialDF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, M, table, w, lo, occupancy):
        ctx.save_for_backward(M, table, w, lo)
        return mp_banded_partial(M.contiguous(), lo, table.contiguous(), w, occupancy)

    @staticmethod
    def backward(ctx, g):
        M, table, w, lo = ctx.saved_tensors
        grads = _plain_vjp(lambda M, table, w: mp_banded_partial_plain(M, lo, table, w),
                           (M, table, w), ctx.needs_input_grad[:3], g)
        out = [None if d is None else d.to(x.dtype) for d, x in zip(grads, (M, table, w))]
        return (*out, None, None)


def mp_banded_partial_df(
    M: torch.Tensor,      # [T, E, B, W]
    lo,                   # i32[T] window starts
    table: torch.Tensor,  # [Nt, F]
    w: torch.Tensor,      # [F, F, E]
    occupancy=None,       # int32 [T * B, NW], or None
) -> torch.Tensor:
    """``mp_banded_partial`` with gradients to M, table and w
    (``nmrgnn_tpu/ops/banded.py:924-955``): forward B6, backward the VJP
    of ``mp_banded_partial_plain`` in float32 (``mp_banded_partial_xla``'s,
    :897-917)."""
    return _MPBandedPartialDF.apply(M, table, w, as_long(lo, table.device), occupancy)
