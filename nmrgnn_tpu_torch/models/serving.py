"""Serving (``nmrgnn_tpu/models/serving.py``), one device: single
structures, batches of frames and trajectories.

The first call fixes the RCM atom ordering (``reorder=False`` serves the
graph as given) and the path, as the JAX package resolves it
(``_resolve_mode``):

* ``"banded"`` when the band plan passes the JAX package's node-table
  budget (``plan_fits_vmem`` and ``fused_build_ok``, at ``block_size`` or
  ``block_size // 2`` rows per tile): the MP layers through ``mp_banded``;
* ``"banded_hbm"`` for larger structures whose band passes the per-tile
  budget (``hbm_plan_fits_vmem``): the MP layers through ``mp_banded_hbm``,
  and at ``precision="fast"`` with more than one window class the
  class-bucketed ``apply_banded_hbm_classes``;
* ``"blocksparse"`` when the band escapes both budgets (a single large
  globular structure): ``apply_blocksparse`` over the block structure of
  ``block_size`` blocks (``pair_rounding`` and ``group`` as the JAX
  package's accelerator path sets them), at either precision.

These budgets are the JAX package's rule for which path, and so which
numerics, a structure takes; the Hopper kernels take any window.
``mode="banded"`` forces the node-table path (with the full band plan
where the budget would refuse it), ``mode="blocksparse"`` the block-sparse
one.

An attention-family model (``mp_type="attention"``) ignores ``mode``, as
in the JAX package: it resolves to ``"banded_attn"``
(``apply_banded_attention``: one E=1 band a layer) when the band plan
passes the node-table budget with one edge channel and no fused-build
check (``_plan_if_attn``), else to ``"gather"`` (``gnn.apply``). The port
keeps this rule on the CPU too, where the JAX package serves the family
through "gather". Another non-bilinear ``mp_type`` resolves to "gather".

A family that reads the atoms' positions (``gnn.POSITIONS_FAMILIES``,
each with its forward in ``gnn.POSITIONS_FORWARDS``: PaiNN,
``mp_type="painn"``; the equivariant transformer, ``mp_type="et"``;
MACE, ``mp_type="mace"``) serves through
``predict(graph, positions=f32[N, 3] nm)`` on "gather"; the positions are
copied up with the graph and put in the serving order on the card with
it. ``predict_frames``, ``predict_trajectory`` and "partitioned" serving
do not take these families and raise, each naming the family, as
``predict`` does without positions.

Each later frame verifies the cached band plan against its own neighbor
lists (``plan_covers``) and rebuilds it only when a real neighbor escapes
its window; a frame whose new plan escapes the budget that chose the path
re-resolves the path, which may then be "blocksparse". A block structure
is remapped to a later frame (``remap_frame``) and rebuilt only when a real
edge leaves its active pairs. ``predict`` returns peaks in the original
atom order.

A request is prepared on the device: the graph as given is copied up, then
one launch (``ops.banded.permute_tile_bounds``) writes it in the RCM order
and takes each tile's smallest and largest real neighbor index, through
which alone the band plans read a frame (``band_plan_from_bounds``,
``plan_covers_bounds`` and their class twins). The host reads back those
bounds (a few KB) and keeps only arithmetic over the tiles; "gather" reads
none. On the card the copy and the launch run on a preparation stream of
the model's own, which the forward's stream waits for, so a trajectory's
next frame is prepared while the last one's forward runs. "blocksparse"
and "partitioned" read the whole permuted arrays on the host
(``remap_frame``, the partition's digests) and permute there, as do
``predict_frames``' batches.

``precision="exact"`` serves in the config's compute type (float32 by
default; a ``compute_dtype="bfloat16"`` config serves with bfloat16
products and float32 sums, as in the JAX package) through the fused RBF +
EdgeFC band build. ``precision="fast"``, the JAX package's production serving
configuration, computes the products in bfloat16 with float32 sums and
replaces the edge stage by its degree-64 Chebyshev fit, fitted once per
model. On a skewed window distribution (a class plan of more than one
class) it serves through the class-bucketed forward of its path, else
through ``apply_banded(cheb=...)``. A class plan is verified and reused
across frames like the uniform plan; when frame motion re-buckets the
classes (another shape signature), new class plans of that path are
switched off for good (``_cls_vmem_off``, ``_cls_hbm_off``) and the frames
that the cached class plan does not cover take the uniform forward, as in
the JAX package. "fast" serves on the CPU too, through the plain versions
of the kernels.

With a ``mesh`` (``parallel.make_mesh``) whose ``partition_axis`` has more
than one rank, every structure resolves to ``"partitioned"`` first, as in
the JAX package: it is padded to shards x 128 rows, split by atom rows
over the axis' ranks (one process each, ``torch.distributed``) and served
through ``parallel.apply_partitioned_banded`` (B7a or B7b and B6, the halo
exchange overlapped with the interior band) when the shard's working set
passes the JAX package's budget (``_partitioned_fits_vmem``), else through
``parallel.apply_partitioned_halo`` (plain PyTorch). Every rank calls
``predict`` with the whole structure and gets the whole [N] peaks.

``predict_frames`` serves a batch of frames of a "banded" or
"banded_attn" structure in one forward over their union plan
(``apply_banded_frames``, ``apply_banded_attention_frames``) with one
readback, and the other paths frame by frame; ``predict_trajectory``
overlaps the host's graph builds with the forwards.

Under a ``torch.profiler`` session each request is a ``nmrgnn.predict``
span whose children split it: ``nmrgnn.h2d`` (the graph's copy),
``nmrgnn.permute`` (the preparation's launch; the host's permutation on
the paths that keep it, before their ``nmrgnn.h2d``), ``nmrgnn.resolve``
(when the path is chosen), ``nmrgnn.plan`` (the bounds' readback and the
cached plan's check; a ``nmrgnn.plan.build`` inside it for each miss),
``nmrgnn.h2d`` again when a new plan is copied, ``nmrgnn.forward`` (one
``nmrgnn.mp`` a layer inside) and ``nmrgnn.readback``; a trajectory adds
``nmrgnn.build`` on the build threads and ``nmrgnn.queue_wait`` on the
consumer (``utils.profiling.span``).
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..data.reorder import permute_graph, rcm_order
from ..graph import Graph
from ..ops.banded import (
    BandClassPlan,
    BandPlan,
    band_plan_classes_from_bounds,
    band_plan_from_bounds,
    class_plan_covers_bounds,
    coarsen_bounds,
    fused_build_ok,
    hbm_plan_fits_vmem,
    permute_tile_bounds,
    plan_covers_bounds,
    plan_fits_vmem,
    plan_on_device,
    tile_bounds,
)
from ..ops.blocksparse import BlockStructure, block_structure, remap_frame, struct_on_device
from ..ops.edgefn import EdgeCheb, fit_edge_chebyshev
from ..utils.profiling import span
from . import gnn
from .gnn import tree_map
from .infer import (
    apply_banded,
    apply_banded_attention,
    apply_banded_attention_frames,
    apply_banded_classes,
    apply_banded_frames,
    apply_banded_hbm_classes,
    apply_blocksparse,
    padding_rows,
)

CHEB_DEGREE = 64  # the Chebyshev fit the JAX package serves with
_GRAPH_DTYPES = (torch.float32, torch.int32, torch.float32, torch.float32)
_HOST_PATHS = ("partitioned", "blocksparse")  # paths that permute on the host


def _class_signature(plan: BandClassPlan):
    return (plan.n_padded, plan.block_rows,
            tuple((len(c.ids), c.window) for c in plan.classes))


def _tensors(x):
    """The tensors of a (nested) tuple: a plan on the device."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


class _TileBounds:
    """A frame's tile bounds (``ops.banded.tile_bounds``) at ``rows`` rows
    a tile, read on first use (on the card: a wait for the preparation's
    launch and a copy of a few KB), and at any multiple of ``rows``; ``n``
    and ``k`` are the frame's atoms and neighbor slots."""

    def __init__(self, read, rows: int, n: int, k: int):
        self._read, self._fine = read, None
        self.rows, self.n, self.k = rows, n, k

    @classmethod
    def of(cls, g: Graph, rows: int) -> "_TileBounds":
        """Of host arrays: a frame, or a stack of frames (their union)."""
        return cls(lambda: tile_bounds(g.nlist, g.edges, rows), rows, *np.shape(g.nlist)[-2:])

    def at(self, block_rows: int) -> np.ndarray:
        if self._fine is None:
            self._fine = self._read()
        return coarsen_bounds(self._fine, block_rows // self.rows)


class ServingModel:
    def __init__(
        self,
        params,
        config: ModelConfig,
        device="cuda",
        reorder: bool = True,
        block_size: int = 128,
        pair_rounding: int = 32,
        group: int = 4,
        mode: str = "auto",
        precision: str = "exact",
        mesh=None,
        partition_axis: str = "graph",
    ):
        """``params`` is a tree of numpy arrays or tensors (``load_model``
        or ``init_params``); it is copied to ``device`` once. ``mode``
        "auto" resolves the path on the first call; "banded" forces the
        node-table path (with the full band plan where the budget would
        refuse it), "blocksparse" the block-sparse path, whose structure
        rounds its pair count to a multiple of ``pair_rounding`` and pads
        each row's pairs to a multiple of ``group``. ``precision`` is
        "exact" (the config's compute type, the exact edge stage) or "fast"
        (bfloat16 products with float32 sums; on the banded paths the
        Chebyshev edge stage). ``mesh`` (``parallel.Mesh``) with more than
        one rank on ``partition_axis`` serves each structure split over
        those ranks ("partitioned"); ``device`` is then this rank's."""
        if precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision {precision!r}")
        if mode not in ("auto", "banded", "blocksparse"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if precision == "fast" and config.compute_dtype == "float32":
            config = config.replace(compute_dtype="bfloat16")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the plain matmuls (embedding, FC block, head) stay float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self._positions = config.mp_type in gnn.POSITIONS_FAMILIES
        self.precision = precision
        self.reorder = reorder
        self.block_size = block_size
        self.pair_rounding = pair_rounding
        self.group = group
        self.mode = mode
        self.params = tree_map(
            lambda t: torch.as_tensor(t).to(device=self.device, dtype=torch.float32), params
        )
        self._order: Optional[np.ndarray] = None
        self._inverse: Optional[np.ndarray] = None
        self._order_d = None  # (order, inverse) as int32 on the device
        self._prep: Optional[torch.cuda.Stream] = None  # the preparation stream (CUDA)
        self._resolved: Optional[str] = None
        self._plan: Optional[BandPlan] = None
        self._frames_plan: Optional[BandPlan] = None  # union plan of predict_frames
        self._cls_plan: Optional[BandClassPlan] = None       # "banded_hbm" class plan
        self._cls_plan_vmem: Optional[BandClassPlan] = None  # "banded" class plan
        self._cls_vmem_off = False  # set when frame motion re-buckets the classes
        self._cls_hbm_off = False   # the "banded_hbm" twin
        self._struct: Optional[BlockStructure] = None  # "blocksparse" structure
        self._cheb: Optional[EdgeCheb] = None
        self._on_device = {}  # slot -> (host plan, its copy on the device)
        self.mesh = mesh
        self.partition_axis = partition_axis
        if self._positions and self._n_shards() > 1:
            raise ValueError(f"mp_type={config.mp_type!r} is not served partitioned over a mesh")
        self._part_key = None   # the cached partitioned plan's topology key
        self._part_plan = None  # (plan, banded, this shard's plan arrays on the device)

    # -- path selection and plans --------------------------------------------

    def _fix_order(self, g: Graph) -> None:
        """On the first call (and for a structure of another size) the RCM
        ordering and its inverse, on the host."""
        if not self.reorder:
            self._inverse = None
            return
        n = g.atoms.shape[0]
        if self._order is None or self._order.shape[0] != n:
            self._order = rcm_order(g.nlist, g.edges)
            self._inverse = np.empty(n, np.int64)
            self._inverse[self._order] = np.arange(n)
            self._order_d = None

    def _permute_host(self, g: Graph) -> Graph:
        """The RCM ordering applied on the host ("blocksparse",
        "partitioned", ``predict_frames``)."""
        with span("nmrgnn.permute"):
            self._fix_order(g)
            if self.reorder:
                g, _ = permute_graph(g, self._order, pin_zero=False)
        return g

    def _bound_rows(self) -> int:
        """The tile height of the preparation's bounds: half a tile, which
        both tile heights the plans try are multiples of."""
        return math.gcd(self.block_size, self.block_size // 2)

    def _prep_stream(self) -> Optional[torch.cuda.Stream]:
        if self.device.type != "cuda":
            return None
        if self._prep is None:
            self._prep = torch.cuda.Stream(device=self.device)
        return self._prep

    def _on_prep(self, prep):
        return contextlib.nullcontext() if prep is None else torch.cuda.stream(prep)

    def _hand_over(self, prep, tensors) -> None:
        """The current stream waits for the preparation stream's work so
        far, and ``tensors`` (allocated there) are kept until it has used
        them."""
        if prep is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(prep)
        for t in tensors:
            t.record_stream(cur)

    def _prepare(self, g: Graph,
                 positions=None) -> Tuple[Graph, _TileBounds, Optional[torch.Tensor]]:
        """(the request's graph on the device in the serving order, its tile
        bounds, its ``positions`` there in the same order or None): the
        graph and positions as given copied up (``nmrgnn.h2d``), then the
        graph permuted with its bounds taken in one launch and the positions
        gathered (``nmrgnn.permute``). On the card these run on the
        preparation stream and the bounds come back into pinned memory
        there when a plan first reads them."""
        dev, rows, prep = self.device, self._bound_rows(), self._prep_stream()
        with self._on_prep(prep):
            with span("nmrgnn.h2d"):
                raw = [torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)
                       for a, dt in zip(g, _GRAPH_DTYPES)]
                pos = (None if positions is None else torch.from_numpy(
                    np.ascontiguousarray(positions, np.float32)).to(dev))
            with span("nmrgnn.permute"):
                self._fix_order(g)
                if self.reorder and self._order_d is None:
                    self._order_d = tuple(torch.as_tensor(a.astype(np.int32), device=dev)
                                          for a in (self._order, self._inverse))
                *gd, bounds = permute_tile_bounds(*raw, *(self._order_d or (None, None)), rows)
                if pos is not None and self._order_d is not None:
                    pos = pos.index_select(0, self._order_d[0])
        gd = Graph(*gd)
        shape = g.nlist.shape
        if prep is None:
            return gd, _TileBounds(bounds.numpy, rows, *shape), pos
        self._hand_over(prep, gd if pos is None else (*gd, pos))

        def read():
            with torch.cuda.stream(prep):
                host = torch.empty(bounds.shape, dtype=bounds.dtype, pin_memory=True)
                host.copy_(bounds, non_blocking=True)
                done = torch.cuda.Event()
                done.record(prep)
            done.synchronize()
            return host.numpy()

        return gd, _TileBounds(read, rows, *shape), pos

    def _frame_bounds(self, frame) -> _TileBounds:
        """A frame's tile bounds: ``frame`` itself, or those of a host
        ``Graph`` in the serving order."""
        if isinstance(frame, _TileBounds):
            return frame
        return _TileBounds.of(Graph(*[np.asarray(a) for a in frame]), self._bound_rows())

    def _padding_rows(self, g: Graph) -> np.ndarray:
        """``padding_rows`` of the served graph, from the graph as given:
        its padding slots' indices renamed through the inverse ordering."""
        nl = np.asarray(g.nlist)[np.asarray(g.edges) <= 0]
        if self._inverse is not None:
            nl = self._inverse[nl]
        return np.unique(nl[nl >= 0]).astype(np.int64)

    def _dtype_bytes(self) -> int:
        return 2 if self.config.compute_dtype == "bfloat16" else 4

    def _plan_within(self, frame, fits) -> Optional[BandPlan]:
        """A band plan that ``fits(plan, k)`` passes (k: the frame's
        neighbor slots), trying half-height tiles for wide bands; None if
        neither passes."""
        tb = self._frame_bounds(frame)
        for block_rows in (self.block_size, self.block_size // 2):
            plan = band_plan_from_bounds(tb.at(block_rows), tb.n, block_rows)
            if fits(plan, tb.k):
                return plan
        return None

    def _plan_if_fits(self, frame) -> Optional[BandPlan]:
        """A band plan within the node-table and fused-build budgets."""
        cfg, b = self.config, self._dtype_bytes()
        return self._plan_within(frame, lambda plan, k: plan_fits_vmem(
            plan, cfg.atom_feature_size, cfg.edge_feature_size, dtype_bytes=b,
        ) and fused_build_ok(
            plan, cfg.edge_hidden_size, cfg.edge_feature_size, k, out_bytes=b,
        ))

    def _plan_if_hbm(self, frame) -> Optional[BandPlan]:
        """A band plan within the per-tile budget of the HBM node-table
        path."""
        cfg, b = self.config, self._dtype_bytes()
        return self._plan_within(frame, lambda plan, k: hbm_plan_fits_vmem(
            plan, cfg.atom_feature_size, cfg.edge_feature_size, dtype_bytes=b))

    def _plan_if_attn(self, frame) -> Optional[BandPlan]:
        """A band plan for the attention band (one channel, no fused
        build) within the node-table budget."""
        cfg, b = self.config, self._dtype_bytes()
        return self._plan_within(frame, lambda plan, k: plan_fits_vmem(
            plan, cfg.atom_feature_size, n_edge_channels=1, dtype_bytes=b))

    def _resolve_mode(self, frame) -> str:
        """"banded", "banded_hbm" or "blocksparse" (a band past both
        budgets); "banded_attn" or "gather" for a non-bilinear model;
        fixed until a frame escapes its budget. ``frame``: its tile bounds,
        or a host ``Graph`` in the serving order."""
        if self._resolved is None:
            with span("nmrgnn.resolve"):
                self._resolved = self._choose_mode(frame)
        return self._resolved

    def _choose_mode(self, frame) -> str:
        """``_resolve_mode``'s choice for this frame (setting ``_plan``
        where the choice made one)."""
        if self._n_shards() > 1:
            # split over the ranks of the mesh's partition axis
            return "partitioned"
        if self.config.mp_type != "bilinear":
            self._plan = self._plan_if_attn(frame) if self.config.mp_type == "attention" else None
            return "gather" if self._plan is None else "banded_attn"
        if self.mode != "auto":
            return self.mode
        plan = self._plan_if_fits(frame)
        if plan is not None:
            self._plan = plan
            return "banded"
        plan = self._plan_if_hbm(frame)
        if plan is not None:
            self._plan = plan
            return "banded_hbm"
        return "blocksparse"

    def _banded_plan(self, frame) -> Optional[BandPlan]:
        """The cached plan if it covers this frame, else a new one within
        the budget that chose the path; None when the new one escapes it
        (the caller then re-resolves the path)."""
        tb = self._frame_bounds(frame)
        with span("nmrgnn.plan"):
            if self._plan is None or not plan_covers_bounds(
                    self._plan, tb.at(self._plan.block_rows), tb.n):
                with span("nmrgnn.plan.build"):
                    if self._resolved == "banded_hbm":
                        plan = self._plan_if_hbm(tb)
                    elif self._resolved == "banded_attn":
                        plan = self._plan_if_attn(tb)
                    else:
                        plan = self._plan_if_fits(tb)
                    if plan is None and self.mode == "banded":
                        # the user forced banded: honor it
                        plan = band_plan_from_bounds(tb.at(self.block_size), tb.n,
                                                     self.block_size)
                self._plan = plan
            return self._plan

    def _class_plan(self, frame, cached: Optional[BandClassPlan], off: bool, fits):
        """(plan, switch): the cached class plan if it still covers the
        frame (even after the switch), else None if the switch is on or a
        class escapes ``fits``, else a new plan; a new plan whose shape
        signature differs from the cached one's turns the switch on and
        gives None."""
        tb = self._frame_bounds(frame)
        with span("nmrgnn.plan"):
            if cached is not None and class_plan_covers_bounds(
                    cached, tb.at(cached.block_rows), tb.n):
                return cached, off
            if off:
                return None, off
            with span("nmrgnn.plan.build"):
                cls_plan = band_plan_classes_from_bounds(tb.at(self.block_size), tb.n,
                                                         block_rows=self.block_size)
                cfg, b = self.config, self._dtype_bytes()
                for c in cls_plan.classes:
                    probe = BandPlan(lo=c.lo, window=c.window, block_rows=cls_plan.block_rows,
                                     n_padded=cls_plan.n_padded)
                    if not fits(probe, cfg.atom_feature_size, cfg.edge_feature_size,
                                dtype_bytes=b):
                        return None, off
                if cached is not None and _class_signature(cls_plan) != _class_signature(cached):
                    return None, True
                return cls_plan, off

    def _banded_cls_plan(self, frame) -> Optional[BandClassPlan]:
        """The class plan of the "banded_hbm" fast path (host arrays)."""
        plan, self._cls_hbm_off = self._class_plan(frame, self._cls_plan, self._cls_hbm_off,
                                                   hbm_plan_fits_vmem)
        if plan is not None:
            self._cls_plan = plan
        return plan

    def _banded_cls_plan_vmem(self, frame) -> Optional[BandClassPlan]:
        """The class plan of the "banded" fast path (host arrays)."""
        plan, self._cls_vmem_off = self._class_plan(frame, self._cls_plan_vmem,
                                                    self._cls_vmem_off, plan_fits_vmem)
        if plan is not None:
            self._cls_plan_vmem = plan
        return plan

    def _block_struct(self, g: Graph) -> BlockStructure:
        """The cached block structure remapped to this frame, or a new one
        when a real edge leaves its active pairs."""
        with span("nmrgnn.plan"):
            if self._struct is not None:
                remapped = remap_frame(self._struct, g.nlist, g.edges)
                if remapped is not None:
                    self._struct = remapped
                    return remapped
            with span("nmrgnn.plan.build"):
                self._struct = block_structure(g.nlist, g.edges, self.block_size,
                                               pair_rounding=self.pair_rounding, group=self.group)
            return self._struct

    def _device_plan(self, slot: str, plan):
        """``plan`` (a band plan or a block structure) with its index arrays
        on the device, copied once per plan (each slot keeps its latest) on
        the preparation stream into new tensors, so that a forward still in
        flight keeps reading the last ones."""
        cached = self._on_device.get(slot)
        if cached is None or cached[0] is not plan:
            to_device = struct_on_device if isinstance(plan, BlockStructure) else plan_on_device
            prep = self._prep_stream()
            with span("nmrgnn.h2d"), self._on_prep(prep):
                plan_d = to_device(plan, self.device)
            self._hand_over(prep, _tensors(plan_d))
            cached = self._on_device[slot] = (plan, plan_d)
        return cached[1]

    def _edge_cheb(self) -> EdgeCheb:
        """The degree-64 Chebyshev fit of the edge stage, fitted once on the
        host, with its coefficients copied to the device once."""
        if self._cheb is None:
            cfg = self.config
            cheb = fit_edge_chebyshev(
                self.params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation,
                degree=CHEB_DEGREE,
            )
            self._cheb = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=self.device))
        return self._cheb

    def _to_device(self, g: Graph) -> Graph:
        """A graph prepared on the host, copied to the device."""
        with span("nmrgnn.h2d"):
            return Graph(*[
                torch.from_numpy(np.ascontiguousarray(a)).to(device=self.device, dtype=dt)
                for a, dt in zip(g, _GRAPH_DTYPES)
            ])

    # -- atom-partitioned serving ---------------------------------------------------

    def _n_shards(self) -> int:
        if self.mesh is None:
            return 1
        return int(dict(self.mesh.shape).get(self.partition_axis, 1))

    def _partitioned_fits_vmem(self, plan) -> bool:
        """The JAX package's rule for the partitioned kernel path: the
        shard's node table (its rows and the halo lanes), double-buffered
        interior and halo band tiles and the MP weights under 12 MiB (one
        edge channel for the attention family). Host arithmetic: the path
        rule, not a limit of the Hopper kernels."""
        cfg = self.config
        b = self._dtype_bytes()
        E = 1 if cfg.mp_type == "attention" else cfg.edge_feature_size
        F = cfg.atom_feature_size
        m = plan.halo.rows_per_shard
        table = (m + plan.halo_lanes) * F * b
        tiles = 2 * E * plan.block_rows * (plan.window + plan.halo_window) * b
        w = E * F * F * b
        return table + tiles + w < 12 * 1024 * 1024

    def _predict_partitioned(self, g: Graph) -> torch.Tensor:
        """The structure split over the partition axis' ranks: peaks [N] on
        this rank's device. The plan is cached per topology (padded N and
        the digests of nlist and of the real-edge mask) with this shard's
        plan arrays on the device; the banded kernel path when the shard
        passes ``_partitioned_fits_vmem``, else the halo-gather math."""
        from ..parallel import (apply_partitioned_banded, apply_partitioned_halo,
                                make_banded_halo_plan, make_halo_plan, pad_to_multiple)
        from ..parallel.halo import shard_arrays

        D = self._n_shards()
        n = g.atoms.shape[0]
        gp = pad_to_multiple(g, D * 128)
        with span("nmrgnn.plan"):
            key = (
                gp.atoms.shape[0],
                hashlib.blake2b(np.ascontiguousarray(g.nlist).tobytes(), digest_size=16).digest(),
                hashlib.blake2b((np.asarray(g.edges) > 0).tobytes(), digest_size=16).digest(),
            )
            if self._part_key != key:
                with span("nmrgnn.plan.build"):
                    plan = make_banded_halo_plan(gp.nlist, gp.edges, D)
                    banded = self._partitioned_fits_vmem(plan)
                    if not banded:
                        plan = make_halo_plan(gp.nlist, D, edges=gp.edges)
                    shard = self.mesh.index(self.partition_axis)
                    self._part_plan = (plan, banded, shard_arrays(plan, shard, self.device))
                self._part_key = key
        plan, banded, arrays = self._part_plan
        with span("nmrgnn.forward"), torch.no_grad():
            if banded:
                cheb = (self._edge_cheb() if self.precision == "fast"
                        and self.config.mp_type != "attention" else None)
                peaks = apply_partitioned_banded(self.params, self.config, gp, plan, self.mesh,
                                                 axis=self.partition_axis, cheb=cheb,
                                                 arrays=arrays)
            else:
                peaks = apply_partitioned_halo(self.params, self.config, gp, plan, self.mesh,
                                               axis=self.partition_axis, arrays=arrays)
        return peaks[:n]

    # -- prediction ------------------------------------------------------------

    def _predict_async(self, graph: Graph,
                       positions=None) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
        """Launch the forward; returns (peaks on the device in the served
        order, the inverse permutation or None) without waiting for the
        device."""
        if self._positions and positions is None:
            raise ValueError(f"mp_type={self.config.mp_type!r} needs the atoms' positions: "
                             "predict(graph, positions=f32[N, 3] nm)")
        g = Graph(*[np.asarray(a) for a in graph])
        if self._resolved in _HOST_PATHS:
            return self._predict_host(g)
        gt, bounds, pos = self._prepare(g, positions if self._positions else None)
        while True:
            mode = self._resolve_mode(bounds)
            if mode in _HOST_PATHS:
                return self._predict_host(g)
            if mode == "gather":
                with span("nmrgnn.forward"), torch.no_grad():
                    return gnn.apply(self.params, self.config, gt, positions=pos), self._inverse
            plan = self._banded_plan(bounds)
            if plan is not None:
                break
            # this frame's band escaped the budget that chose the path
            self._resolved = None
        plan_d = self._device_plan("plan", plan)
        if mode == "banded_attn":
            cheb = self._edge_cheb() if self.precision == "fast" else None
            with span("nmrgnn.forward"), torch.no_grad():
                peaks = apply_banded_attention(self.params, self.config, gt, plan_d, cheb=cheb,
                                               pad_rows=self._padding_rows(g))
            return peaks, self._inverse
        hbm = mode == "banded_hbm"
        if self.precision == "exact":
            with span("nmrgnn.forward"):
                peaks = apply_banded(self.params, self.config, gt, plan_d, hbm_table=hbm)
            return peaks, self._inverse
        cheb = self._edge_cheb()
        cls_plan = self._banded_cls_plan(bounds) if hbm else self._banded_cls_plan_vmem(bounds)
        if cls_plan is not None and len(cls_plan.classes) > 1:
            # a skewed window distribution: narrow tiles skip the widest
            # tile's band in the build and MP kernels
            fwd = apply_banded_hbm_classes if hbm else apply_banded_classes
            cls_d = self._device_plan("cls_hbm" if hbm else "cls_vmem", cls_plan)
            with span("nmrgnn.forward"):
                peaks = fwd(self.params, self.config, gt, cls_d, cheb)
        else:
            with span("nmrgnn.forward"):
                peaks = apply_banded(self.params, self.config, gt, plan_d, cheb=cheb,
                                     hbm_table=hbm)
        return peaks, self._inverse

    def _predict_host(self, g: Graph) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
        """"partitioned" and "blocksparse", whose plans read the whole
        permuted arrays: the permutation on the host, then the forward."""
        g = self._permute_host(g)
        if self._resolved == "partitioned":
            return self._predict_partitioned(g), self._inverse
        struct = self._device_plan("struct", self._block_struct(g))
        gt = self._to_device(g)
        with span("nmrgnn.forward"):
            peaks = apply_blocksparse(self.params, self.config, gt, struct, group=self.group)
        return peaks, self._inverse

    @staticmethod
    def _finalize(peaks: torch.Tensor, inverse: Optional[np.ndarray]) -> np.ndarray:
        with span("nmrgnn.readback"):
            out = peaks.cpu().numpy()
            return out if inverse is None else out[..., inverse]

    def predict(self, graph: Graph, positions=None) -> np.ndarray:
        """peaks f32[N] in the graph's own atom order. ``positions``
        (f32[N, 3] nm, in the same order) is read by a model of
        ``gnn.POSITIONS_FAMILIES`` alone, which needs it."""
        with span("nmrgnn.predict"):
            return self._finalize(*self._predict_async(graph, positions))

    def _refuse_positions(self, what: str) -> None:
        if self._positions:
            raise ValueError(f"{what} does not serve mp_type={self.config.mp_type!r}: call "
                             "predict(graph, positions=...) a structure at a time")

    def predict_frames(self, graphs) -> np.ndarray:
        """peaks f32[Fr, N] for Fr frames of one structure (the same atoms
        in the same order), in one forward over a union band plan and one
        readback. The union plan is kept in its own slot, never in place of
        the single-frame plan. Falls back to per-frame ``predict`` when the
        path is not "banded" or "banded_attn", or the union plan escapes its
        budget (for "banded_attn" the node-table budget with one channel and
        no fused-build check). Both precisions take the uniform forward
        here, as in the JAX package. Not for a model of
        ``gnn.POSITIONS_FAMILIES`` (raises)."""
        self._refuse_positions("predict_frames")
        with span("nmrgnn.predict"):
            return self._predict_frames(graphs)

    def _predict_frames(self, graphs) -> np.ndarray:
        gs = [Graph(*[np.asarray(a) for a in g]) for g in graphs]
        if self.reorder:
            with span("nmrgnn.permute"):
                self._fix_order(gs[0])
                gs = [permute_graph(g, self._order, pin_zero=False)[0] for g in gs]
        mode = self._resolve_mode(gs[0])
        if mode not in ("banded", "banded_attn"):
            return np.stack([self.predict(g) for g in graphs])
        attn = mode == "banded_attn"
        stack = Graph(*[np.stack([getattr(g, f) for g in gs]) for f in Graph._fields])
        # every frame lies inside a plan exactly when their union's bounds do
        tb = self._frame_bounds(stack)
        plan = None
        with span("nmrgnn.plan"):
            for cand in (self._frames_plan, self._plan):
                if cand is not None and plan_covers_bounds(cand, tb.at(cand.block_rows), tb.n):
                    plan = cand
                    break
            if plan is None:
                with span("nmrgnn.plan.build"):
                    base = self._plan
                    rows = base.block_rows if base is not None else self.block_size
                    union = band_plan_from_bounds(tb.at(rows), tb.n, rows)
                    cfg, b = self.config, self._dtype_bytes()
                    fits = (plan_fits_vmem(union, cfg.atom_feature_size,
                                           1 if attn else cfg.edge_feature_size, dtype_bytes=b)
                            and (attn or fused_build_ok(union, cfg.edge_hidden_size,
                                                        cfg.edge_feature_size,
                                                        stack.nlist.shape[-1], out_bytes=b)))
                if fits:
                    plan = self._frames_plan = union
        if plan is None:
            # a union window one bucket wider than frame 0's plan may pass
            # the budget that chose the path: serve frame by frame then
            return np.stack([self.predict(g) for g in graphs])
        cheb = self._edge_cheb() if self.precision == "fast" else None
        plan_d, stack_d = self._device_plan("frames", plan), self._to_device(stack)
        with span("nmrgnn.forward"), torch.no_grad():
            if attn:
                peaks = apply_banded_attention_frames(
                    self.params, self.config, stack_d, plan_d, cheb=cheb,
                    pad_rows=[padding_rows(g.nlist, g.edges) for g in gs])
            else:
                peaks = apply_banded_frames(self.params, self.config, stack_d, plan_d,
                                            cheb=cheb)
        return self._finalize(peaks, self._inverse if self.reorder else None)

    def predict_trajectory(
        self, struct, stride: int = 1, neighbor_number: int = 16,
        prefetch: int = 4, build_workers: int = 4,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (frame_index, peaks f32[N]) over a parsed Structure.

        ``build_workers`` threads build the upcoming frames' graphs on the
        host (``data.parse.structure2graph``) while the device runs the
        current forward, at most ``build_workers + prefetch`` ahead; frame
        i's readback happens after frame i + 1 has been launched; results
        come out in frame order. A failed build raises in the consumer
        (``RuntimeError``); the trajectory is never cut short silently. Not
        for a model of ``gnn.POSITIONS_FAMILIES`` (raises)."""
        from ..data.parse import structure2graph

        self._refuse_positions("predict_trajectory")
        frames = list(range(0, struct.n_frames, stride))
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))

        def build(i):
            with span("nmrgnn.build"):
                return i, structure2graph(struct, neighbor_number, frame=i)

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=build_workers) as pool:
                    futs = collections.deque()
                    it = iter(frames)
                    for i in it:
                        futs.append(pool.submit(build, i))
                        if len(futs) >= build_workers + prefetch:
                            break
                    while futs:
                        q.put(futs.popleft().result())
                        i = next(it, None)
                        if i is not None:
                            futs.append(pool.submit(build, i))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 - handed to the consumer
                q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        pending = None  # (frame, peaks on the device, inverse)
        while True:
            with span("nmrgnn.queue_wait"):
                item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise RuntimeError("trajectory graph build failed mid-stream") from item
            i, g = item
            with span("nmrgnn.predict"):
                peaks, inverse = self._predict_async(g)
            if pending is not None:
                yield pending[0], self._finalize(pending[1], pending[2])
            pending = (i, peaks, inverse)
        if pending is not None:
            yield pending[0], self._finalize(pending[1], pending[2])
