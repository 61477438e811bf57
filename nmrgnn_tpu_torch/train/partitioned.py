"""Whole-structure (graph-partitioned) training (``nmrgnn_tpu/train/
partitioned.py``): train on the intact structure, its atoms split over the
ranks of the mesh's ``graph`` axis, through B7a and B6 under autograd and
the differentiable halo exchange (``parallel/halo.make_partitioned_train_step``).

Workflow (one process a shard, started by ``torchrun``)::

    python -m nmrgnn_tpu_torch.cli make-struct-records traj.pdb records.tfr
    torchrun --nproc-per-node 4 -m nmrgnn_tpu_torch.cli train records.tfr model 50 \
        --graph-parallel 4

Per record (one structure frame) the trainer RCM-orders the atoms (narrow
interior bands, boundary halos at the shard seams), pads to a multiple of
shards * block_rows and builds a ``BandedHaloPlan``; same-size frames are
planned inside one shape envelope (``like=``), so that they share one frame
table and one epoch function. Checkpoints, the plateau / cosine learning
rates, metric moments and history match the fragment ``Trainer``'s, so
``--load``, the TensorBoard callbacks and the saved model are the same.

Every rank of the mesh makes the same calls in the same order (the same
seeds, shuffles and frame groups); rank 0 writes the checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import ModelConfig, TrainConfig
from ..data.dataset import Sample
from ..data.embeddings import load_embeddings, load_standards
from ..data.reorder import permute_graph, rcm_order
from ..graph import Graph
from ..models import gnn
from ..models.infer import padding_rows
from ..parallel.halo import (
    BandedHaloPlan,
    HaloPlan,
    PlanShapeMismatch,
    apply_partitioned_banded,
    make_banded_halo_plan,
    make_partitioned_epoch_fn,
    make_partitioned_eval_fn,
    make_partitioned_train_step,
    shard_arrays,
)
from .losses import name_loss
from .metrics import type_mask
from .trainer import (
    _MOMENT_NAMES,
    TrainState,
    _detached_copy,
    _moments,
    adam,
    finalize_metric,
    fit_epochs,
    fold_sample_weight,
    load_train_checkpoint,
    metric_kinds,
    save_train_checkpoint,
)


@dataclasses.dataclass
class PreparedStructure:
    """One whole-structure record, RCM-ordered, padded and planned, on the
    device."""

    graph: Graph          # tensors, n_padded atoms
    y: torch.Tensor       # f32[n_padded, 3]
    w: torch.Tensor       # f32[n_padded]
    plan: BandedHaloPlan
    arrays: Tuple         # this shard's plan arrays (parallel.halo.shard_arrays)
    inverse: np.ndarray   # peaks_original = peaks_permuted[inverse]
    n_real: int
    pad_rows: Optional[np.ndarray] = None  # attention: the rows padding slots name

    @property
    def shape_key(self) -> tuple:
        p = self.plan
        return (
            self.graph.atoms.shape[0], p.window, p.block_rows,
            p.halo.offsets, p.halo.halo_sizes, p.halo_window,
            p.num_boundary_tiles, p.num_tiles,
        )


class PartitionedTrainer:
    """Trainer over whole-structure records on a (data, graph) mesh.

    ``mesh`` (``parallel.make_mesh``) carries the ``axis`` ('graph') the
    atoms split over. One structure a step (with a data axis of S > 1, S
    structures a step, one a data index), with the reference's noise and
    dropout drawn shard-locally. ``use_kernels`` False runs the kernels'
    plain versions (the CPU runs them anyway)."""

    def __init__(
        self,
        config: Optional[ModelConfig] = None,
        train_config: Optional[TrainConfig] = None,
        mesh=None,
        embeddings: Optional[dict] = None,
        axis: str = "graph",
        use_kernels: bool = True,
        block_rows: int = 128,
        prepare_cache_size: int = 64,
        device=None,
    ):
        """``device``: where this rank's shard runs (default the mesh's card;
        without a card it raises unless ``device="cpu"`` is passed, as every
        entry point of the port). ``prepare_cache_size`` bounds the cache of prepared structures:
        each entry holds the padded frame's graph, labels and plan arrays on
        the device, so runs over many distinct frames should lower it toward
        the frames they revisit (entries leave first in, first out)."""
        if mesh is None:
            raise ValueError("PartitionedTrainer requires a mesh")
        self.config = config or ModelConfig()
        if self.config.mp_type in gnn.POSITIONS_FAMILIES:
            raise ValueError(f"PartitionedTrainer does not train "
                             f"mp_type={self.config.mp_type!r}: the family serves inference only")
        self.tcfg = train_config or TrainConfig()
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self.block_rows = block_rows
        self.device = resolve_device(device if device is not None else
                                     mesh.device if mesh.device.type == "cuda" else "cuda")
        self.embeddings = embeddings or load_embeddings()
        self.loss_idx = torch.as_tensor(type_mask(r".*", self.embeddings, regex=True),
                                        dtype=torch.int64, device=self.device)
        self.metric_specs = metric_kinds()
        self.use_kernels = use_kernels
        self.prepare_cache_size = prepare_cache_size
        self._steps: Dict[tuple, object] = {}
        self._epochs: Dict[tuple, object] = {}
        self._eval_fns: Dict[tuple, object] = {}
        # id -> (sample, prepared); holding the sample keeps its id unique
        self._prepared: Dict[int, Tuple[Sample, PreparedStructure]] = {}
        # same-shape frame tables for the epoch and eval functions
        self._tables: Dict[tuple, tuple] = {}
        # per atom count, the plan SHAPE envelope same-size frames are
        # planned in, so that a trajectory lands in one group
        self._plan_like: Dict[int, BandedHaloPlan] = {}
        # structures a step on the mesh's data axis (1 = no batching)
        self.data_shards = int(mesh.shape["data"])

    # -- structure preparation --------------------------------------------
    def prepare(self, sample: Sample) -> PreparedStructure:
        """RCM-order, pad to shards * block_rows, permute the labels with
        the atoms, build the banded halo plan. Cached per Sample object
        (the cache holds the sample, so its id cannot be reused) and bounded,
        so that long trajectories do not hold every frame on the device."""
        key = id(sample)
        hit = self._prepared.get(key)
        if hit is not None:
            return hit[1]
        g = sample.graph
        order = rcm_order(np.asarray(g.nlist), np.asarray(g.edges))
        # pin_zero=False: the banded kernels mask by edge distance, and
        # pinning stretches one tile's window across the whole structure
        gp, inverse = permute_graph(g, order, pin_zero=False)
        y = np.asarray(sample.y)[order]
        w = np.asarray(sample.w)[order]
        n = gp.atoms.shape[0]
        pad = (-n) % (self.n_shards * self.block_rows)
        gp = Graph(
            atoms=np.pad(np.asarray(gp.atoms), ((0, pad), (0, 0))),
            nlist=np.pad(np.asarray(gp.nlist), ((0, pad), (0, 0))),
            edges=np.pad(np.asarray(gp.edges), ((0, pad), (0, 0))),
            inv_degree=np.pad(np.asarray(gp.inv_degree), ((0, pad),)),
        )
        y = np.pad(y, ((0, pad), (0, 0)))
        w = np.pad(w, ((0, pad),))
        n_pad = gp.atoms.shape[0]
        like = self._plan_like.get(n_pad)
        plan = None
        if like is not None:
            try:
                plan = make_banded_halo_plan(gp.nlist, gp.edges, self.n_shards,
                                             block_rows=self.block_rows, like=like)
            except PlanShapeMismatch:
                plan = None  # this frame escapes the envelope
        if plan is None:
            plan = make_banded_halo_plan(gp.nlist, gp.edges, self.n_shards,
                                         block_rows=self.block_rows)
            if like is not None:
                # extend the stored envelope (an outlier must not evict the
                # union that keeps the rest of the trajectory in one group)
                # and rebuild this frame inside it
                env = self._union_envelope([like, plan])
                self._plan_like[n_pad] = env
                plan = make_banded_halo_plan(gp.nlist, gp.edges, self.n_shards,
                                             block_rows=self.block_rows, like=env)
            else:
                self._plan_like[n_pad] = plan
        dev = self.device
        dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
        prep = PreparedStructure(
            graph=Graph(*[torch.as_tensor(a).to(dev, dt) for a, dt in zip(gp, dtypes)]),
            y=torch.as_tensor(y, dtype=torch.float32).to(dev),
            w=torch.as_tensor(w, dtype=torch.float32).to(dev),
            plan=plan,
            arrays=shard_arrays(plan, self.mesh.index(self.axis), dev),
            inverse=inverse,
            n_real=n,
            pad_rows=(padding_rows(gp.nlist, gp.edges)
                      if self.config.mp_type == "attention" else None),
        )
        while len(self._prepared) >= max(self.prepare_cache_size, 1):
            self._prepared.pop(next(iter(self._prepared)))
        self._prepared[key] = (sample, prep)
        return prep

    # -- steps -------------------------------------------------------------
    def _train_step(self, prep: PreparedStructure, batched: bool = False):
        key = (prep.shape_key, batched)
        step = self._steps.get(key)
        if step is None:
            step = make_partitioned_train_step(
                self.config, self.loss_idx, prep.plan, self.mesh, axis=self.axis,
                loss_balance=self.tcfg.loss_balance, training=True,
                data_axis="data" if batched else None, use_kernels=self.use_kernels)
            self._steps[key] = step
        return step

    def _eval_step(self, prep: PreparedStructure):
        """``eval_step(params, graph, y, w, arrays, pad_rows=None) -> (loss,
        moments [specs, 7])`` of one structure of ``prep``'s shapes, as
        device tensors: the per-frame evaluation that the eval function's
        table walk equals."""
        plan, idxs = prep.plan, [torch.as_tensor(idx, dtype=torch.int64, device=self.device)
                                 for _, _, idx in self.metric_specs]

        def eval_step(params, graph, y, w, arrays, pad_rows=None):
            with torch.no_grad():
                peaks = apply_partitioned_banded(
                    params, self.config, graph, plan, self.mesh, axis=self.axis,
                    use_kernels=self.use_kernels, arrays=arrays, pad_rows=pad_rows)
                yt = fold_sample_weight(y, w)
                loss = name_loss(yt, peaks, self.loss_idx, s=self.tcfg.loss_balance)
                return loss, torch.stack([_moments(yt, peaks, idx) for idx in idxs])

        return eval_step

    @staticmethod
    def _union_envelope(plans: Sequence[BandedHaloPlan]) -> BandedHaloPlan:
        """A plan carrying the elementwise-max SHAPE envelope of ``plans``
        (offset union, per-offset capacity max, window / halo window /
        boundary-tile max); only its shape fields are read, as the ``like=``
        of make_banded_halo_plan."""
        caps: Dict[int, int] = {}
        for p in plans:
            for o, h in zip(p.halo.offsets, p.halo.halo_sizes):
                caps[o] = max(caps.get(o, 0), h)
        offsets = tuple(sorted(caps))
        d = plans[0].halo.n_shards
        m = plans[0].halo.rows_per_shard
        tb = max(p.num_boundary_tiles for p in plans)
        return BandedHaloPlan(
            halo=HaloPlan(
                offsets=offsets,
                send_idx=tuple(np.zeros((d, caps[o]), np.int32) for o in offsets),
                local_nlist=np.zeros((d, 0, 0), np.int32),
                halo_sizes=tuple(caps[o] for o in offsets),
                n_shards=d,
                rows_per_shard=m,
            ),
            lo=np.zeros((d, m // plans[0].block_rows), np.int32),
            window=max(p.window for p in plans),
            block_rows=plans[0].block_rows,
            boundary_ids=np.zeros((d, tb), np.int32),
            halo_lo=np.zeros((d, tb), np.int32),
            halo_window=max(p.halo_window for p in plans),
        )

    def _group(self, samples: Sequence[Sample]):
        """Prepare every sample and group the preps by plan shape_key:
        frames of a group share one frame table and epoch function.

        Two passes: when same-size frames fall into several plan shapes,
        the union SHAPE envelope is stored and those frames are prepared
        again inside it, into one group (narrow frames then run at the
        envelope's window)."""
        groups: Dict[tuple, List[PreparedStructure]] = {}
        sample_of: Dict[int, Sample] = {}
        for s in samples:
            prep = self.prepare(s)
            groups.setdefault(prep.shape_key, []).append(prep)
            sample_of[id(prep)] = s
        by_n: Dict[int, list] = {}
        for key, preps in groups.items():
            by_n.setdefault(preps[0].graph.atoms.shape[0], []).append(key)
        for n, keys in by_n.items():
            if len(keys) < 2:
                continue
            frag = [p for k in keys for p in groups[k]]
            self._plan_like[n] = self._union_envelope([p.plan for p in frag])
            for k in keys:
                del groups[k]
            for p in frag:
                s = sample_of[id(p)]
                self._prepared.pop(id(s), None)  # force re-prepare
                prep = self.prepare(s)
                groups.setdefault(prep.shape_key, []).append(prep)
        return groups

    def _stage_tables(self, preps: Sequence[PreparedStructure]):
        """Stack a same-shape group's device tensors into frame tables
        [F, ...]: (graphs, ys, ws, arrays, pad_rows), ``arrays`` the frames'
        own plan arrays (a list; the kernels take each as it was staged).
        The cache entry holds the preps, so their ids cannot be reused."""
        key = (preps[0].shape_key, tuple(id(p) for p in preps))
        hit = self._tables.get(key)
        if hit is not None:
            return hit[1]
        graphs = Graph(*[torch.stack([getattr(p.graph, f) for p in preps])
                         for f in Graph._fields])
        ys = torch.stack([p.y for p in preps])
        ws = torch.stack([p.w for p in preps])
        arrays = [p.arrays for p in preps]
        pad_rows = None if preps[0].pad_rows is None else [p.pad_rows for p in preps]
        tables = (graphs, ys, ws, arrays, pad_rows)
        while len(self._tables) >= 8:  # a handful of table sets at most
            self._tables.pop(next(iter(self._tables)))
        self._tables[key] = (tuple(preps), tables)
        return tables

    def _epoch_fn(self, prep: PreparedStructure, batched: bool):
        key = (prep.shape_key, batched, self.tcfg.ema_decay > 0)
        fn = self._epochs.get(key)
        if fn is None:
            fn = make_partitioned_epoch_fn(
                self.config, self.loss_idx, prep.plan, self.mesh, axis=self.axis,
                loss_balance=self.tcfg.loss_balance, training=True,
                data_axis="data" if batched else None, ema_decay=self.tcfg.ema_decay,
                use_kernels=self.use_kernels)
            self._epochs[key] = fn
        return fn

    def _eval_scan_fn(self, prep: PreparedStructure):
        key = prep.shape_key
        fn = self._eval_fns.get(key)
        if fn is None:
            fn = make_partitioned_eval_fn(
                self.config, self.loss_idx, self.metric_specs, prep.plan, self.mesh,
                axis=self.axis, loss_balance=self.tcfg.loss_balance,
                use_kernels=self.use_kernels)
            self._eval_fns[key] = fn
        return fn

    # -- inference ---------------------------------------------------------
    def predict(self, params, sample: Sample) -> np.ndarray:
        """Peaks f32[N] in the record's original atom order."""
        prep = self.prepare(sample)
        peaks = apply_partitioned_banded(
            params, self.config, prep.graph, prep.plan, self.mesh, axis=self.axis,
            use_kernels=self.use_kernels, arrays=prep.arrays, pad_rows=prep.pad_rows)
        return peaks.cpu().numpy()[:prep.n_real][prep.inverse]

    # -- state and checkpoints ---------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        gen = generator or torch.Generator().manual_seed(self.tcfg.seed)
        params = gnn.init_params(self.config, gen, load_standards(), device=self.device)
        return TrainState(params=params, opt_state={}, lr=self.config.learning_rate)

    def optimizer(self, state: TrainState) -> torch.optim.Adam:
        return adam(state)

    def save_checkpoint(self, path: str, state: TrainState) -> None:
        """Rank 0 writes; the others hold the same state."""
        if self.mesh.rank == 0:
            save_train_checkpoint(path, state, self.config)

    def load_checkpoint(self, path: str) -> TrainState:
        return load_train_checkpoint(path, self.init_state(), self.device)

    # -- loops -------------------------------------------------------------
    def evaluate(self, samples: Sequence[Sample], params) -> Dict[str, float]:
        """Loss and metrics: the frames grouped by plan shape, each group's
        table through the eval function, one readback at the end."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        acc = torch.zeros((len(self.metric_specs), len(_MOMENT_NAMES)), dtype=torch.float64,
                          device=self.device)
        nb = 0
        for preps in self._group(samples).values():
            graphs, ys, ws, arrays, pad_rows = self._stage_tables(preps)
            losses, moments = self._eval_scan_fn(preps[0])(params, graphs, ys, ws, arrays,
                                                           pad_rows)
            total += losses.sum()
            acc += moments.sum(0)
            nb += len(preps)
        out = {"loss": float(total) / max(nb, 1)}
        for (name, kind, _), m in zip(self.metric_specs, acc.cpu().numpy()):
            out[name] = finalize_metric(kind, m)
        return out

    def _train_epoch(self, state: TrainState, opt, samples, shuffle_rng, rng) -> Tuple[float, int]:
        """(sum of the structures' losses, structures) of one epoch: per
        frame group one epoch function call (S frames a step on the data
        axis, the rest one a step), the losses read back once."""
        totals, nb = [], 0
        for preps in self._group(samples).values():
            F = len(preps)
            graphs, ys, ws, arrays, pad_rows = self._stage_tables(preps)
            perm = shuffle_rng.permutation(F)
            rngs = rng.integers(0, 2 ** 62, F)
            S = self.data_shards
            fb = (F // S) * S if S > 1 else F
            chunks = []
            if S > 1 and fb:
                chunks.append((True, perm[:fb], S))
            if fb < F or S == 1:
                chunks.append((False, perm[fb:] if S > 1 else perm, 1))
            for batched, order, width in chunks:
                if order.size == 0:
                    continue
                fn = self._epoch_fn(preps[0], batched=batched)
                losses = fn(state.params, opt, state.ema_params, graphs, ys, ws, rngs, arrays,
                            order, pad_rows)
                # batched losses are means over `width` structures
                totals.append(losses.sum() * width)
                nb += int(order.size)
        return float(torch.stack(totals).sum()) if totals else 0.0, nb

    def fit(
        self,
        train_samples: Sequence[Sample],
        val_samples: Sequence[Sample],
        epochs: Optional[int] = None,
        state: Optional[TrainState] = None,
        checkpoint_path: Optional[str] = None,
        verbose: bool = True,
        callbacks: Sequence = (),
        early_stop_patience: Optional[int] = None,
    ) -> TrainState:
        """Train for ``epochs`` (default ``TrainConfig.epochs``) from
        ``state`` (default ``init_state()``), whose params are updated in
        place: the fragment ``Trainer.fit``'s schedules, NaN recovery (the
        last finite epoch restored, lr halved, 3 retries), EMA,
        best-restore, early stop, history and callbacks. The frames' order
        is a numpy shuffle seeded with ``seed``; the training draws' keys
        come from a numpy generator seeded with ``seed + 1``."""
        epochs = epochs or self.tcfg.epochs
        state = state or self.init_state()
        rng = np.random.default_rng(self.tcfg.seed + 1)
        shuffle_rng = np.random.default_rng(self.tcfg.seed)
        if self.tcfg.ema_decay > 0 and state.ema_params is None:
            state.ema_params = _detached_copy(state.params)
        opt = self.optimizer(state)
        return fit_epochs(
            self, state, opt, epochs,
            lambda: self._train_epoch(state, opt, train_samples, shuffle_rng, rng),
            val_samples, checkpoint_path, verbose and self.mesh.rank == 0, callbacks,
            early_stop_patience)
