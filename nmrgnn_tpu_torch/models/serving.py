"""Single-structure serving (``nmrgnn_tpu/models/serving.py:59-365,
487-499, 706-775``), banded mode, one device.

The first call fixes the RCM atom ordering (``reorder=False`` serves the
graph as given); each later frame verifies the cached band plan against
its own neighbor lists (``plan_covers``) and rebuilds it only when a real
neighbor escapes its window. ``predict`` returns peaks in the original
atom order.

``precision="exact"`` serves in float32 through the fused RBF + EdgeFC
band build. ``precision="fast"``, the JAX package's production serving
configuration, computes the products in bfloat16 with float32 sums and
replaces the edge stage by its degree-64 Chebyshev fit, fitted once per
model. On a skewed window distribution (a class plan of more than one
class) it serves through the class-bucketed forward
(``apply_banded_classes``), else through ``apply_banded(cheb=...)``. A
class plan is verified and reused across frames like the uniform plan;
when frame motion re-buckets the classes (another shape signature), new
class plans are switched off for good (``_cls_vmem_off``) and the frames
that the cached class plan does not cover take the uniform forward, as in
the JAX package. "fast" serves on the CPU too, through the plain
versions of the kernels.

The JAX package's VMEM gates (``plan_fits_vmem``, ``fused_build_ok``)
do not apply here: the Hopper kernels stage windows through shared memory
in fixed-size chunks, so any plan runs. Modes other than banded, the HBM
node table, trajectories and meshes are later slices of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..data.reorder import permute_graph, rcm_order
from ..graph import Graph
from ..ops.banded import (
    BandClassPlan,
    BandPlan,
    band_plan,
    band_plan_classes,
    class_plan_covers,
    plan_covers,
    plan_on_device,
)
from ..ops.edgefn import EdgeCheb, fit_edge_chebyshev
from .gnn import tree_map
from .infer import apply_banded, apply_banded_classes

CHEB_DEGREE = 64  # the Chebyshev fit the JAX package serves with


def _class_signature(plan: BandClassPlan):
    return (plan.n_padded, plan.block_rows,
            tuple((len(c.ids), c.window) for c in plan.classes))


class ServingModel:
    def __init__(
        self,
        params,
        config: ModelConfig,
        device="cuda",
        reorder: bool = True,
        mode: str = "auto",
        precision: str = "exact",
    ):
        """``params`` is a tree of numpy arrays or tensors (``load_model``
        or ``init_params``); it is copied to ``device`` once. ``mode``
        "auto" and "banded" both serve through the banded kernels.
        ``precision`` is "exact" (float32) or "fast" (bfloat16 products
        with float32 sums, and the Chebyshev edge stage)."""
        if precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision {precision!r}")
        if mode not in ("auto", "banded"):
            raise NotImplementedError(
                f"serving mode {mode!r}: HBM, block-sparse and gather modes are "
                "ROADMAP queue A6-A7 / B5-B12"
            )
        if config.mp_type != "bilinear":
            raise NotImplementedError("attention-family serving is ROADMAP queue A6")
        if precision == "fast" and config.compute_dtype == "float32":
            config = config.replace(compute_dtype="bfloat16")
        if precision == "exact" and config.compute_dtype != "float32":
            raise NotImplementedError(
                "exact serving in bfloat16 needs the fused edge stage in bfloat16 "
                "(ROADMAP queue B3)"
            )
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the plain matmuls (embedding, FC block, head) stay float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.precision = precision
        self.reorder = reorder
        self.params = tree_map(
            lambda t: torch.as_tensor(t).to(device=self.device, dtype=torch.float32), params
        )
        self._order: Optional[np.ndarray] = None
        self._inverse: Optional[np.ndarray] = None
        self._plan: Optional[BandPlan] = None
        self._plan_dev: Optional[BandPlan] = None
        self._cheb: Optional[EdgeCheb] = None
        self._cls_plan_vmem: Optional[BandClassPlan] = None  # host copy
        self._cls_plan_dev: Optional[BandClassPlan] = None
        self._cls_vmem_off = False  # set when frame motion re-buckets the classes

    def _prepare(self, g: Graph) -> Graph:
        """Apply (and on the first call fix) the RCM ordering."""
        if not self.reorder:
            self._inverse = None
            return g
        if self._order is None or self._order.shape[0] != g.atoms.shape[0]:
            self._order = rcm_order(g.nlist, g.edges)
        g, self._inverse = permute_graph(g, self._order, pin_zero=False)
        return g

    def _banded_plan(self, g: Graph) -> BandPlan:
        """The cached plan if it covers this frame, else a new one."""
        if self._plan is None or not plan_covers(self._plan, g.nlist, g.edges):
            self._plan = band_plan(g.nlist, g.edges)
            self._plan_dev = plan_on_device(self._plan, self.device)
        return self._plan_dev

    def _banded_cls_plan_vmem(self, g: Graph) -> Optional[BandClassPlan]:
        """The class plan for this frame (host arrays), or None when new
        class plans are switched off: the cached plan if it still covers
        the frame (even after the switch), else a new one, unless the new
        one's shape signature differs from the cached one's, which turns
        the switch on."""
        if self._cls_plan_vmem is not None and class_plan_covers(
            self._cls_plan_vmem, g.nlist, g.edges
        ):
            return self._cls_plan_vmem
        if self._cls_vmem_off:
            return None
        cls_plan = band_plan_classes(g.nlist, g.edges)
        if self._cls_plan_vmem is not None and (
            _class_signature(cls_plan) != _class_signature(self._cls_plan_vmem)
        ):
            self._cls_vmem_off = True
            return None
        self._cls_plan_vmem = cls_plan
        self._cls_plan_dev = plan_on_device(cls_plan, self.device)
        return cls_plan

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
        dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
        return Graph(*[
            torch.from_numpy(np.ascontiguousarray(a)).to(device=self.device, dtype=dt)
            for a, dt in zip(g, dtypes)
        ])

    def _predict_async(self, graph: Graph) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
        """Launch the forward; returns (peaks on the device in the served
        order, the inverse permutation or None) without waiting for the
        device."""
        g = self._prepare(Graph(*[np.asarray(a) for a in graph]))
        plan = self._banded_plan(g)
        gt = self._to_device(g)
        if self.precision == "exact":
            return apply_banded(self.params, self.config, gt, plan), self._inverse
        cheb = self._edge_cheb()
        cls_plan = self._banded_cls_plan_vmem(g)
        if cls_plan is not None and len(cls_plan.classes) > 1:
            # a skewed window distribution: narrow tiles skip the widest
            # tile's band in the build and MP kernels
            peaks = apply_banded_classes(self.params, self.config, gt, self._cls_plan_dev, cheb)
        else:
            peaks = apply_banded(self.params, self.config, gt, plan, cheb=cheb)
        return peaks, self._inverse

    def predict(self, graph: Graph) -> np.ndarray:
        """peaks f32[N] in the graph's own atom order."""
        peaks, inverse = self._predict_async(graph)
        peaks = peaks.cpu().numpy()
        return peaks if inverse is None else peaks[inverse]
