"""Multi-GPU serving: one structure split by atom rows over processes under
``torch.distributed`` (``nmrgnn_tpu/parallel/``, its serving half). The
training half (``make_partitioned_train_step``, ``make_partitioned_epoch_fn``,
``make_partitioned_eval_fn``, ``apply_partitioned_banded_batch`` and
``sharding``) is the next slice of the port."""
from .comm import banded_layer_flops, halo_comm_report, project_scaling
from .halo import (
    BandedHaloPlan,
    HaloPlan,
    PlanShapeMismatch,
    apply_partitioned_banded,
    apply_partitioned_halo,
    make_banded_halo_plan,
    make_halo_plan,
    psum,
    ring_exchange,
)
from .mesh import Mesh, best_factorization, initialize_distributed, make_mesh
from .partition import apply_partitioned, jit_partitioned_forward, pad_to_multiple

__all__ = [
    "apply_partitioned_banded",
    "apply_partitioned_halo",
    "make_banded_halo_plan",
    "make_halo_plan",
    "BandedHaloPlan",
    "HaloPlan",
    "PlanShapeMismatch",
    "ring_exchange",
    "psum",
    "halo_comm_report",
    "banded_layer_flops",
    "project_scaling",
    "Mesh",
    "best_factorization",
    "initialize_distributed",
    "make_mesh",
    "apply_partitioned",
    "jit_partitioned_forward",
    "pad_to_multiple",
]
