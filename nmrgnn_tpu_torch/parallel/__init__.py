"""Multi-GPU serving and training (``nmrgnn_tpu/parallel/``): one structure
split by atom rows over processes under ``torch.distributed`` (``halo``,
``partition``), its training through the differentiable halo exchange, and
data- and tensor-parallel training steps (``sharding``)."""
from .comm import banded_layer_flops, halo_comm_report, project_scaling
from .halo import (
    BandedHaloPlan,
    HaloPlan,
    PlanShapeMismatch,
    all_gather_rows,
    apply_partitioned_banded,
    apply_partitioned_banded_batch,
    apply_partitioned_halo,
    make_banded_halo_plan,
    make_halo_plan,
    make_partitioned_epoch_fn,
    make_partitioned_eval_fn,
    make_partitioned_train_step,
    psum,
    psum_grads,
    ring_exchange,
)
from .mesh import Mesh, best_factorization, initialize_distributed, make_mesh
from .partition import apply_partitioned, jit_partitioned_forward, pad_to_multiple
from .sharding import (
    batch_spec,
    make_parallel_train_step,
    param_specs,
    shard_batch,
    shard_params,
    unshard_params,
)

__all__ = [
    "apply_partitioned_banded",
    "apply_partitioned_banded_batch",
    "apply_partitioned_halo",
    "make_partitioned_epoch_fn",
    "make_partitioned_eval_fn",
    "make_banded_halo_plan",
    "make_halo_plan",
    "make_partitioned_train_step",
    "best_factorization",
    "initialize_distributed",
    "make_mesh",
    "apply_partitioned",
    "jit_partitioned_forward",
    "pad_to_multiple",
    "batch_spec",
    "make_parallel_train_step",
    "param_specs",
    "shard_batch",
    "shard_params",
    "unshard_params",
    "BandedHaloPlan",
    "HaloPlan",
    "PlanShapeMismatch",
    "ring_exchange",
    "psum",
    "psum_grads",
    "all_gather_rows",
    "halo_comm_report",
    "banded_layer_flops",
    "project_scaling",
    "Mesh",
]
