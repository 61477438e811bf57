"""Communication volumes and a roofline projection for the partitioned
forward (``nmrgnn_tpu/parallel/comm.py``).

Exact per-layer byte counts for each exchange strategy, computed from the
halo plans, and a projection against an H100's published rates. Per MP
layer and shard, D shards, F features, dtype b bytes:

  all-gather form   receives (D-1)/D * N * F * b      (parallel/partition.py)
  halo form         receives sum_o H_o * F * b        (parallel/halo.py: one
                    send/receive pair per kept offset o, H_o the largest
                    pair halo at that offset padded to the halo multiple;
                    with RCM order the offsets are {+1, -1}, so about
                    2 * H * F, independent of D; the distinct boundary rows
                    are reported too)

Overlap: apply_partitioned_banded posts the exchange before the interior
band's MP kernel, so the exchange hides under it whenever t_comm <=
t_interior; the projection accounts for that.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .halo import BandedHaloPlan, HaloPlan

# One H100 SXM's published rates (NVIDIA's datasheet; PERF.md's bounds):
# 989 TFLOP/s dense bfloat16 on the tensor cores, 67 TFLOP/s float32 on
# the CUDA cores, and NVLink 4 at 450 GB/s each way. Parameters of the
# projection, which is a model, not a measurement.
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
NVLINK4_BYTES_PER_S = 450e9


@dataclasses.dataclass
class CommReport:
    n_atoms: int
    n_shards: int
    n_features: int
    halo_rows_padded: int       # sum_o H_o (what the ring buffers carry)
    halo_rows_unique: int       # actual distinct boundary rows needed
    halo_bytes: int             # per layer per shard, padded buffers
    allgather_bytes: int        # per layer per shard
    ratio: float                # halo / all-gather

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def halo_comm_report(
    plan: HaloPlan, n_features: int = 256, dtype_bytes: int = 4
) -> CommReport:
    """Exact exchange volumes for a built halo plan."""
    D, m = plan.n_shards, plan.rows_per_shard
    n = D * m
    # distinct boundary rows actually referenced: workspace halo slots
    # (>= m) used by any neighbor list, per requesting shard
    uniq = int(
        sum(
            np.unique(plan.local_nlist[s][plan.local_nlist[s] >= m]).size
            for s in range(D)
        )
    )
    halo_bytes = plan.halo_rows * n_features * dtype_bytes
    allgather_bytes = (D - 1) * m * n_features * dtype_bytes
    return CommReport(
        n_atoms=n,
        n_shards=D,
        n_features=n_features,
        halo_rows_padded=plan.halo_rows,
        halo_rows_unique=uniq,
        halo_bytes=halo_bytes,
        allgather_bytes=allgather_bytes,
        ratio=halo_bytes / max(allgather_bytes, 1),
    )


def banded_layer_flops(
    plan: BandedHaloPlan, n_features: int, n_edge_channels: int = 3
) -> Dict[str, float]:
    """Per-shard FLOPs of one banded MP layer: interior band over all T
    tiles + compacted halo band over the Tb boundary tiles (window Wh
    into the received rows). ``n_edge_channels`` must match the model
    family: config.edge_feature_size for the bilinear MPLayer, 1 for the
    attention family's one-channel bands."""
    T, B, W = plan.num_tiles, plan.block_rows, plan.window
    Tb, Wh = plan.num_boundary_tiles, plan.halo_window
    E = n_edge_channels
    interior = 2.0 * T * E * B * W * n_features + 2.0 * T * E * B * n_features**2
    halo = 2.0 * Tb * E * B * Wh * n_features + 2.0 * Tb * E * B * n_features**2
    return {"interior": interior, "halo": halo}


def project_scaling(
    plan: BandedHaloPlan,
    n_features: int = 256,
    dtype_bytes: int = 4,
    flops_per_s: float = H100_F32_FLOPS,
    link_bytes_per_s: float = NVLINK4_BYTES_PER_S,
    mp_layers: int = 4,
    overlap: bool = True,
    n_edge_channels: int = 3,
) -> Dict[str, float]:
    """Roofline projection of one partitioned forward's MP stack on H100s
    (the datasheet rates above by default: a model, not a measurement).

    Returns projected per-layer times and the scaling efficiency
    vs. a single chip running the same total work:
      eff = t_single / (D * t_shard)
    With ``overlap`` the exchange hides under the interior kernel
    (apply_partitioned_banded's post-then-compute order)."""
    rep = halo_comm_report(plan.halo, n_features, dtype_bytes)
    fl = banded_layer_flops(plan, n_features, n_edge_channels)
    t_int = fl["interior"] / flops_per_s
    t_halo = fl["halo"] / flops_per_s
    t_comm = rep.halo_bytes / link_bytes_per_s
    if overlap:
        t_layer = max(t_int, t_comm) + t_halo
    else:
        t_layer = t_int + t_comm + t_halo
    # single chip: same interior math over all shards' tiles, no halo
    # block, no comm (band windows identical by construction)
    t_single_layer = plan.halo.n_shards * t_int
    eff = t_single_layer / (plan.halo.n_shards * t_layer)
    return {
        "t_interior_us": t_int * 1e6,
        "t_halo_block_us": t_halo * 1e6,
        "t_comm_us": t_comm * 1e6,
        "t_layer_us": t_layer * 1e6,
        "t_forward_us": t_layer * mp_layers * 1e6,
        "efficiency": eff,
        "halo_bytes": rep.halo_bytes,
        "allgather_bytes": rep.allgather_bytes,
        "comm_ratio": rep.ratio,
    }
