#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nmrgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out FILE] [--profile]

Phases, in order; any failure exits non-zero and prints no result:

 1. Require a CUDA device; print the card's name and power limit.
 2. Build the kernels from nmrgnn_tpu_torch/csrc/ with nvcc (sm_90a), one
    nvcc per source, all started together.
 3. Hold each kernel against its plain PyTorch version on the card, at the
    shapes of phase 4's graph, and time both with CUDA events. The band
    builds from edge values (B2) and Chebyshev ones (B4, B8) equal their
    plain versions bit for bit (the same float32 values summed in slot
    order and rounded once), in float32 and bfloat16, and are also timed
    alone (torch.profiler) beside the kernels they replaced (REPLACED_MS)
    and, as library_ms, torch.zeros of their bands (the write alone: a
    yardstick, not the same function). The fused exact edge stage (B3):
    float32 rtol/atol 1e-5. The MP layers: float32 2e-4; bfloat16 within
    one step of h (rounded to bfloat16 between the products, after float32
    sums taken in another order) relative to the output's scale, plus one
    rounding of the output. The class kernels run once per window class.
    The band occupancy kernels equal their plain versions exactly, and the
    occupancy from nlist covers every nonzero of the band. The MP kernel
    is given the occupancy as the forwards give it; its line also prints
    the share of (32-row block, 16-column chunk) pairs it loads, its
    blocks a launch and, as library_ms, one torch.bmm of the dense band
    against its windows (a yardstick the port never calls), and its device
    time given an empty, the real and a full occupancy (torch.profiler).
    B3 is also timed alone (torch.profiler), with the hidden EdgeFC
    products through torch.matmul (cuBLAS, TF32 off) on the [N * K, H]
    RBF activations as library_ms: a yardstick, not the same function.
 4. The main paths, each driven with the launch counts set to 0 just
    before and read just after: the bundled weights (load_model), a
    synthetic protein-like structure of 2,482 atoms written as a PDB from
    --seed, universe2graph, then
    a. exact serving, ServingModel.predict on 3 frames (each later frame's
       coordinates jittered by 0.05 A): finite peaks equal to the plain
       gather forward on the card within rtol/atol 5e-4; one fused
       edge-band build, one band occupancy and one MP layer per layer per
       frame (every banded forward below makes one occupancy per band and
       hands it to the layers that read the band). Then one
       forward of the unfused edge branch, which must launch build_band.
    b. fast serving (precision="fast": bfloat16 and the Chebyshev edge
       stage) of the same 3 frames: finite peaks, within the JAX
       package's exact-vs-fast band of the exact peaks (rtol 0.05, atol
       1.0 ppm, Pearson r > 0.9999); frames 0 and 1 differ; per frame on
       the class forward one Chebyshev build and 4 partial MP layers per
       window class, on the uniform forward one Chebyshev build and 4
       bfloat16 MP layers (the branch read from the model's class plan;
       both forwards must be taken).
    c. the uniform fast forward once directly (apply_banded(cheb=...)):
       1 build_band_poly and 4 mp_banded launches, equal to its plain
       versions within the fast band with a mean difference under 0.05
       ppm; and the class forward against its plain versions alike.
    Forward times (CUDA events) and predict() wall times of both
    precisions; with --profile, a per-kernel breakdown of each forward.
 5. The large structure: 18 shifted copies of that structure on a 3 x 3 x 2
    grid (44,676 atoms), which must resolve to the "banded_hbm" path with an
    RCM window of at most 2048. At its shapes, mp_banded_hbm against its
    plain version (float32 and bfloat16, phase 3's MP tolerances, with the
    same extra lines as phase 3's MP kernel), and mp_banded_hbm_cls per
    window class against its plain version; the fused exact edge stage
    against its plain version at its shapes, alone and a call, with phase
    3's yardstick; B2 (float32), B4 and B8 (bfloat16) at its shapes, bit
    for bit, alone and a call, beside the kernels they replaced and
    torch.zeros of their bands.
    ServingModel on 3 frames: exact peaks equal the plain gather forward
    within rtol/atol 5e-4, with 1 fused build and 4 mp_banded_hbm per
    frame; fast peaks within the fast band of the exact ones, per frame on
    the class forward one Chebyshev build and 4 mp_banded_hbm_cls per
    class, on the uniform forward one Chebyshev build and 4 mp_banded_hbm
    (both forwards must be taken). Exact serving of a bfloat16 config on the
    3 frames: "banded_hbm", fast-band peaks. Each forward driven directly (launches;
    the fast ones against their plain versions, mean under 0.05 ppm),
    timed, and with --profile broken down; predict() wall times.
 6. Trajectories: 8 frames of the 2,482-atom structure at both precisions.
    predict_frames equals per-frame predict within 1e-4 (exact), or lies
    in the fast band of it and within a mean 0.05 ppm of per-frame predict
    on the uniform forward (fast). It launches each kernel once for the
    batch where the frames' union plan passes the JAX package's budget,
    and serves frame by frame where it does not; the batched forward
    (apply_banded_frames) is then driven directly too, with one launch per
    kernel, against the same references. predict_trajectory yields every
    frame in order, equal to per-frame predict. Frames per second of each
    (host clock) and the batched forward's time on the card. Exact serving
    of a bfloat16 config through predict_frames: peaks within a mean 0.05
    ppm of per-frame bfloat16 predict and in the fast band of float32.
 7. The wide band: one globule of 100,000 atoms from --seed (a sphere,
    not a supercell: a large protein assembly with hydrogens), 3 frames,
    whose RCM band is past both banded budgets, so that ServingModel
    resolves it to "blocksparse" at both precisions (required). At its
    shapes, in float32 and bfloat16: build_block_adjacency (B10) against
    its plain version (1e-5, or one bfloat16 step), the block occupancy
    from nlist and from A against theirs (exactly; the one from nlist
    covers every nonzero of A and equals A's own), mp_blocksparse (B11) on
    the group-1 structure and mp_blocksparse_grouped (B12) on the group-4
    structure, given the occupancy as the forward gives it, against theirs
    (phase 3's MP tolerances), alone and a call, with the share of (pair,
    32-row slab, 16-column chunk) pieces they load and their device time
    at an empty / real / full occupancy, and B12 equal to B11 bit for bit;
    a call with the JAX signature (the occupancy derived from A) equal to
    B11 bit for bit. The block occupancy from A alone by the profiler
    (with the launches it recorded) and by CUDA events around one call,
    each as a rate of reading A. Serving the 3 frames: exact
    peaks equal the plain gather forward within rtol/atol 5e-4, fast peaks
    within the fast band of them, 1 B10, 1 block occupancy and 4 B12 per
    frame; whether frames 2-3 were remapped or rebuilt. Exact serving of a
    bfloat16 config, "blocksparse", in the fast band of the exact peaks.
    apply_blocksparse(group=1) driven directly: 1 B10, 1 block occupancy
    and 4 B11, equal to its plain versions (float32 2e-4; bfloat16 a mean
    under 0.05 ppm).
    mode="blocksparse" forced on phase 4's 2,482-atom frames: exact peaks
    equal phase 4a's banded ones within 5e-4. Forward times (CUDA events),
    predict() wall times and, with --profile, each forward's breakdown.
 8. The last TPU kernels, at phase 4's width and on its structure:
    a. mp_banded_poly_fused (B13, the Chebyshev build fused with MP layer
       1) in float32 and bfloat16: M against the plain build (1e-5, or one
       bfloat16 step), nodes_1 against mp_banded_plain on that band (phase
       3's MP tolerances), and equal bit for bit to build_band_poly +
       mp_banded run serially on the card; B13 timed beside that pair, in
       turns, at phase 4's and at phase 5's shapes.
    b. apply_banded(fused_first=True, cheb=...) on phase 4's 3 frames at
       bfloat16 and float32: 1 B13 and 3 mp_banded launches and no
       build_band_poly per forward; peaks within a mean 0.05 ppm of the
       serial uniform forward and in the fast band of phase 4a's exact
       peaks. Forward times beside the serial forward's, in turns; with
       --profile, their breakdowns.
    c. build_band_tracedlo and build_band_poly_tracedlo (B7) with the
       plan's lo as a tensor, equal to build_band / build_band_poly and to
       their plain versions bit for bit (timed alone and a call as phase 3
       times the builds); with nlist - m and lo - m (m: half the padded
       rows, whole tiles) equal to them. The composition of a 2-way row
       split at m (nmrgnn_tpu/parallel/halo.py:609-645): the interior and
       halo bands equal their plain versions; the interior band through
       mp_banded_partial on table[:m] plus the halo band through it on
       table[m:] equals one mp_banded_partial over the full band within
       phase 3's MP tolerance; 2 builds and 2 partial layers.
    d. Exact serving of a compute_dtype="bfloat16" config: the fused exact
       edge stage in bfloat16 against its plain version (one bfloat16 step
       of M's scale: the EdgeFC sums are taken in another order, so an
       operand near a rounding boundary rounds the other way), alone and a
       call, with phase 3's yardstick in bfloat16;
       ServingModel(precision="exact") on the 3 frames, 1 fused build and 4
       bfloat16 MP layers a frame, peaks in the fast band of phase 4a's
       float32 exact peaks; the forward's time beside the float32 one.
 9. The training path at the bundled baseline's width (ModelConfig():
    F=256, E=3, H=128, K=16, 4 EdgeFC, 4 MP and 4 FC layers, random weights
    from --seed, learning rate 1e-3), the CLI's batch_size 8 and pad_to 256,
    mp_path="banded":
    a. the fragments of phase 4's 3-frame structure (fragment size 256)
       written to a TFRecord by write_structure_fragments and read back
       (read_fragments, split_dataset with 10% validation);
    b. on one 8 x 256 batch, the training forward and backward with the
       kernels (build_band_df, mp_banded_df) and with the plain versions
       under autograd on the card, from the same params, noise and dropout
       mask, the noise of one real slot set so that its noised distance is
       below 0 (the band's occupancy must come from the distances before
       the noise): peaks within rtol/atol 5e-4, loss within rel 1e-5, each
       gradient leaf within 1e-3 of its max |g|; 1 build_band, 1
       band_occupancy and 4 mp_banded launches a step (required);
    c. Trainer.fit for 3 epochs from init_state: every loss and validation
       metric finite, epoch 3's loss below epoch 1's; save_model, then
       load_model gives the same peaks;
    d. one training step (forward, backward, Adam) timed with CUDA events
       (median) beside the same step on the "gather" path; its split into
       forward, backward and optimizer (CUDA events); 3 resident steps run
       with CUDA's sync debug mode at "error" (no host sync a step,
       required); steps and fragments a second of a resident epoch; with
       --profile, the device time of the B2 + B1 kernels, the idle share
       of the step and the host's time by operator.
10. The attention family (AMPLayer) at the baseline's width and depth
    (ModelConfig(mp_type="attention"): F=256, E=3, H=128, K=16, 4 EdgeFC,
    4 MP and 4 FC layers, random weights from --seed):
    a. ServingModel on phase 4's 3 frames must resolve "banded_attn": 4
       build_band (B2, E=1, from the softmax weights), 4
       mp_banded_partial (B6) and 1 band occupancy launches a frame
       (required); exact peaks equal the "gather" forward within rtol/atol
       2e-4; apply_banded_attention driven directly against its plain
       versions (2e-4); B2 on the layer-1 softmax band bit for bit and B6
       at E=1 (float32 and bfloat16, phase 3's MP tolerances) against
       their plain versions, timed as phase 3 times them; fast and exact
       bfloat16 serving with the same launches, following the exact peaks
       (Pearson r > 0.9999, mean |diff| < 1 ppm; the fast band's
       elementwise bound is printed, not gated: on these random weights
       the JAX package's own bfloat16 forward leaves it at a few atoms),
       and their forwards within the fast band (mean under 0.05 ppm) of
       their plain versions; predict_frames on the 3 frames with one launch set for
       the batch, equal to per-frame predict within 2e-4. The forwards
       timed with CUDA events (exact, its plain versions, fast, exact
       bfloat16, gather), with --profile broken down with the idle share.
    b. A random organic molecule of fewer than 17 atoms, served with the
       RCM reorder: its padding slots name the old row 0's new place (not
       row 0), and "banded_attn" equals "gather" within 2e-4.
    c. The 44,676-atom supercell must resolve "gather" (the JAX package's
       rule), with one attention kernel launch (amp) a layer and no other;
       finite peaks, the gather forward timed.
    d. Gradients of a loss through apply_banded_attention(differentiable=
       True, noise and dropout on) on phase 4's frame, kernels vs plain,
       each leaf within 1e-6 of its max (the last EdgeFC bias, whose
       gradient the softmax makes 0 on a graph with no padding slot, of
       the largest leaf's) (4 B2, 4 B6, 1 occupancy); 320
       organic molecules written by write_organic_fragments, Trainer.fit
       for 2 epochs on the gather path (batch 8, pad_to 64): finite, the
       loss falls; 3 resident steps with no host sync; the step timed.
    e. neighbors_device and fragment_device (one fragment of 256 atoms
       every 64 atoms) on the 2,482- and 44,676-atom coordinates, timed
       beside neighbors_host (host clock); the neighbor sets equal the
       host's wherever the 16th and 17th distances differ by more than
       0.05 A, the distances within 0.02 A.
11. Widths the kernels are not instantiated for, and the CLI:
    a. for each of C5_CONFIGS ({F=96, E=8, H=64}, {F=32, E=64, H=256},
       {F=256, E=8, H=128, K=12}; random weights): ServingModel
       (mode="banded") serves phase 4's 3 frames (at K = 12, graphs of 12
       neighbors) at "exact" and "fast": the MP and build kernels launch
       (node tables padded to the MP kernel's width, channels in groups,
       the EdgeFC padded to 128 or 256 wide) and no plain version of a
       kernel is called (every ``*_plain`` function wrapped and counted);
       exact peaks within 5e-4 of the plain gather forward on the card,
       fast ones in the JAX package's fast band of it. Training: one
       batch of 8 fragments of 256 atoms through apply_banded_fragments,
       kernels vs plain gradients within 1e-3 of each leaf's max, no
       plain version in the forward; then 3 Trainer steps on the path the
       JAX package's rule gives (banded for F = 256, gather for the F not
       a multiple of 128). The first configuration also at 44,676 atoms
       ("banded_hbm", within 5e-4 of the gather forward). And C6_CONFIGS
       ({F=768, E=1, H=128}: three column blocks of 256, fault C6's
       repair), served alike on phase 4's frames through the kernels only
       (no training).
    b. the CLI (``python -m nmrgnn_tpu_torch.cli``) as subprocesses, the
       independent ones at once: eval-struct on phase 4's PDB (gather;
       --fast at exact with --profile; --fast at fast) and --fast on the
       44,676-atom supercell, each row's peak within 0.01 (the files
       round to 0.01) of the in-process forward; make-fragments -> train
       (2 epochs, the baseline config, --tensorboard: events read back;
       the banded step) -> train --load (1 more epoch) -> eval-tfrecords
       (within 5e-4 of the plain gather forward); hyper (3 trials, 1
       epoch, --seed 0: trial 0 is F=256 E=8 H=64 on the banded step).
       Each command's wall time (host clock, process start included).
12. Atom-partitioned serving over gloo ranks sharing the card (NCCL refuses
    two ranks on one card), each rank one spawned process with a file://
    rendezvous; a rank that fails fails the phase. Prints each rank's
    backend, path, launches, forward time (CUDA events), the halo
    exchange's host time (post to received) and the halo rows and bytes a
    layer (halo_comm_report):
    a. phase 4's 3 frames of 2,482 atoms at the baseline's width, D = 2,
       ServingModel(mesh=...) at exact, fast and with the attention model:
       the kernel path ("banded"), every *_plain function counted (none may
       run), 2 builds (B7a, or B7b at fast) and 8 B6 a forward, 8 B7a and 8
       B6 with attention, a rank; the ranks' peaks equal; exact within 5e-4
       of the single-card ServingModel, fast in the fast band of the exact
       peaks and, on the last frame, within a mean 0.05 ppm of the same
       ranks' forward through the plain versions (its node state is float32
       between the layers, as the JAX package's partitioned forward keeps
       it, so its mean distance from the one-card fast peaks, whose node
       state is bfloat16, is printed, not gated),
       attention r > 0.9999 and mean |diff| < 1 ppm. On rank 0, B7a and B7b
       at the shard's shapes against their plain versions bit for bit and
       B6 (interior and halo bands) within phase 3's MP tolerances, in
       float32 and bfloat16, timed with the dense-band torch.bmm
       yardstick.
    b. the 44,676-atom supercell at D = 4 (45,056 padded rows, 11,264 a
       shard), exact and fast: the path the JAX package's rule
       (_partitioned_fits_vmem) picks, printed; exact within 5e-4 of the
       single-card model, fast in the fast band of its exact peaks.
    c. eval-struct --graph-parallel 2 under torchrun (--nproc-per-node 2)
       on phase 4's PDB: the backend line, and each frame's CSV peaks
       within 0.01 (the file rounds to 0.01) of the single-card exact ones.
13. Partitioned and multi-GPU training over gloo ranks sharing the card
    (phase 12's launcher), random weights of the baseline's width from
    --seed:
    a. phase 4's 3 frames as whole structures, D = 2 (PartitionedTrainer's
       RCM order, padding and plan): the differentiable forward with every
       *_plain function counted (none may run; the backward's plain
       recomputation is the design) and its B7a / B6 / occupancy launches;
       one make_partitioned_train_step step (noise and dropout off) whose
       loss (rel 1e-5), summed gradients (each leaf within 1e-3 of its
       largest, phase 9's gate) and Adam-updated weights equal the same
       step on one card (gnn.apply, name_loss, Adam); the step time (CUDA
       events, median), the exchange's host time forward and backward (the
       reverse ring), the halo rows; PartitionedTrainer.fit for 2 epochs
       with noise and dropout on (finite losses).
    b. the 44,676-atom supercell at D = 4: one partitioned training step,
       finite loss and gradients, the step time and the halo rows a layer.
    c. data parallel on a (2, 1) mesh: the 8 x 256 fragment batch of phase
       9's cell through Trainer(mesh=) banded (B2 + B1 on each rank, noise
       and dropout on, the whole batch's draws), one step against the
       one-card Trainer step under phase 9's gate.
    d. tensor parallel on a (1, 2) mesh (as train --data-parallel 1
       --tensor-parallel lays it out), the gather path: one step's whole
       gradients and weights against the one-card gather step.
    e. train --graph-parallel 2 under torchrun on make-struct-records of
       phase 4's PDB (1 epoch): the saved model loads; the wall time.
14. PaiNN's message kernel (csrc/painn.cu, ops/painn.py message) at the
    painn-predict-44676 cell's shapes: the cell's 44,676-atom structure
    (portbench's supercell at 2.05 A, the atoms within 5 A in K = 80
    slots, in the RCM order), F = 128, random weights from --seed, the
    second block's filter slice of [N, 80, 1,152] taken in place. The
    kernel against message_sums_plain within the card tests' bound (float32
    sums of 2K + 1 terms in another order); its time a wrapper call (CUDA
    events; the context Dense layers included) and alone (torch.profiler),
    the plain version's time, the bound (W's real slots at 3.35 TB/s), and
    a PaiNN forward (gnn.apply) that must launch it exactly once a block
    (3), with its time and memory peak.
15. The attention layer's kernel (csrc/attention.cu, ops/attention.py
    amp) at the amp-predict-44676 cell's shapes: the cell's 44,676-atom
    structure (portbench's supercell and k-NN, K = 16, in the RCM order),
    the nmrgnn-amp configuration (F = 256, E = 3) with random weights from
    --seed, the EdgeFC output of the graph and random node features. The
    kernel against amp_plain (amp_layer plus the residual) within 1e-5 of
    the largest output, each against a float64 evaluation; its time a
    wrapper call (CUDA events; the projection nodes @ wv included) and
    alone (torch.profiler), the projection's and the plain version's time,
    the bound of a wrapper call (the larger of the layer's operations at
    67 TFLOP/s and its bytes at 3.35 TB/s, portbench/flops/attention.py)
    and, printed only, that of the kernel alone (its own bytes, P's read
    included), a layer's memory peak through the kernel and through the
    plain version, and an attention forward (gnn.apply, no grad) that
    must launch it once a layer (4), with its time and memory peak.
16. The equivariant transformer's attention kernel (csrc/et.cu,
    ops/et.py fused_attention) at the et-predict-44676 cell's shapes: the
    cell's structure and cutoff graph (as phase 14's, K = 80, in the RCM
    order) and its Geometry, the torchmd-et configuration (F = 256 in 8
    heads of 32, R = 64) with weights from --seed and nonzero biases,
    random q, k, v and v_state. The kernel against attention (its plain
    version) within the card tests' bound (et_stage_bound: float32 sums
    in another order), each against a float64 evaluation; its time a wrapper
    call (CUDA events) and alone (torch.profiler), the plain version's
    time, the bound (a layer's share of portbench/flops/et.py's
    work["attn"]: operations at 67 TFLOP/s or bytes at 3.35 TB/s, the
    larger), a layer's memory peak through the kernel and through the
    plain version, and an ET forward (gnn.apply, no grad) that must
    launch it once a layer (8), with its time and memory peak.
17. One JSON line listing every kernel of the paths (a counterpart of
    every pl.pallas_call site of the JAX package) with its launches, error
    and times; B2, B1 and the band occupancy also with their launches a
    training step (train_launches); B2 and B6 at one edge channel as
    build_band_attn and mp_banded_partial_attn with their launches in
    phase 10a's serving, and the band occupancy's there (attn_launches);
    every kernel row whose wrapper ran in phase 11a with its calls there
    by configuration (width_launches; a call at E > 4 launches the kernel
    once per channel group of 4, 2 at F = 512; past 512 once per column
    block pair and group); B7a, B7b and B6 also with phase 12a's launches
    a forward of rank 0 (part_launches); B7a, B6 and the occupancy with
    their launches a partitioned training step of rank 0 (13a,
    part_train_launches), B2, B1 and the occupancy with theirs a
    data-parallel step of rank 0 (13c, dp_train_launches).
18. The last line: {"ok": true, "device": {...}}.

Each phase prints its seconds.
The synthetic-PDB writers are plain functions, importable by the tests.
This script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
PEAK_F32_FLOPS = 67e12   # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bfloat16 on the tensor cores: the bound of a bf16 product
PEAK_HBM_BYTES = 3.35e12

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value
FAST_RTOL, FAST_ATOL, FAST_MIN_R = 0.05, 1.0, 0.9999  # tests/test_banded.py:457-458

N_ATOMS = 2482   # as many as myoglobin (PDB 108M)
N_FRAMES = 3
SUPERCELL_GRID = (3, 3, 2)  # 18 copies: 44,676 atoms
MAX_SUPERCELL_W = 2048
TRAJ_FRAMES = 8
GLOBULE_ATOMS = 100_000
REPEATS = 20
MP_ROWS = 32  # rows per block of the MP kernel (csrc/mp.cuh)
# The times of the kernels this version's band builds replaced (one block
# a band row; the parent tree of the row-group design), measured on the
# card by tools/ab_band_builds.py in the call that compared the two trees
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): (a call, CUDA
# events; alone, torch.profiler) in ms, printed beside this run's. B2 and
# B7a in float32, B4, B7b and B8 (3 class launches) in bfloat16.
REPLACED_MS = {
    "build_band": (0.0618, 0.0097), "build_band_44676": (0.2235, 0.1764),
    "build_band_poly": (0.1228, 0.0110), "build_band_poly_44676": (0.1843, 0.1541),
    "build_band_poly_cls": (0.2492, 0.0155), "build_band_poly_cls_44676": (0.3110, 0.1494),
    "build_band_tracedlo": (0.0476, 0.0097), "build_band_poly_tracedlo": (0.1026, 0.0110),
}

# Element mix of a hydrogenated protein (fractions of all atoms).
PROTEIN_ELEMENTS = (("H", 0.497), ("C", 0.32), ("N", 0.085), ("O", 0.095), ("S", 0.003))


def synthetic_coords(n_atoms: int = N_ATOMS, seed: int = 0, spacing: float = 1.4):
    """(coords [n, 3] in Angstrom, elements, rng) of a protein-like
    structure: a cubic lattice of ``spacing`` Angstrom, each point jittered
    by 0.15 A, cut to the ``n_atoms`` points nearest its center (a sphere),
    listed in a boustrophedon walk so that atoms adjacent in the list are
    adjacent in space, as along a chain. Elements are drawn in protein
    proportions. The generator is returned to draw the frames' jitter."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil((3 * n_atoms / (4 * np.pi)) ** (1 / 3) * 1.2)) + 1
    ax = np.arange(-m, m + 1)
    walk = []
    for iz, z in enumerate(ax):
        ys = ax if iz % 2 == 0 else ax[::-1]
        for iy, y in enumerate(ys):
            xs = ax if iy % 2 == 0 else ax[::-1]
            walk.extend((x, y, z) for x in xs)
    pts = np.asarray(walk, np.float64) * spacing
    pts += rng.normal(scale=0.15, size=pts.shape)
    keep = np.sort(np.argsort(np.linalg.norm(pts, axis=1), kind="stable")[:n_atoms])
    names, probs = zip(*PROTEIN_ELEMENTS)
    elements = rng.choice(names, size=n_atoms, p=np.asarray(probs) / sum(probs))
    return pts[keep], elements, rng


def _write_pdb(path: str, coords, elements, rng, frames: int, jitter: float) -> None:
    """``frames`` MODELs; each after the first jitters every coordinate by
    ``jitter`` A (drawn from ``rng``)."""
    resnames = ("ALA", "GLY", "LEU", "SER", "GLU", "LYS")
    lines = []
    for f in range(frames):
        xyz = coords if f == 0 else coords + rng.normal(scale=jitter, size=coords.shape)
        lines.append(f"MODEL     {f + 1:4d}")
        for i, (el, (x, y, z)) in enumerate(zip(elements, xyz)):
            res = i // 10
            lines.append(
                f"ATOM  {(i + 1) % 100000:5d}  {el:<3s} {resnames[res % len(resnames)]:>3s} A"
                f"{(res + 1) % 10000:4d}    {x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
                f"          {el:>2s}"
            )
        lines.append("ENDMDL")
    lines.append("END")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_synthetic_pdb(path: str, n_atoms: int = N_ATOMS, seed: int = 0, frames: int = 1,
                        jitter: float = 0.05, spacing: float = 1.4) -> None:
    """Write a protein-like structure (``synthetic_coords``) as a
    (multi-MODEL) PDB file."""
    coords, elements, rng = synthetic_coords(n_atoms, seed, spacing)
    _write_pdb(path, coords, elements, rng, frames, jitter)


def write_supercell_pdb(path: str, grid=SUPERCELL_GRID, n_atoms: int = N_ATOMS, seed: int = 0,
                        frames: int = 1, jitter: float = 0.05, gap: float = 8.0) -> None:
    """``grid`` shifted copies of the synthetic structure, each its own
    bounding span + ``gap`` A from the next: the construction of the JAX
    package's 44.7k-atom row (benchmarks/scaling.py:28-54). Each copy is
    its own RCM component, so the band stays near the single copy's."""
    coords, elements, rng = synthetic_coords(n_atoms, seed)
    step = coords.max(axis=0) - coords.min(axis=0) + gap
    shifts = [np.array(c) * step for c in np.ndindex(*grid)]
    _write_pdb(path, np.concatenate([coords + s for s in shifts]),
               np.tile(elements, len(shifts)), rng, frames, jitter)


def split_windows(lo, m: int, window: int, n_padded: int):
    """(interior, halo) window starts [i32] of the row tiles of shard 0 of
    a 2-way row split at ``m`` (the partitioned forward's bands,
    nmrgnn_tpu/parallel/halo.py:609-645), from the full plan's ``lo`` of
    those tiles: the interior band's windows clipped into the shard's own
    rows [0, m), so indices >= m fall outside them; the halo band's over
    the rows [m, n_padded) with indices shifted by -m (interior ones go
    negative and match nothing), clipped to start at 0."""
    lo = np.asarray(lo, np.int64)
    if window > m:
        raise ValueError(f"window {window} is wider than the shard's {m} rows")
    return (np.minimum(lo, m - window).astype(np.int32),
            np.clip(lo - m, 0, n_padded - m - window).astype(np.int32))


def _time_ms(fn, repeats: int, inner: int = 10) -> float:
    """Time of one call of ``fn`` on the card: CUDA events around ``inner``
    back-to-back calls, divided by ``inner``; the median of ``repeats``
    such runs, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def _template_args(mangled: str) -> str:
    """'mp_banded_kernel<256,3,bf16,1>' from an Itanium-mangled name."""
    m = re.search(r"\d+([a-z_]+_kernel)I", mangled)
    if not m:
        return mangled
    rest, args = mangled[m.end():], []
    tokens = ((r"Li(\d+)E", lambda g: g), (r"Lb([01])E", lambda g: ("false", "true")[int(g)]),
              (r"f", lambda g: "float"), (r"\d+__nv_bfloat16", lambda g: "bf16"))
    while rest and rest[0] != "E":
        for pattern, name in tokens:
            t = re.match(pattern, rest)
            if t:
                args.append(name(t.group(1) if t.groups() else t.group(0)))
                rest = rest[t.end():]
                break
        else:
            break
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_summary(log: str):
    """One line per compiled kernel: template arguments, registers, spills."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _template_args(m.group(1))
        elif "spill stores" in line and name:
            spill = line.split(":")[-1].strip() if ":" in line else line.strip()
            yield f"{name}: {spill}"
        elif "Used" in line and "registers" in line and name:
            yield f"{name}: {line.split('info    :')[-1].strip()}"


def _profile_forward(fn, fwd_ms: float, label: str, runs: int = 5):
    """Device time of each kernel per forward, from torch.profiler, and the
    share of the forward's time (``fwd_ms``) the card spends idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops repeat their kernels' device time
        if e.key.startswith("Optimizer."):
            continue  # torch.optim's range ("Optimizer.step#Adam.step"), not a kernel
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"kernel": e.key[:90], "ms": us / runs / 1e3, "calls": e.count / runs})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    if not rows:
        print(f"profiler ({label}): no device time recorded (not measured)")
        return None
    print(f"profiler ({label}): {busy:.4f} ms of kernels per forward, idle share "
          f"{max(0.0, 1 - busy / fwd_ms):.3f} of the {fwd_ms:.4f} ms forward")
    for r in rows[:12]:
        print(f"  {r['ms']:.4f} ms  x{r['calls']:g}  {r['kernel']}")
    return {"busy_ms": busy, "rows": rows}


def _host_ops(fn, label: str, runs: int = 5, top: int = 12):
    """The host's time a call of ``fn`` by operator (torch.profiler's self
    CPU time), the largest first: where the host's share of a call goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = sorted(({"op": e.key[:70], "ms": e.self_cpu_time_total / runs / 1e3,
                    "calls": e.count / runs} for e in prof.key_averages()),
                  key=lambda r: -r["ms"])
    total = sum(r["ms"] for r in rows)
    print(f"profiler ({label}, host): {total:.3f} ms of operators' self CPU time a call "
          f"(profiler on)")
    for r in rows[:top]:
        print(f"  {r['ms']:.3f} ms  x{r['calls']:g}  {r['op']}")
    return {"self_cpu_ms": total, "rows": rows[:top]}


def _flops(flops) -> float:
    return sum(f for f, _ in flops) if isinstance(flops, (list, tuple)) else flops


def _bound(flops, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    """(ms, "operations" or "bytes"): the larger of the operations' time
    and the bytes' time. ``flops`` is a count at ``peak_flops``, or a list
    of (count, peak) parts run on different units (CUDA cores, tensor
    cores), whose times add."""
    parts = flops if isinstance(flops, (list, tuple)) else [(flops, peak_flops)]
    t_ops, t_bytes = sum(f / p for f, p in parts), nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _replaced(name: str) -> str:
    call, alone = REPLACED_MS[name]
    return f"; replaced kernel a call {call:.4f} ms, alone {alone:.4f} ms"


def _build_timing(dev, name: str, shapes, dtype, parent=None) -> dict:
    """A band build's timing arguments for ``check``: its kernel alone,
    torch.zeros of each of its bands (the write alone: a yardstick, not the
    same function) and, given ``parent``, the replaced kernel's times
    (``REPLACED_MS[parent]``)."""
    import torch

    shapes = shapes if isinstance(shapes, list) else [shapes]
    return dict(
        alone="build_band_poly_kernel" if "poly" in name else "build_band_kernel",
        library=lambda: [torch.zeros(sh, dtype=dtype, device=dev) for sh in shapes],
        library_alone="Fill",
        extra=("; library: torch.zeros of the band (a yardstick: the write alone)"
               + ("" if parent is None else _replaced(parent))))


def _edgefc_yardstick(params, cfg, edges, dtype):
    """B3's yardstick: the hidden EdgeFC products (one torch.matmul each,
    cuBLAS, TF32 off) on the [N * K, H] RBF activations in ``dtype``. Not
    the same function: no RBF, bias, activation, final layer or band."""
    import torch

    from nmrgnn_tpu_torch.ops.rbf import rbf_expand

    ws = [p["kernel"].to(dtype) for p in params["edge_fc"][:-1]]
    x = rbf_expand(edges.reshape(-1), cfg.rbf_low, cfg.rbf_high, ws[0].shape[0]).to(dtype)
    return lambda: [torch.matmul(x, w) for w in ws]


def _mp_blocks(tiles: int, B: int, F: int) -> int:
    """Blocks of one MP kernel launch over ``tiles`` B-row tiles: a block
    takes 32 rows and half the output columns (F >= 128), or all of them
    once the 32-row blocks alone fill the card's SMs twice over
    (``csrc/mp.cuh``'s launch rule)."""
    import torch

    row_blocks = tiles * (B // MP_ROWS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return row_blocks * (2 if F >= 128 and row_blocks < 2 * sms else 1)


def _mp_load(bands, F: int):
    """What the MP kernel stages of bands given as (occupancy, B, W):
    (the share of the (32-row block, 16-column chunk) pairs it loads, the
    blocks of each launch, the occupied (row, chunk) pairs) and a line
    saying so."""
    from nmrgnn_tpu_torch.ops import banded

    loaded = total = row_chunks = 0
    blocks = []
    for occ, B, W in bands:
        bits = banded.occupancy_bits(occ, W)
        per_block = bits.view(-1, MP_ROWS, bits.shape[1]).any(1)
        loaded += int(per_block.sum())
        total += per_block.numel()
        row_chunks += int(bits.sum())
        blocks.append(_mp_blocks(occ.shape[0] // B, B, F))
    share = loaded / max(total, 1)
    return share, blocks, row_chunks, (f"; loads {share:.1%} of the {MP_ROWS}-row x 16-column "
                                       f"chunks, {'+'.join(map(str, blocks))} blocks a launch")


def _kernel_launches_ms(fn, key: str, runs: int = 10):
    """(device time a call of ``fn`` spends in the kernels whose name holds
    ``key``, the launches of them the profiler recorded) over ``runs``
    calls (torch.profiler); the time is None where it records none. The
    time is per recorded launch times the launches a call makes: the
    profiler can miss a launch (it recorded 9 of 10 calls' launches of a
    1.4 ms kernel on the card), and dividing by the calls would then
    report a time too short by that share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if key in e.key]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in rows)
    n = sum(e.count for e in rows)
    return (us / n * max(1, round(n / runs)) / 1e3 if us else None), n


def _kernel_device_ms(fn, key: str, runs: int = 10):
    """Device time a call of ``fn`` spends in the kernels whose name holds
    ``key`` (torch.profiler), or None where the profiler records none."""
    return _kernel_launches_ms(fn, key, runs)[0]


def _occupancy_split(label: str, layer, occ) -> dict:
    """The MP kernel alone (device time) given an empty, the real and a
    full occupancy: no chunk staged (the second product and the fixed
    costs), the band's chunks, every chunk. ``layer(occ)`` runs one layer."""
    import torch

    out = {}
    for name, o in (("empty", torch.zeros_like(occ)), ("real", occ),
                    ("full", torch.full_like(occ, -1))):
        out[name] = _kernel_device_ms(lambda o=o: layer(o), "mp_banded_kernel")
    if None in out.values():
        print(f"{label}: the profiler recorded no device time (not measured)")
    else:
        print(f"{label}: MP kernel alone (device time, profiler) with an empty occupancy "
              f"{out['empty']:.4f} ms, the band's {out['real']:.4f} ms, a full one "
              f"{out['full']:.4f} ms")
    return out


def _pearson(a, b) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def _in_fast_band(got, want, what: str, mean_atol=None) -> str:
    """Fail unless ``got`` is within the JAX package's exact-vs-fast band of
    ``want`` (and, given ``mean_atol``, a mean |difference| under it)."""
    diff = np.abs(got - want)
    r = _pearson(got, want)
    if not np.all(np.isfinite(got)) or r <= FAST_MIN_R or not np.allclose(
            got, want, rtol=FAST_RTOL, atol=FAST_ATOL):
        raise SystemExit(f"chip_smoke: {what} outside the fast band: r={r:.7f}, "
                         f"max |diff| {diff.max():.4f}")
    if mean_atol is not None and diff.mean() >= mean_atol:
        raise SystemExit(f"chip_smoke: {what}: mean |diff| {diff.mean():.4f} >= {mean_atol}")
    return f"r={r:.7f}, max |diff| {diff.max():.4f} ppm, mean {diff.mean():.4f} ppm"


def _near_exact(got, want, what: str) -> str:
    """Fail unless bfloat16 attention peaks ``got`` follow the float32
    ones: Pearson r above the fast band's 0.9999 and a mean |difference|
    under its 1.0 ppm. The fast band's elementwise rtol 0.05 / atol 1.0
    ppm is the JAX package's own for its trained model; on the random
    attention weights of phase 10 (peaks of hundreds of ppm) the JAX
    package's own bfloat16 forward leaves it at a few atoms
    (tools/attention_fast_band.py), so the worst atom is printed, not
    gated."""
    diff = np.abs(got - want)
    r = _pearson(got, want)
    if not np.all(np.isfinite(got)) or r <= FAST_MIN_R or diff.mean() >= FAST_ATOL:
        raise SystemExit(f"chip_smoke: {what}: r={r:.7f}, mean |diff| {diff.mean():.4f}")
    out = int((diff > FAST_ATOL + FAST_RTOL * np.abs(want)).sum())
    return (f"r={r:.7f}, mean |diff| {diff.mean():.4f} ppm, max {diff.max():.4f} ppm, "
            f"{out} of {len(got)} atoms outside rtol 0.05 / atol 1.0")


def _wall_ms(model, g, runs: int) -> float:
    """Median host-clock time of ``model.predict(g)``, in ms."""
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model.predict(g)
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _wrappers():
    """Every kernel wrapper of the forwards, each with its launch count."""
    from nmrgnn_tpu_torch.ops import _cuda

    return _cuda.KERNEL_WRAPPERS


def _reset_counts() -> None:
    from nmrgnn_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()


def _on_card(g, dev):
    import torch

    from nmrgnn_tpu_torch.graph import Graph

    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
    return Graph(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
                   for a, dt in zip(g, dtypes)])


def _phase5(args, dev, params, cfg, cheb_d, check, counts, expect):
    """The large structure: the 44,676-atom supercell through "banded_hbm"
    at both precisions, B5 and B9 against their plain versions at its
    shapes, forward and predict() times. Returns the results and the
    supercell's inputs on the card (graph, plan, node table, inv_degree)."""
    import torch
    import torch.nn.functional as nnf

    from nmrgnn_tpu_torch.data.parse import structure2graph
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.infer import (_edge_features, apply_banded,
                                               apply_banded_hbm_classes)
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import banded

    bf16, f32 = torch.bfloat16, torch.float32
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "supercell.pdb")
        write_supercell_pdb(pdb, grid=SUPERCELL_GRID, n_atoms=N_ATOMS, seed=args.seed,
                            frames=N_FRAMES)
        struct = read_structure(pdb)
    graphs = [structure2graph(struct, frame=f) for f in range(N_FRAMES)]
    order = rcm_order(graphs[0].nlist, graphs[0].edges)
    g_rcm, _ = permute_graph(graphs[0], order, pin_zero=False)
    plan = banded.band_plan(g_rcm.nlist, g_rcm.edges)
    cls_plan = banded.band_plan_classes(g_rcm.nlist, g_rcm.edges)
    T, B, W = plan.num_tiles, plan.block_rows, plan.window
    N, K = g_rcm.nlist.shape
    F, E, L = cfg.atom_feature_size, cfg.edge_feature_size, len(params["mp"])
    classes = ", ".join(f"{len(c.ids)} tiles @ {c.window} ({_mp_blocks(len(c.ids), B, F)} "
                        f"MP blocks)" for c in cls_plan.classes)
    print(f"phase 5: supercell of {np.prod(SUPERCELL_GRID)} copies: N={N} N_pad={plan.n_padded} "
          f"T={T} W={W}; class plan {classes}; {N_FRAMES} frames built and ordered on the "
          f"host in {time.perf_counter() - t0:.1f} s")
    if W > MAX_SUPERCELL_W:
        raise SystemExit(f"chip_smoke: supercell window {W} > {MAX_SUPERCELL_W}")
    gt = _on_card(g_rcm, dev)
    plan_d = banded.plan_on_device(plan, dev)
    cls_d = banded.plan_on_device(cls_plan, dev)
    act = cfg.mp_activation

    # -- serving's request preparation at the supercell's shapes ---------------
    # the graph as given, permuted with its half-tile bounds in one launch,
    # against its plain version bit for bit
    inverse = np.empty(N, np.int64)
    inverse[order] = np.arange(N)
    raw = _on_card(graphs[0], dev)
    perm = [torch.as_tensor(a.astype(np.int32), device=dev) for a in (order, inverse)]
    half = B // 2
    V = raw.atoms.shape[1]
    graph_bytes = N * (V + 2 * K + 1) * 4
    check(
        "permute_tile_bounds", "none (data/reorder.py permute_graph, ops/banded.py band_plan "
        "on the host)",
        lambda: banded.permute_tile_bounds(*raw, *perm, half),
        lambda: banded.permute_tile_bounds_plain(*raw, *perm, half),
        tol=0.0, exact=True, flops=0,
        nbytes=2 * graph_bytes + 2 * N * 4 + -(-N // half) * 8, alone="permute_tile_bounds",
        dtype="float32", row=False, phase=5, repeats=5, inner=10,
        extra=f"; the graph read and written once ({graph_bytes / 1e6:.2f} MB each way), order "
              f"and inverse read once, {-(-N // half)} tile bounds of {half} rows",
    )
    del raw

    # -- B5 and B9 at the supercell's shapes ----------------------------------
    fc = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation)
    ew, H, Lh = params["edge_fc"], cfg.edge_hidden_size, cfg.edge_fc_layers - 1
    real_edges = int((g_rcm.edges > 0).sum())
    bands = {f32: check(
        "build_band_fused", "nmrgnn_tpu/ops/banded.py:1107",
        lambda: banded.build_band_fused(gt.nlist, gt.edges, ew, plan_d, **fc),
        lambda: banded.build_band_fused_plain(gt.nlist, gt.edges, ew, plan_d, **fc),
        tol=1e-5, flops=2 * real_edges * H * (H * Lh + E),
        nbytes=(N * K * 8 + 4 * sum(t.numel() for p in ew for t in p.values()) + T * 4
                + T * E * B * W * 4),
        alone="fused_edge_band_kernel", library=_edgefc_yardstick(params, cfg, gt.edges, f32),
        row=False, phase=5, repeats=5, inner=3,
        extra=f"; library: the {Lh} hidden EdgeFC products alone (torch.matmul, a "
              f"yardstick)",
    )}
    # the band builds at the supercell's shapes, each against its plain
    # version bit for bit: B2 (float32, the unfused exact branch), B4 and
    # B8 (bfloat16, the fast forwards)
    big = dict(row=False, phase=5, repeats=5, inner=3, tol=0.0, exact=True)
    deg = cheb_d.coeffs.shape[0] - 1
    cheb_flops = N * K * (deg - 1) * (2 + 2 * E) + N * K * 2 * E
    cheb_in = N * K * 8 + (deg + 1) * E * 4
    e_feat = _edge_features(params, cfg, gt.edges)
    check(
        "build_band", "nmrgnn_tpu/ops/banded.py:484",
        lambda: banded.build_band(gt.nlist, e_feat, plan_d),
        lambda: banded.build_band_plain(gt.nlist, e_feat, plan_d),
        flops=2 * real_edges * E, nbytes=N * K * 4 * (1 + E) + T * 4 + T * E * B * W * 4,
        **big, **_build_timing(dev, "build_band", (T, E, B, W), f32, "build_band_44676"),
    )
    del e_feat
    bands[bf16] = check(
        "build_band_poly", "nmrgnn_tpu/ops/banded.py:1268",
        lambda: banded.build_band_poly(gt.nlist, gt.edges, cheb_d, plan_d, bf16),
        lambda: banded.build_band_poly_plain(gt.nlist, gt.edges, cheb_d, plan_d, bf16),
        flops=cheb_flops, nbytes=cheb_in + T * 4 + T * E * B * W * 2, source="poly.cu",
        dtype="bfloat16", **big,
        **_build_timing(dev, "build_band_poly", (T, E, B, W), bf16, "build_band_poly_44676"),
    )
    check(
        "build_band_poly_cls", "nmrgnn_tpu/ops/banded.py:1645",
        lambda: [banded.build_band_poly_cls(gt.nlist, gt.edges, cheb_d, c, B, plan.n_padded,
                                            bf16) for c in cls_d.classes],
        lambda: [banded.build_band_poly_cls_plain(gt.nlist, gt.edges, cheb_d, c, B,
                                                  plan.n_padded, bf16) for c in cls_d.classes],
        flops=cheb_flops, source="poly.cu", dtype="bfloat16", **big,
        nbytes=cheb_in + sum(len(c.ids) * (8 + E * B * c.window * 2) for c in cls_plan.classes),
        **_build_timing(dev, "build_band_poly_cls", [(len(c.ids), E, B, c.window)
                                                     for c in cls_plan.classes], bf16,
                        "build_band_poly_cls_44676"),
    )
    nodes = nnf.pad(gnn.dense(params["embed"], gt.atoms), (0, 0, 0, plan.n_padded - N))
    inv_p = nnf.pad(gt.inv_degree, (0, plan.n_padded - N))
    w0 = params["mp"][0]["w"]
    occ = banded.band_occupancy(gt.nlist, gt.edges, plan_d.lo, W, B, plan.n_padded)
    _, _, row_chunks, load = _mp_load([(occ, B, W)], F)
    occ_cls = [banded.band_occupancy(gt.nlist, gt.edges, c.lo, c.window, B, plan.n_padded,
                                     ids=c.ids) for c in cls_d.classes]
    _, _, cls_chunks, cls_load = _mp_load(
        [(o, B, c.window) for o, c in zip(occ_cls, cls_plan.classes)], F)
    win_idx = plan_d.lo.long()[:, None] + torch.arange(W, device=dev)
    for dt, tag, eb, peak in ((f32, "float32", 4, PEAK_F32_FLOPS),
                              (bf16, "bfloat16", 2, PEAK_BF16_FLOPS)):
        M, table = bands[dt], nodes.to(dt)
        nnz = int((M != 0).sum())
        tol = dict(tol=2e-4) if dt == f32 else dict(rtol=BF16_STEP, tol=0.0,
                                                     tol_of_max=2 * BF16_STEP)
        name = "mp_banded_hbm" + ("" if dt == f32 else "_bf16")
        win = table[win_idx]
        check(
            name, "nmrgnn_tpu/ops/banded.py:656",
            lambda M=M, table=table: banded.mp_banded_hbm(M, plan_d, table, w0, inv_p, act, occ),
            lambda M=M, table=table: banded.mp_banded_hbm_plain(M, plan_d, table, w0, inv_p, act),
            **tol, flops=2 * nnz * F + 2 * T * E * B * F * F,
            # the occupied band chunks, the occupancy and lo; the table and
            # inv_degree once, the weights once, the output once
            nbytes=(row_chunks * 16 * E * eb + occ.numel() * 4 + T * 4
                    + plan.n_padded * F * eb * 2 + F * F * E * eb + plan.n_padded * 4),
            peak=peak, source="hbm.cu", dtype=tag, phase=5,
            library=lambda M=M, win=win: torch.bmm(M.view(T, E * B, W), win),
            extra=f"; band {nnz} nonzeros of {M.numel()}{load}",
        )
        del win
        Mc = [banded.build_band_poly_cls(gt.nlist, gt.edges, cheb_d, c, B, plan.n_padded, dt)
              for c in cls_d.classes]
        check(
            "mp_banded_hbm_cls", "nmrgnn_tpu/ops/banded.py:1703",
            lambda Mc=Mc, table=table: [banded.mp_banded_hbm_cls(m, c, B, table, w0, inv_p, act, o)
                                        for m, c, o in zip(Mc, cls_d.classes, occ_cls)],
            lambda Mc=Mc, table=table: [banded.mp_banded_hbm_cls_plain(m, c, B, table, w0,
                                                                       inv_p, act)
                                        for m, c in zip(Mc, cls_d.classes)],
            **tol, peak=peak, source="hbm.cu", dtype=tag, row=dt == bf16, phase=5,
            flops=sum(2 * int((m != 0).sum()) * F + 2 * len(c.ids) * E * B * F * F
                      for m, c in zip(Mc, cls_plan.classes)),
            # each class's occupied band chunks, occupancy, ids and lo, and
            # output rows; the table, the weights and inv_degree once
            nbytes=(cls_chunks * 16 * E * eb
                    + sum(o.numel() * 4 + len(c.ids) * (8 + B * F * eb)
                          for o, c in zip(occ_cls, cls_plan.classes))
                    + plan.n_padded * (F * eb + 4) + F * F * E * eb),
            extra=cls_load,
        )

    split = {tag: _occupancy_split(
        f"phase 5: mp_banded_hbm [{tag}]",
        lambda o, M_=bands[dt], x=nodes.to(dt): banded.mp_banded_hbm(M_, plan_d, x, w0, inv_p,
                                                                      act, o), occ)
        for dt, tag in ((f32, "float32"), (bf16, "bfloat16"))}

    # -- exact serving ----------------------------------------------------------
    def serve(model, g_list):
        out, walls = [], []
        for g in g_list:
            t = time.perf_counter()
            out.append(model.predict(g))
            walls.append(time.perf_counter() - t)
        return out, walls

    _reset_counts()
    model = ServingModel(params, cfg, device=dev)
    peaks, exact_s = serve(model, graphs)
    exact_launches = counts()
    print(f"phase 5: exact: path {model._resolved}, launches {exact_launches}, per-frame wall "
          f"ms {[round(v * 1e3, 3) for v in exact_s]}")
    if model._resolved != "banded_hbm":
        raise SystemExit(f"chip_smoke: the supercell resolved to {model._resolved}")
    expect(exact_launches, build_band_fused=N_FRAMES, mp_banded_hbm=N_FRAMES * L,
           band_occupancy=N_FRAMES)
    if banded.permute_tile_bounds.launches != N_FRAMES:
        raise SystemExit(f"chip_smoke: {banded.permute_tile_bounds.launches} preparation "
                         f"launches for {N_FRAMES} requests")
    worst = 0.0
    for f, (g, p) in enumerate(zip(graphs, peaks)):
        if p.shape != (N,) or not np.all(np.isfinite(p)):
            raise SystemExit(f"chip_smoke: supercell frame {f}: peaks {p.shape} not all finite")
        ref = gnn.apply(params, cfg, _on_card(g, dev)).cpu().numpy()
        np.testing.assert_allclose(p, ref, rtol=5e-4, atol=5e-4)
        worst = max(worst, float(np.max(np.abs(p - ref))))
    print(f"phase 5: exact peaks finite, max|served - plain gather forward| = {worst:.3e} "
          f"(tol 5e-4)")
    if np.array_equal(peaks[0], peaks[1]):
        raise SystemExit("chip_smoke: jittered supercell frames gave identical peaks")

    # -- fast serving -------------------------------------------------------------
    _reset_counts()
    fast = ServingModel(params, cfg, device=dev, precision="fast")
    fast_peaks, fast_s, branches = [], [], []
    for g in graphs:
        t = time.perf_counter()
        fast_peaks.append(fast.predict(g))
        fast_s.append(time.perf_counter() - t)
        gp, _ = permute_graph(g, fast._order, pin_zero=False)
        cp = fast._cls_plan
        on_cls = (cp is not None and len(cp.classes) > 1
                  and banded.class_plan_covers(cp, gp.nlist, gp.edges))
        branches.append(len(cp.classes) if on_cls else 0)
    fast_launches = counts()
    n_cls, n_uni = sum(branches), branches.count(0)
    if not (n_cls and n_uni):
        raise SystemExit(f"chip_smoke: the supercell's fast frames took one forward only "
                         f"({branches}); both are on the path")
    print(f"phase 5: fast: path {fast._resolved}, forwards "
          f"{['classes(%d)' % b if b else 'uniform' for b in branches]} (re-bucketing switch "
          f"{'on' if fast._cls_hbm_off else 'off'}), launches {fast_launches}, per-frame wall "
          f"ms {[round(v * 1e3, 3) for v in fast_s]}")
    if fast._resolved != "banded_hbm":
        raise SystemExit(f"chip_smoke: the supercell resolved to {fast._resolved} (fast)")
    expect(fast_launches, build_band_poly_cls=n_cls, mp_banded_hbm_cls=n_cls * L,
           build_band_poly=n_uni, mp_banded_hbm=n_uni * L, band_occupancy=n_cls + n_uni)
    for f, p in enumerate(fast_peaks):
        print(f"phase 5: fast frame {f} vs exact frame {f}: "
              f"{_in_fast_band(p, peaks[f], f'supercell fast frame {f}')}")

    # -- exact serving of a bfloat16 config (ROADMAP B.6) ------------------------------
    _reset_counts()
    model16 = ServingModel(params, cfg16, device=dev)
    peaks16, bf16_s = serve(model16, graphs)
    bf16_launches = counts()
    if model16._resolved != "banded_hbm":
        raise SystemExit(f"chip_smoke: exact bfloat16 served the supercell through "
                         f"{model16._resolved}")
    expect(bf16_launches, build_band_fused=N_FRAMES, mp_banded_hbm=N_FRAMES * L,
           band_occupancy=N_FRAMES)
    print(f"phase 5: exact bfloat16: path {model16._resolved}, launches "
          f"{ {k: v for k, v in bf16_launches.items() if v} }, per-frame wall ms "
          f"{[round(v * 1e3, 3) for v in bf16_s]}")
    for f, p in enumerate(peaks16):
        print(f"phase 5: exact bfloat16 frame {f} vs exact float32 frame {f}: "
              f"{_in_fast_band(p, peaks[f], f'supercell exact bfloat16 frame {f}')}")

    # -- each forward directly, against its plain versions --------------------------
    fwd = {
        "exact_hbm": lambda: apply_banded(params, cfg, gt, plan_d, hbm_table=True),
        "fast_hbm_classes": lambda: apply_banded_hbm_classes(params, cfg16, gt, cls_d, cheb_d),
        "fast_hbm_uniform": lambda: apply_banded(params, cfg16, gt, plan_d, cheb=cheb_d,
                                                 hbm_table=True),
    }
    nc = len(cls_plan.classes)
    want_launches = {
        "exact_hbm": dict(build_band_fused=1, mp_banded_hbm=L, band_occupancy=1),
        "fast_hbm_classes": dict(build_band_poly_cls=nc, mp_banded_hbm_cls=nc * L,
                                 band_occupancy=nc),
        "fast_hbm_uniform": dict(build_band_poly=1, mp_banded_hbm=L, band_occupancy=1),
    }
    direct = {}
    for k, f in fwd.items():
        _reset_counts()
        got = f()
        torch.cuda.synchronize()
        direct[k] = counts()
        expect(direct[k], **want_launches[k])
        if k == "exact_hbm":
            continue  # held against the gather forward above
        plain = (apply_banded_hbm_classes(params, cfg16, gt, cls_d, cheb_d, use_kernels=False)
                 if k == "fast_hbm_classes" else
                 apply_banded(params, cfg16, gt, plan_d, cheb=cheb_d, hbm_table=True,
                              use_kernels=False))
        print(f"phase 5: {k} launches {direct[k]}; kernels vs plain: "
              f"{_in_fast_band(got.cpu().numpy(), plain.cpu().numpy(), k, 0.05)}")
    fwd_ms = {k: _time_ms(f, 5, inner=3) for k, f in fwd.items()}
    for k in fwd:
        print(f"phase 5: {k} forward on the card {fwd_ms[k]:.4f} ms (median of 5, CUDA events)")

    predict_ms = {"exact": _wall_ms(model, graphs[-1], 5),
                  "fast_frame0": _wall_ms(fast, graphs[0], 5),
                  "fast_last_frame": _wall_ms(fast, graphs[-1], 5)}
    print(f"phase 5: predict() wall ms (median of 5, host clock): "
          f"{json.dumps({k: round(v, 3) for k, v in predict_ms.items()})}")
    breakdown = ({k: _profile_forward(f, fwd_ms[k], k, runs=3) for k, f in fwd.items()}
                 if args.profile else None)

    return {
        "N": N, "N_pad": plan.n_padded, "T": T, "W": W,
        "classes": [[len(c.ids), c.window, _mp_blocks(len(c.ids), B, F)]
                    for c in cls_plan.classes],
        "launches": {
            "mp_banded_hbm": exact_launches["mp_banded_hbm"],
            "mp_banded_hbm_bf16": fast_launches["mp_banded_hbm"],
            "mp_banded_hbm_cls": fast_launches["mp_banded_hbm_cls"],
        },
        "forward_ms": fwd_ms, "predict_wall_ms": predict_ms,
        "frame_wall_s": {"exact": exact_s, "fast": fast_s, "exact_bf16": bf16_s},
        "fast_branches": branches, "forward_breakdown": breakdown,
        "mp_occupancy_split_ms": split,
    }, dict(gt=gt, plan=plan, plan_d=plan_d, nodes=nodes, inv_p=inv_p, graph=graphs[0],
            coords=struct.coords[0])


def _phase6(args, dev, params, cfg, counts, expect) -> dict:
    """Trajectories: TRAJ_FRAMES frames of the 2,482-atom structure through
    predict_frames (one forward, one readback) and predict_trajectory, at
    both precisions, against per-frame predict."""
    import torch

    from nmrgnn_tpu_torch.data.parse import structure2graph
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.data.reorder import permute_graph
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models.infer import apply_banded_frames
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import banded

    F, E, H = cfg.atom_feature_size, cfg.edge_feature_size, cfg.edge_hidden_size
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "trajectory.pdb")
        write_synthetic_pdb(pdb, n_atoms=N_ATOMS, seed=args.seed, frames=TRAJ_FRAMES)
        struct = read_structure(pdb)
    t0 = time.perf_counter()
    graphs = [structure2graph(struct, frame=f) for f in range(TRAJ_FRAMES)]
    build_ms = (time.perf_counter() - t0) * 1e3 / TRAJ_FRAMES
    L = len(params["mp"])
    out = {"frames": TRAJ_FRAMES, "graph_build_ms_per_frame": build_ms}
    wants = {}
    for precision in ("exact", "fast"):
        ref = ServingModel(params, cfg, device=dev, precision=precision)
        want = wants[precision] = np.stack([ref.predict(g) for g in graphs])
        loops = []
        for _ in range(3):  # warm: the order, the plans and the fit are made
            t0 = time.perf_counter()
            for g in graphs:
                ref.predict(g)
            loops.append(time.perf_counter() - t0)
        loop_s = float(np.median(loops))

        model = ServingModel(params, cfg, device=dev, precision=precision)
        _reset_counts()
        got = model.predict_frames(graphs)
        launches = counts()
        if got.shape != (TRAJ_FRAMES, N_ATOMS):
            raise SystemExit(f"chip_smoke: predict_frames gave shape {got.shape}")
        # the union plan and the JAX package's rule for it (predict_frames
        # serves frame by frame when the union is past the budget)
        gp = [permute_graph(g, model._order, pin_zero=False)[0] for g in graphs]
        stack = Graph(*[np.stack([getattr(g, f) for g in gp]) for f in Graph._fields])
        union = banded.band_plan_frames(stack.nlist, stack.edges)
        mc, nb = model.config, 4 if precision == "exact" else 2
        batched = (banded.plan_fits_vmem(union, F, E, dtype_bytes=nb)
                   and banded.fused_build_ok(union, H, E, stack.nlist.shape[-1], out_bytes=nb))
        batch_launches = (dict(build_band_fused=1, mp_banded=L, band_occupancy=1)
                          if precision == "exact"
                          else dict(build_band_poly=1, mp_banded=L, band_occupancy=1))
        how = "one batched forward" if batched else "past the budget, frame by frame"
        print(f"phase 6: {precision}: predict_frames of {TRAJ_FRAMES} frames, union window "
              f"{union.window}: {how}, launches {launches}")
        if batched:
            expect(launches, **batch_launches)
        elif precision == "exact":
            expect(launches, build_band_fused=TRAJ_FRAMES, mp_banded=TRAJ_FRAMES * L,
                   band_occupancy=TRAJ_FRAMES)
        cheb = model._edge_cheb() if precision == "fast" else None
        gt = Graph(*[torch.as_tensor(a, device=dev) for a in stack])
        union_d = banded.plan_on_device(union, dev)

        def batch_fwd():
            return apply_banded_frames(model.params, mc, gt, union_d, cheb=cheb)

        _reset_counts()
        direct = batch_fwd()[:, model._inverse].cpu().numpy()
        expect(counts(), **batch_launches)
        if precision == "exact":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(direct, want, rtol=1e-4, atol=1e-4)
            agree = (f"max |predict_frames - per-frame predict| "
                     f"{float(np.abs(got - want).max()):.3e}, max |batched forward - per-frame "
                     f"predict| "
                     f"{float(np.abs(direct - want).max()):.3e}")
        else:
            uni = ServingModel(params, cfg, device=dev, precision=precision)
            uni._cls_vmem_off = True  # per frame on the uniform forward, as the batch
            want_uni = np.stack([uni.predict(g) for g in graphs])
            agree = (f"vs per-frame predict {_in_fast_band(got.ravel(), want.ravel(), 'frames')}"
                     f"; vs per-frame uniform forward "
                     f"{_in_fast_band(got.ravel(), want_uni.ravel(), 'frames', 0.05)}")
            _in_fast_band(direct.ravel(), want_uni.ravel(), "batched forward", 0.05)
        print(f"phase 6: {precision}: {agree}")
        batch_ms = _time_ms(batch_fwd, 5, inner=3)
        print(f"phase 6: {precision}: the batched forward of {TRAJ_FRAMES} frames (launches "
              f"{batch_launches}) {batch_ms:.4f} ms on the card (CUDA events)")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            model.predict_frames(graphs)
            times.append(time.perf_counter() - t0)
        frames_s = float(np.median(times))

        traj_model = ServingModel(params, cfg, device=dev, precision=precision)
        t0 = time.perf_counter()
        traj = list(traj_model.predict_trajectory(struct))
        traj_s = time.perf_counter() - t0
        if [i for i, _ in traj] != list(range(TRAJ_FRAMES)):
            raise SystemExit(f"chip_smoke: predict_trajectory yielded frames "
                             f"{[i for i, _ in traj]}")
        err = max(float(np.abs(p - want[i]).max()) for i, p in traj)
        if err > 1e-5:
            raise SystemExit(f"chip_smoke: predict_trajectory differs from per-frame predict "
                             f"by {err:.3e}")
        t0 = time.perf_counter()
        for _ in traj_model.predict_trajectory(struct):
            pass
        traj_s = min(traj_s, time.perf_counter() - t0)
        out[precision] = {
            "union_window": union.window, "predict_frames_batched": bool(batched),
            "batched_forward_ms": batch_ms,
            "predict_loop_fps": TRAJ_FRAMES / loop_s,
            "predict_frames_fps": TRAJ_FRAMES / frames_s,
            "predict_trajectory_fps": TRAJ_FRAMES / traj_s,
            "predict_frames_launches": launches,
        }
        print(f"phase 6: {precision}: predict_trajectory yields frames 0-{TRAJ_FRAMES - 1} in "
              f"order, max |trajectory - per-frame predict| {err:.3e}; frames/s (host clock): "
              f"per-frame predict {TRAJ_FRAMES / loop_s:.1f} (median of 3, warm), predict_frames "
              f"{TRAJ_FRAMES / frames_s:.1f} (median of 3, graphs prebuilt), "
              f"predict_trajectory {TRAJ_FRAMES / traj_s:.1f} (best of 2, graph builds "
              f"included; {build_ms:.1f} ms per frame serially)")

    # -- exact serving of a bfloat16 config through predict_frames (ROADMAP B.6) --------
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    per16 = ServingModel(params, cfg16, device=dev)
    want16 = np.stack([per16.predict(g) for g in graphs])
    model = ServingModel(params, cfg16, device=dev)
    _reset_counts()
    got16 = model.predict_frames(graphs)
    launches = counts()
    gp = [permute_graph(g, model._order, pin_zero=False)[0] for g in graphs]
    union = banded.band_plan_frames(np.stack([g.nlist for g in gp]),
                                    np.stack([g.edges for g in gp]))
    batched = (banded.plan_fits_vmem(union, F, E, dtype_bytes=2)
               and banded.fused_build_ok(union, H, E, gp[0].nlist.shape[-1], out_bytes=2))
    n_fwd = 1 if batched else TRAJ_FRAMES
    expect(launches, build_band_fused=n_fwd, mp_banded=n_fwd * L, band_occupancy=n_fwd)
    if got16.shape != (TRAJ_FRAMES, N_ATOMS):
        raise SystemExit(f"chip_smoke: exact bfloat16 predict_frames gave shape {got16.shape}")
    print(f"phase 6: exact bfloat16: predict_frames of {TRAJ_FRAMES} frames "
          f"({'one batched forward' if batched else 'frame by frame'}), launches "
          f"{ {k: v for k, v in launches.items() if v} }; vs per-frame exact bfloat16 predict "
          f"{_in_fast_band(got16.ravel(), want16.ravel(), 'exact bfloat16 frames', 0.05)}; vs "
          f"exact float32 {_in_fast_band(got16.ravel(), wants['exact'].ravel(), 'frames')}")
    out["exact_bf16"] = {"predict_frames_batched": bool(batched),
                         "predict_frames_launches": launches}
    torch.cuda.synchronize()
    return out


def _phase7(args, dev, params, cfg, small_graphs, small_peaks, check, counts, expect) -> dict:
    """The wide band: the GLOBULE_ATOMS globule through "blocksparse" at
    both precisions, B10, B11 and B12 against their plain versions at its
    shapes, apply_blocksparse(group=1) directly, the forced block-sparse
    path on phase 4's frames, forward and predict() times."""
    import torch
    import torch.nn.functional as nnf

    from nmrgnn_tpu_torch.data.parse import structure2graph
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.infer import apply_blocksparse
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import banded
    from nmrgnn_tpu_torch.ops import blocksparse as bs
    from nmrgnn_tpu_torch.ops.edge import edge_features

    bf16, f32 = torch.bfloat16, torch.float32
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "globule.pdb")
        write_synthetic_pdb(pdb, n_atoms=GLOBULE_ATOMS, seed=args.seed, frames=N_FRAMES)
        struct = read_structure(pdb)
    graphs = [structure2graph(struct, frame=f) for f in range(N_FRAMES)]
    order = rcm_order(graphs[0].nlist, graphs[0].edges)
    g_rcm, _ = permute_graph(graphs[0], order, pin_zero=False)
    N, K = g_rcm.nlist.shape
    F, E, L = cfg.atom_feature_size, cfg.edge_feature_size, len(params["mp"])
    windows = {b: banded.band_plan(g_rcm.nlist, g_rcm.edges, block_rows=b).window
               for b in (128, 64)}
    t_struct = time.perf_counter()
    structs = {grp: bs.block_structure(g_rcm.nlist, g_rcm.edges, 128, pair_rounding=32,
                                       group=grp) for grp in (1, 4)}
    t_struct = (time.perf_counter() - t_struct) / len(structs)
    s4 = structs[4]
    B, nb, n_pad, real = s4.block_size, s4.nb, s4.n_padded, int(s4.pair_valid.sum())
    a_elems = {grp: s.n_pairs * E * B * B for grp, s in structs.items()}
    # the share of the (pair, 32-row slab, 16-column chunk) pieces of A that
    # hold a nonzero: the MP kernel stages only those (the block occupancy)
    real_mask = g_rcm.edges > 0
    rows = np.nonzero(real_mask)[0]
    chunk = ((structs[1].edge_pair[real_mask].astype(np.int64) * (B // MP_ROWS)
              + rows % B // MP_ROWS) * (B // 16) + g_rcm.nlist[real_mask] % B // 16)
    chunk_share = np.unique(chunk).size / (structs[1].n_pairs * (B // MP_ROWS) * (B // 16))
    print(f"phase 7: globule of N={N} atoms ({N_FRAMES} frames, built and ordered on the host in "
          f"{time.perf_counter() - t0:.1f} s): RCM window {windows[128]} (128-row tiles), "
          f"{windows[64]} (64-row tiles); nb={nb}, P={structs[1].n_pairs} (group 1), "
          f"{s4.n_pairs} (group 4), {real} real pairs; A {a_elems[4] * 4 / 1e9:.2f} GB in "
          f"float32, {a_elems[4] * 2 / 1e9:.2f} GB in bfloat16 (group 4); "
          f"{int(real_mask.sum())} real edges, {chunk_share:.1%} of the {MP_ROWS} x 16 pieces "
          f"of A hold a nonzero; block_structure {t_struct:.3f} s a structure on the host")
    for precision in ("exact", "fast"):
        path = ServingModel(params, cfg, device=dev, precision=precision,
                            reorder=False)._resolve_mode(g_rcm)
        if path != "blocksparse":
            raise SystemExit(f"chip_smoke: the {N}-atom globule resolved to {path} ({precision})")

    # -- B10, the block occupancy, B11 and B12 at the globule's shapes ----------
    gt = _on_card(g_rcm, dev)
    sd = {grp: bs.struct_on_device(s, dev) for grp, s in structs.items()}
    occs = {grp: bs.block_occupancy(gt.nlist, gt.edges, s) for grp, s in sd.items()}
    n_bits = (B // MP_ROWS) * (B // 16)  # pieces of a pair
    pieces = {grp: int(banded.occupancy_bits(o, n_bits * 16).sum()) for grp, o in occs.items()}
    if pieces[1] != pieces[4] or pieces[1] != np.unique(chunk).size:
        raise SystemExit(f"chip_smoke: the block occupancy marks {pieces} pieces, the host "
                         f"{np.unique(chunk).size}")
    e_feat = edge_features(gt.edges, params["edge_fc"], rbf_low=cfg.rbf_low,
                           rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation)
    real_edges = int(real_mask.sum())
    nodes = nnf.pad(gnn.dense(params["embed"], gt.atoms), (0, 0, 0, n_pad - N))
    inv_p = nnf.pad(gt.inv_degree, (0, n_pad - N))
    w0, act = params["mp"][0]["w"], cfg.mp_activation
    timing = dict(repeats=3, inner=2, phase=7)
    line = "nmrgnn_tpu/ops/blocksparse.py:"
    split, jax_signature = {}, {}
    for dt, tag, eb, peak in ((f32, "float32", 4, PEAK_F32_FLOPS),
                              (bf16, "bfloat16", 2, PEAK_BF16_FLOPS)):
        sfx = "" if dt == f32 else "_bf16"
        A = {4: check(
            "build_block_adjacency" + sfx, line + "215",
            lambda dt=dt: bs.build_block_adjacency(gt.nlist, e_feat, sd[4], dt),
            lambda dt=dt: bs.build_block_adjacency_plain(gt.nlist, e_feat, sd[4], dt),
            **(dict(tol=1e-5) if dt == f32 else dict(rtol=BF16_STEP, tol=1e-5)),
            flops=real_edges * E,  # one float32 add per real edge and channel
            nbytes=N * K * 4 * (1 + E) + s4.n_pairs * 12 + a_elems[4] * eb,
            source="blocksparse.cu", dtype=tag, **timing, extra=" (group-4 structure)",
        )}
        A[1] = bs.build_block_adjacency(gt.nlist, e_feat, sd[1], dt)
        if dt == f32:  # the block occupancy, as the forward makes it, and from A
            occ_bytes = s4.n_pairs * bs.pair_words(B) * 4
            occs[4] = check(
                "block_occupancy", line + "341",
                lambda: bs.block_occupancy(gt.nlist, gt.edges, sd[4]),
                lambda: bs.block_occupancy_plain(gt.nlist, gt.edges, sd[4]),
                tol=0.0, flops=0, nbytes=N * K * 8 + s4.n_pairs * 8 + (nb + 1) * 4 + occ_bytes,
                source="blocksparse.cu", dtype="int32", alone="block_occupancy_kernel",
                **timing, extra=f" (group-4 structure); {pieces[4]} occupied pieces",
            )
            from_a = check(
                "block_occupancy_from_adjacency", line + "341",
                lambda: bs.block_occupancy_from_adjacency(A[4]),
                lambda: bs.block_occupancy_from_adjacency_plain(A[4]),
                tol=0.0, flops=0, nbytes=a_elems[4] * eb + occ_bytes, source="blocksparse.cu",
                dtype="int32", alone="block_occupancy_from_adjacency_kernel", **timing,
                extra=" (group-4 structure, float32 A)",
            )
            if torch.bitwise_and(from_a, torch.bitwise_not(occs[4])).any():  # exactness
                raise SystemExit("chip_smoke: a nonzero of A lies outside the block occupancy")
            print(f"phase 7: the block occupancy from nlist covers every nonzero of A; equal to "
                  f"A's own: {bool(torch.equal(from_a, occs[4]))}")
            del from_a
            # its time alone (profiler, per recorded launch) against CUDA events
            # around one call, each as a rate of reading A
            from_a_fn = lambda: bs.block_occupancy_from_adjacency(A[4])  # noqa: E731
            prof_ms, prof_n = _kernel_launches_ms(
                from_a_fn, "block_occupancy_from_adjacency_kernel", runs=10)
            one_ms = _time_ms(from_a_fn, repeats=10, inner=1)
            a_bytes = a_elems[4] * eb
            from_a_timing = {"profiler_ms": prof_ms, "profiler_launches_of_10": prof_n,
                             "events_one_call_ms": one_ms, "a_bytes": a_bytes}
            print(f"phase 7: block_occupancy_from_adjacency: profiler {prof_ms:.4f} ms a call "
                  f"({prof_n} launches recorded for 10 calls; A read at "
                  f"{a_bytes / prof_ms / 1e9:.3f} TB/s), CUDA events around one call "
                  f"{one_ms:.4f} ms ({a_bytes / one_ms / 1e9:.3f} TB/s); the card's "
                  f"published rate {PEAK_HBM_BYTES / 1e12:.2f} TB/s")
        table = nodes.to(dt)
        mp_tol = (dict(tol=2e-4) if dt == f32
                  else dict(rtol=BF16_STEP, tol=0.0, tol_of_max=2 * BF16_STEP))
        # the first product's FMAs on the CUDA cores; the second product there
        # in float32, on the tensor cores twice (h_hi, h_lo) in bfloat16
        second = 2 * nb * E * B * F * F
        second = [(second, PEAK_F32_FLOPS)] if dt == f32 else [(2 * second, PEAK_BF16_FLOPS)]
        outs = {}
        for grp, wrapper, at in ((1, bs.mp_blocksparse, "301"),
                                 (4, bs.mp_blocksparse_grouped, "341")):
            nnz = int((A[grp] != 0).sum())
            kw = {} if grp == 1 else {"group": 4}
            outs[grp] = check(
                wrapper.__name__ + sfx, line + at,
                lambda a=A[grp], s=sd[grp], f=wrapper, kw=kw, o=occs[grp]: f(
                    a, s, table, w0, inv_p, act, occupancy=o, **kw),
                lambda a=A[grp], s=sd[grp]: bs.mp_blocksparse_plain(a, s, table, w0, inv_p, act),
                **mp_tol, flops=[(2 * nnz * F, PEAK_F32_FLOPS)] + second,
                # the occupied pieces of A and the occupancy; the table, the
                # weights and inv_degree read once, the output written once
                nbytes=(pieces[grp] * E * MP_ROWS * 16 * eb + occs[grp].numel() * 4
                        + 2 * n_pad * F * eb + E * F * F * eb + n_pad * 4
                        + structs[grp].n_pairs * 4 + (nb + 1) * 4),
                peak=peak, source="blocksparse.cu (mp.cuh, kPairs)", dtype=tag, **timing,
                alone="mp_banded_kernel",
                extra=f"; group-{grp} structure, A {nnz} nonzeros of {a_elems[grp]}; loads "
                      f"{pieces[grp] / (structs[grp].n_pairs * n_bits):.1%} of the (pair, "
                      f"{MP_ROWS}-row slab, 16-column chunk) pieces ({pieces[grp]}), "
                      f"{nb * (B // MP_ROWS)} blocks a launch",
            )
        if not torch.equal(outs[4], outs[1]):
            diff = float((outs[4].float() - outs[1].float()).abs().max())
            raise SystemExit(f"chip_smoke: mp_blocksparse_grouped differs from mp_blocksparse "
                             f"[{tag}] by {diff:.3e}")
        print(f"phase 7: mp_blocksparse_grouped on the group-4 structure equals mp_blocksparse "
              f"on the group-1 structure bit for bit [{tag}]")
        split[tag] = _occupancy_split(
            f"phase 7: mp_blocksparse_grouped [{tag}]",
            lambda o, a=A[4], x=table: bs.mp_blocksparse_grouped(a, sd[4], x, w0, inv_p, act,
                                                                 occupancy=o), occs[4])
        # a call with the JAX package's signature derives the occupancy from A
        _reset_counts()
        direct_jax = bs.mp_blocksparse(A[1], sd[1], table, w0, inv_p, act)
        torch.cuda.synchronize()
        jax_signature[tag] = counts()
        expect(jax_signature[tag], mp_blocksparse=1, block_occupancy_from_adjacency=1)
        if not torch.equal(direct_jax, outs[1]):
            raise SystemExit(f"chip_smoke: mp_blocksparse without an occupancy differs from "
                             f"the call given it [{tag}]")
        print(f"phase 7: mp_blocksparse with the JAX signature (occupancy from A) equals the "
              f"call given the occupancy bit for bit [{tag}]")
        del A, outs, table, direct_jax
        torch.cuda.empty_cache()

    # -- serving the frames ---------------------------------------------------------
    def serve(model):
        out, walls, how, prev = [], [], [], None
        for g in graphs:
            t = time.perf_counter()
            out.append(model.predict(g))
            walls.append(time.perf_counter() - t)
            how.append("built" if prev is None else
                       "remapped" if model._struct.pair_rows is prev.pair_rows else "rebuilt")
            prev = model._struct
        return out, walls, how

    served = {}
    for precision in ("exact", "fast"):
        _reset_counts()
        model = ServingModel(params, cfg, device=dev, precision=precision)
        peaks, walls, how = serve(model)
        launches = counts()
        print(f"phase 7: {precision}: path {model._resolved}, structures {how}, launches "
              f"{launches}, per-frame wall ms {[round(v * 1e3, 3) for v in walls]}")
        if model._resolved != "blocksparse":
            raise SystemExit(f"chip_smoke: the globule was served through {model._resolved}")
        expect(launches, build_block_adjacency=N_FRAMES, mp_blocksparse_grouped=N_FRAMES * L,
               block_occupancy=N_FRAMES)
        served[precision] = dict(model=model, peaks=peaks, walls=walls, how=how,
                                 launches=launches)
    worst = 0.0
    for f, (g, p) in enumerate(zip(graphs, served["exact"]["peaks"])):
        if p.shape != (N,) or not np.all(np.isfinite(p)):
            raise SystemExit(f"chip_smoke: globule frame {f}: peaks {p.shape} not all finite")
        ref = gnn.apply(params, cfg, _on_card(g, dev)).cpu().numpy()
        np.testing.assert_allclose(p, ref, rtol=5e-4, atol=5e-4)
        worst = max(worst, float(np.max(np.abs(p - ref))))
    print(f"phase 7: exact peaks finite, max|served - plain gather forward| = {worst:.3e} "
          f"(tol 5e-4)")
    exact_peaks = served["exact"]["peaks"]
    if np.array_equal(exact_peaks[0], exact_peaks[1]):
        raise SystemExit("chip_smoke: jittered globule frames gave identical peaks")
    for f, p in enumerate(served["fast"]["peaks"]):
        print(f"phase 7: fast frame {f} vs exact frame {f}: "
              f"{_in_fast_band(p, exact_peaks[f], f'globule fast frame {f}')}")

    # -- exact serving of a bfloat16 config (ROADMAP B.6) -------------------------------
    _reset_counts()
    model16 = ServingModel(params, cfg16, device=dev)
    peaks16 = [model16.predict(g) for g in graphs]
    launches16 = counts()
    if model16._resolved != "blocksparse":
        raise SystemExit(f"chip_smoke: exact bfloat16 served the globule through "
                         f"{model16._resolved}")
    expect(launches16, build_block_adjacency=N_FRAMES, mp_blocksparse_grouped=N_FRAMES * L,
           block_occupancy=N_FRAMES)
    for f, p in enumerate(peaks16):
        print(f"phase 7: exact bfloat16 frame {f} vs exact frame {f}: "
              f"{_in_fast_band(p, exact_peaks[f], f'globule exact bfloat16 frame {f}')}")

    # -- apply_blocksparse(group=1) directly, against its plain versions ----------
    direct = {}
    for c, tag in ((cfg, "float32"), (cfg16, "bfloat16")):
        _reset_counts()
        got = apply_blocksparse(params, c, gt, sd[1])
        torch.cuda.synchronize()
        direct[tag] = counts()
        expect(direct[tag], build_block_adjacency=1, mp_blocksparse=L, block_occupancy=1)
        got = got.cpu().numpy()
        plain = apply_blocksparse(params, c, gt, sd[1], use_kernels=False).cpu().numpy()
        if tag == "float32":
            np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)
            agree = f"max |diff| {float(np.abs(got - plain).max()):.3e} (tol 2e-4)"
        else:
            agree = _in_fast_band(got, plain, "apply_blocksparse bfloat16", 0.05)
        print(f"phase 7: apply_blocksparse(group=1) [{tag}] launches {direct[tag]}; kernels vs "
              f"plain: {agree}")

    # -- forced block-sparse on phase 4's structure ---------------------------------
    _reset_counts()
    forced = ServingModel(params, cfg, device=dev, mode="blocksparse")
    small = [forced.predict(g) for g in small_graphs]
    expect(counts(), build_block_adjacency=len(small_graphs),
           mp_blocksparse_grouped=len(small_graphs) * L, block_occupancy=len(small_graphs))
    for p, q in zip(small, small_peaks):
        np.testing.assert_allclose(p, q, rtol=5e-4, atol=5e-4)
    print(f"phase 7: mode='blocksparse' on the {small_graphs[0].nlist.shape[0]}-atom frames: max "
          f"|block-sparse - banded exact peaks| "
          f"{max(float(np.abs(p - q).max()) for p, q in zip(small, small_peaks)):.3e} (tol 5e-4)")

    # -- times ------------------------------------------------------------------------
    fwd = {
        "exact": lambda: apply_blocksparse(params, cfg, gt, sd[4], group=4),
        "fast": lambda: apply_blocksparse(params, cfg16, gt, sd[4], group=4),
        "exact_group1": lambda: apply_blocksparse(params, cfg, gt, sd[1]),
    }
    fwd_ms = {k: _time_ms(f, 3, inner=1) for k, f in fwd.items()}
    for k in fwd:
        print(f"phase 7: {k} forward on the card {fwd_ms[k]:.4f} ms (median of 3, CUDA events)")
    predict_ms = {p: _wall_ms(served[p]["model"], graphs[-1], 3) for p in served}
    print(f"phase 7: predict() wall ms (median of 3, host clock): "
          f"{json.dumps({k: round(v, 3) for k, v in predict_ms.items()})}")
    breakdown = ({k: _profile_forward(f, fwd_ms[k], k, runs=2) for k, f in fwd.items()}
                 if args.profile else None)
    ex, fa = served["exact"]["launches"], served["fast"]["launches"]
    return {
        "from_adjacency_timing": from_a_timing,
        "N": N, "windows": windows, "nb": nb, "nonzero_chunk_share": chunk_share,
        "pairs": {str(g): s.n_pairs for g, s in structs.items()}, "real_pairs": real,
        "launches": {
            "build_block_adjacency": ex["build_block_adjacency"],
            "build_block_adjacency_bf16": fa["build_block_adjacency"],
            "mp_blocksparse": direct["float32"]["mp_blocksparse"],
            "mp_blocksparse_bf16": direct["bfloat16"]["mp_blocksparse"],
            "mp_blocksparse_grouped": ex["mp_blocksparse_grouped"],
            "mp_blocksparse_grouped_bf16": fa["mp_blocksparse_grouped"],
            "block_occupancy": ex["block_occupancy"],
            "block_occupancy_from_adjacency":
                jax_signature["float32"]["block_occupancy_from_adjacency"],
        },
        "structures": {p: v["how"] for p, v in served.items()},
        "forward_ms": fwd_ms, "predict_wall_ms": predict_ms,
        "frame_wall_s": {p: v["walls"] for p, v in served.items()},
        "forward_breakdown": breakdown, "mp_occupancy_split_ms": split,
    }


def _phase8(args, dev, params, cfg, small, large, check, counts, expect) -> dict:
    """The last TPU kernels at phase 4's width: B13 and the fused-first
    forward, the builds with a caller-given window start (B7) and the
    interior + halo composition, exact serving in bfloat16 (B3 in
    bfloat16). ``small``: phase 4's inputs; ``large``: phase 5's."""
    import torch
    import torch.nn.functional as nnf

    from nmrgnn_tpu_torch.data.reorder import permute_graph
    from nmrgnn_tpu_torch.models.infer import _edge_features, apply_banded
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import banded

    bf16, f32 = torch.bfloat16, torch.float32
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    gt, plan, plan_d, cheb = small["gt"], small["plan"], small["plan_d"], small["cheb"]
    nodes, inv_p = small["nodes"], small["inv_p"]
    T, B, W, n_pad = plan.num_tiles, plan.block_rows, plan.window, plan.n_padded
    N, K = gt.nlist.shape
    F, E, H = cfg.atom_feature_size, cfg.edge_feature_size, cfg.edge_hidden_size
    Lh, L = cfg.edge_fc_layers - 1, len(params["mp"])
    w0, act = params["mp"][0]["w"], cfg.mp_activation
    deg = cheb.coeffs.shape[0] - 1
    cheb_flops = N * K * (deg - 1) * (2 + 2 * E) + N * K * 2 * E
    cheb_in = N * K * 8 + (deg + 1) * E * 4
    build_tol = {f32: dict(tol=1e-5), bf16: dict(rtol=BF16_STEP, tol=1e-5)}
    mp_tol = {f32: dict(tol=2e-4), bf16: dict(rtol=BF16_STEP, tol=0.0, tol_of_max=2 * BF16_STEP)}
    launches = {}

    def close(got, want, tol, rtol=None, tol_of_max=0.0):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol if rtol is None else rtol,
                                   atol=tol + tol_of_max * float(want.float().abs().max()))
        return float((got.float() - want.float()).abs().max())

    def in_turns(fns, repeats=10, inner=10):
        """Median times of two versions timed in turns: a, b, b, a."""
        a, b = fns
        t = [_time_ms(f, repeats, inner) for f in (a, b, b, a)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    # -- 8a: B13 against its plain version and against B4 + B1 --------------------
    b13 = {}
    for dt, tag, eb, peak in ((f32, "float32", 4, PEAK_F32_FLOPS),
                              (bf16, "bfloat16", 2, PEAK_BF16_FLOPS)):
        table = nodes.to(dt)

        def fused(table=table, dt=dt):
            return banded.mp_banded_poly_fused(gt.nlist, gt.edges, cheb, plan_d, table, w0,
                                               inv_p, act, out_dtype=dt)

        def plain(table=table, dt=dt):
            return banded.mp_banded_poly_fused_plain(gt.nlist, gt.edges, cheb, plan_d, table,
                                                     w0, inv_p, act, out_dtype=dt)

        def serial(table=table, dt=dt):
            M = banded.build_band_poly(gt.nlist, gt.edges, cheb, plan_d, out_dtype=dt)
            return M, banded.mp_banded(M, plan_d, table, w0, inv_p, act)

        (M, got), (M_plain, _), (M_ser, ser) = fused(), plain(), serial()
        torch.cuda.synchronize()
        m_err = close(M, M_plain, **build_tol[dt])
        nnz = int((M != 0).sum())
        check(
            "mp_banded_poly_fused" + ("" if dt == f32 else "_bf16"),
            "nmrgnn_tpu/ops/banded.py:1522",
            lambda f=fused: f()[1], lambda p=plain: p()[1], **mp_tol[dt],
            flops=cheb_flops + 2 * nnz * F + 2 * T * E * B * F * F,
            # distances and indices, coefficients, lo, the table, the
            # weights and inv_degree read once; M and nodes_1 written once
            nbytes=(cheb_in + T * 4 + n_pad * F * eb * 2 + F * F * E * eb + n_pad * 4
                    + T * E * B * W * eb),
            peak=peak, source="fused_first.cu", dtype=tag, phase=8,
            extra=f"; M vs plain build {m_err:.3e}",
        )
        ser_err = (float((M.float() - M_ser.float()).abs().max()),
                   float((got.float() - ser.float()).abs().max()))
        if not (torch.equal(M, M_ser) and torch.equal(got, ser)):
            raise SystemExit(f"chip_smoke: B13 [{tag}] differs from B4 + B1 on the card: M "
                             f"{ser_err[0]:.3e}, nodes_1 {ser_err[1]:.3e}")
        ms_fused, ms_serial = in_turns((lambda f=fused: f(), lambda s=serial: s()))
        T_l = large["plan"].num_tiles
        lt = large["nodes"].to(dt)
        big = (lambda lt=lt, dt=dt: banded.mp_banded_poly_fused(
                   large["gt"].nlist, large["gt"].edges, cheb, large["plan_d"], lt, w0,
                   large["inv_p"], act, out_dtype=dt),
               lambda lt=lt, dt=dt: banded.mp_banded(banded.build_band_poly(
                   large["gt"].nlist, large["gt"].edges, cheb, large["plan_d"], out_dtype=dt),
                   large["plan_d"], lt, w0, large["inv_p"], act))
        big_fused, big_serial = in_turns(big, repeats=5, inner=3)
        b13[tag] = {"M_vs_serial": ser_err[0], "nodes_1_vs_serial": ser_err[1],
                    "ms": ms_fused, "serial_ms": ms_serial,
                    "large_T": T_l, "large_ms": big_fused, "large_serial_ms": big_serial}
        print(f"phase 8a: mp_banded_poly_fused [{tag}]: max |B13 - (B4 + B1) on the card| M "
              f"{ser_err[0]:.3e}, nodes_1 {ser_err[1]:.3e}; in turns (CUDA events): B13 "
              f"{ms_fused:.4f} ms vs B4 + B1 {ms_serial:.4f} ms at T={T}; {big_fused:.4f} ms vs "
              f"{big_serial:.4f} ms at T={T_l} ({large['gt'].nlist.shape[0]} atoms)")
        del M, got, M_plain, M_ser, ser, table, lt
        torch.cuda.empty_cache()

    # -- 8b: the fused-first forward on phase 4's frames ----------------------------
    fwd_launch = []
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for f, g in enumerate(small["graphs"]):
        gp, inverse = permute_graph(g, small["order"], pin_zero=False)
        plan_f = banded.plan_on_device(banded.band_plan(gp.nlist, gp.edges), dev)
        gf = _on_card(gp, dev)
        for c, tag in ((cfg16, "bfloat16"), (cfg, "float32")):
            _reset_counts()
            got = apply_banded(params, c, gf, plan_f, cheb=cheb, fused_first=True)
            torch.cuda.synchronize()
            fwd_launch.append((tag, counts()))
            expect(fwd_launch[-1][1], mp_banded_poly_fused=1, mp_banded=L - 1,
                   band_occupancy=1)
            got = got.cpu().numpy()[inverse]
            ser = apply_banded(params, c, gf, plan_f, cheb=cheb).cpu().numpy()[inverse]
            _in_fast_band(got, ser, f"fused-first frame {f} [{tag}]", 0.05)
            band = _in_fast_band(got, small["peaks"][f], f"fused-first frame {f} [{tag}]")
            worst[tag] = max(worst[tag], float(np.abs(got - ser).max()))
            print(f"phase 8b: fused-first forward, frame {f} [{tag}]: launches "
                  f"{ {k: v for k, v in fwd_launch[-1][1].items() if v} }; max |fused-first - "
                  f"serial uniform| {np.abs(got - ser).max():.3e} ppm; vs exact peaks {band}")
    for tag in ("float32", "bfloat16"):
        name = "mp_banded_poly_fused" + ("" if tag == "float32" else "_bf16")
        launches[name] = sum(c["mp_banded_poly_fused"] for t, c in fwd_launch if t == tag)
    fwd = {"fused_first_fast": (lambda: apply_banded(params, cfg16, gt, plan_d, cheb=cheb,
                                                     fused_first=True),
                                lambda: apply_banded(params, cfg16, gt, plan_d, cheb=cheb)),
           "fused_first_f32": (lambda: apply_banded(params, cfg, gt, plan_d, cheb=cheb,
                                                    fused_first=True),
                               lambda: apply_banded(params, cfg, gt, plan_d, cheb=cheb))}
    fwd_ms = {}
    for k, pair in fwd.items():
        fwd_ms[k], fwd_ms[k + "_serial"] = in_turns(pair, repeats=10, inner=5)
        print(f"phase 8b: {k} forward {fwd_ms[k]:.4f} ms vs the serial forward "
              f"{fwd_ms[k + '_serial']:.4f} ms (in turns, CUDA events)")
    breakdown = ({k: _profile_forward(pair[0], fwd_ms[k], k) for k, pair in fwd.items()}
                 if args.profile else None)

    # -- 8c: B7 and the interior + halo composition -----------------------------------
    m = (n_pad // 2 + B - 1) // B * B
    pad = n_pad - N
    nl_p = nnf.pad(gt.nlist, (0, 0, 0, pad), value=-1)
    d_p = nnf.pad(gt.edges, (0, 0, 0, pad))
    e_feat = _edge_features(params, cfg, gt.edges)
    e_p = nnf.pad(e_feat, (0, 0, 0, 0, 0, pad))
    lo = plan_d.lo
    real_edges = int((small["g_rcm"].edges > 0).sum())
    builds = {
        "build_band_tracedlo": (
            f32, lambda nl, lo_, rows=n_pad: banded.build_band_tracedlo(nl, e_p[:rows], lo_, W, B),
            lambda nl, lo_, rows=n_pad: banded.build_band_tracedlo_plain(nl, e_p[:rows], lo_, W,
                                                                         B),
            banded.build_band(gt.nlist, e_feat, plan_d), "nmrgnn_tpu/ops/banded.py:788", 4,
            2 * real_edges * E,
            n_pad * K * 4 * (1 + E) + T * 4, "banded.cu"),
        "build_band_poly_tracedlo": (
            bf16, lambda nl, lo_, rows=n_pad: banded.build_band_poly_tracedlo(
                nl, d_p[:rows], cheb, lo_, W, B, bf16),
            lambda nl, lo_, rows=n_pad: banded.build_band_poly_tracedlo_plain(
                nl, d_p[:rows], cheb, lo_, W, B, bf16),
            banded.build_band_poly(gt.nlist, gt.edges, cheb, plan_d, bf16),
            "nmrgnn_tpu/ops/banded.py:1363", 2, cheb_flops, cheb_in + T * 4, "poly.cu"),
    }
    lo_int, lo_halo = split_windows(plan.lo[: m // B], m, W, n_pad)
    split = {}
    for name, (dt, build, plain, ref, line, eb, flops, in_bytes, src) in builds.items():
        tag = "float32" if dt == f32 else "bfloat16"
        full = check(name, line, lambda b=build: b(nl_p, lo), lambda p=plain: p(nl_p, lo),
                     tol=0.0, exact=True, flops=flops, nbytes=in_bytes + T * E * B * W * eb,
                     source=src, dtype=tag, phase=8,
                     **_build_timing(dev, name, (T, E, B, W), dt, name))
        if not torch.equal(full, ref):
            raise SystemExit(f"chip_smoke: {name} with the plan's lo differs from its build")
        shifted = build(nl_p - m, lo - m)
        torch.cuda.synchronize()
        if not (torch.equal(shifted, full) and torch.equal(shifted, plain(nl_p - m, lo - m))):
            raise SystemExit(f"chip_smoke: {name} with indices shifted by -{m} differs")
        table = nodes.to(dt)
        want = banded.mp_banded_partial(full[: m // B].contiguous(), plan.lo[: m // B], table, w0)
        _reset_counts()
        M_int = build(nl_p[:m], lo_int, m)
        M_halo = build(nl_p[:m] - m, lo_halo, m)
        acc = (banded.mp_banded_partial(M_int, lo_int, table[:m], w0)
               + banded.mp_banded_partial(M_halo, lo_halo, table[m:], w0))
        torch.cuda.synchronize()
        got_launches = counts()
        # direct partial layers with the JAX signature: each derives its
        # occupancy from its band
        expect(got_launches, **{name: 2, "mp_banded_partial": 2, "band_occupancy_from_band": 2})
        launches["band_occupancy_from_band"] = got_launches["band_occupancy_from_band"]
        launches[name] = got_launches[name]
        if not (torch.equal(M_halo, plain(nl_p[:m] - m, lo_halo, m))
                and torch.equal(M_int, plain(nl_p[:m], lo_int, m))):
            raise SystemExit(f"chip_smoke: {name}'s interior or halo band differs from its "
                             f"plain version")
        err = close(acc, want, **mp_tol[dt])
        split[name] = {"split_vs_full": err, "halo_nonzeros": int((M_halo != 0).sum())}
        print(f"phase 8c: {name} [{tag}]: with the plan's lo equal to its build; indices and lo "
              f"shifted by -{m}: equal to it and to the plain version; 2-way split at m={m}: "
              f"launches { {k: v for k, v in got_launches.items() if v} }, interior and halo "
              f"bands ({split[name]['halo_nonzeros']} nonzeros) equal to their plain versions, "
              f"max |interior + halo - full| {err:.3e}")
        del full, shifted, M_int, M_halo, acc, want, table

    # -- 8d: exact serving of a bfloat16 config ----------------------------------------
    ew = params["edge_fc"]
    fc = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation)
    check(
        "build_band_fused_bf16", "nmrgnn_tpu/ops/banded.py:1107",
        lambda: banded.build_band_fused(gt.nlist, gt.edges, ew, plan_d, **fc, out_dtype=bf16,
                                        compute_dtype=bf16),
        lambda: banded.build_band_fused_plain(gt.nlist, gt.edges, ew, plan_d, **fc,
                                              out_dtype=bf16, compute_dtype=bf16),
        rtol=BF16_STEP, tol=0.0, tol_of_max=BF16_STEP,
        # every EdgeFC product has bfloat16 operands (the final H x E's too)
        flops=2 * real_edges * H * (H * Lh + E), peak=PEAK_BF16_FLOPS,
        nbytes=(N * K * 8 + 4 * sum(t.numel() for p in ew for t in p.values()) + T * 4
                + T * E * B * W * 2),
        dtype="bfloat16", phase=8, alone="fused_edge_band_kernel",
        library=_edgefc_yardstick(params, cfg, gt.edges, bf16),
        extra=f"; library: the {Lh} hidden EdgeFC products alone in bfloat16 (torch.matmul, a "
              f"yardstick)",
    )
    _reset_counts()
    model16 = ServingModel(params, cfg16, device=dev)
    peaks16 = [model16.predict(g) for g in small["graphs"]]
    served = counts()
    nf = len(small["graphs"])
    expect(served, build_band_fused=nf, mp_banded=nf * L, band_occupancy=nf)
    if model16._resolved != "banded" or model16.config.compute_dtype != "bfloat16":
        raise SystemExit(f"chip_smoke: exact bfloat16 served through {model16._resolved} in "
                         f"{model16.config.compute_dtype}")
    launches["build_band_fused_bf16"] = served["build_band_fused"]
    for f, p in enumerate(peaks16):
        print(f"phase 8d: exact bfloat16 frame {f} vs exact float32 frame {f}: "
              f"{_in_fast_band(p, small['peaks'][f], f'exact bfloat16 frame {f}')}")
    exact_ms = in_turns((lambda: apply_banded(params, cfg16, gt, plan_d),
                         lambda: apply_banded(params, cfg, gt, plan_d)))
    print(f"phase 8d: exact serving in bfloat16: launches "
          f"{ {k: v for k, v in served.items() if v} } for {nf} frames; forward "
          f"{exact_ms[0]:.4f} ms vs float32 {exact_ms[1]:.4f} ms (in turns, CUDA events)")
    return {
        "m": m, "launches": launches, "b13": b13, "forward_ms": fwd_ms,
        "fused_first_vs_serial_max_ppm": worst, "split": split,
        "exact_bf16_forward_ms": exact_ms[0], "exact_f32_forward_ms": exact_ms[1],
        "forward_breakdown": breakdown,
    }


def _phase9(args, dev, counts, expect) -> dict:
    """The training path at the baseline's full width (see the module's
    docstring, phase 9). Returns its results."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
    from nmrgnn_tpu_torch.data.dataset import (FragmentLoader, batch_samples, read_fragments,
                                               split_dataset)
    from nmrgnn_tpu_torch.data.fragment import write_structure_fragments
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.library import load_model, save_model
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.infer import apply_banded_fragments
    from nmrgnn_tpu_torch.train.trainer import Trainer, fold_sample_weight
    from nmrgnn_tpu_torch.train.losses import name_loss

    cfg = ModelConfig(learning_rate=1e-3)
    tcfg = TrainConfig(batch_size=8, pad_to=256, mp_path="banded", seed=args.seed, epochs=3,
                       validation=0.1)
    B, N = tcfg.batch_size, tcfg.pad_to
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "synthetic.pdb")
        write_synthetic_pdb(pdb, n_atoms=N_ATOMS, seed=args.seed, frames=N_FRAMES)
        records = os.path.join(tmp, "fragments.tfrecord")
        t0 = time.perf_counter()
        written = write_structure_fragments(records, read_structure(pdb), fragment_size=N)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_read = sum(1 for _ in read_fragments(records))
        train, val = split_dataset([records], tcfg.validation)
        read_s = time.perf_counter() - t0
    if n_read != written or len(train) + len(val) != written:
        raise SystemExit(f"chip_smoke: wrote {written} fragments, read {n_read}")
    print(f"phase 9a: {written} fragments of {N} atoms written in {write_s:.2f} s, read back "
          f"({n_read}) and split in {read_s:.2f} s: {len(train)} train, {len(val)} validation")

    trainer = Trainer(cfg, tcfg, device=dev)
    if not trainer.use_banded:
        raise SystemExit("chip_smoke: the trainer did not resolve to the banded path")
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    n_params = gnn.count_params(state.params)
    g_np, y_np, w_np = batch_samples(train[:B], N)
    graph, y, w = trainer._to_device(g_np, y_np, w_np)
    K = graph.nlist.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    noise = torch.randn((B, N, K), generator=gen, device=dev)
    keep = torch.rand((B, N, cfg.atom_feature_size // 2), generator=gen, device=dev) \
        < 1.0 - cfg.dropout_rate
    # a real slot whose noised distance falls below 0: it still carries its
    # message (the mask is the distances' before the noise)
    real = torch.nonzero(graph.edges[0] > 0)[0]
    noise[0, real[0], real[1]] = -(graph.edges[0, real[0], real[1]] / cfg.noise) - 1.0
    if not float(graph.edges[0, real[0], real[1]] + cfg.noise * noise[0, real[0], real[1]]) < 0:
        raise SystemExit("chip_smoke: the occupancy-trap slot is not below 0")
    leaves = gnn.trainable_leaves(state.params)
    for t in leaves:
        t.requires_grad_(True)

    def loss_grads(use_kernels):
        peaks = apply_banded_fragments(state.params, cfg, graph, training=True, noise=noise,
                                       dropout_mask=keep, use_kernels=use_kernels)
        loss = name_loss(fold_sample_weight(y, w).reshape(-1, 3), peaks.reshape(-1),
                         trainer.loss_idx)
        return peaks.detach(), loss.detach(), torch.autograd.grad(loss, leaves)

    _reset_counts()
    peaks_k, loss_k, grads_k = loss_grads(True)
    torch.cuda.synchronize()
    step_launches = counts()
    print(f"phase 9b: launches a training step {dict((k, v) for k, v in step_launches.items() if v)}")
    expect(step_launches, build_band=1, band_occupancy=1, mp_banded=len(state.params["mp"]))
    peaks_p, loss_p, grads_p = loss_grads(False)
    torch.testing.assert_close(peaks_k, peaks_p, rtol=5e-4, atol=5e-4)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not np.isfinite(float(loss_k)) or loss_rel > 1e-5:
        raise SystemExit(f"chip_smoke: training loss {float(loss_k)} vs plain {float(loss_p)}")
    worst_grad = 0.0
    for i, (gk, gp) in enumerate(zip(grads_k, grads_p)):
        scale = float(gp.abs().max())
        err = float((gk - gp).abs().max())
        if not torch.isfinite(gk).all() or err > 1e-3 * scale:
            raise SystemExit(f"chip_smoke: gradient leaf {i} {tuple(gp.shape)}: max |kernels - "
                             f"plain| {err:.3e} > 1e-3 x {scale:.3e}")
        worst_grad = max(worst_grad, err / max(scale, 1e-30))
    peak_err = float((peaks_k - peaks_p).abs().max())
    print(f"phase 9b: {n_params} parameters; kernels vs plain on one {B} x {N} batch (noise and "
          f"dropout on, one real slot noised below 0): peaks max |diff| {peak_err:.3e} (rtol/atol "
          f"5e-4), loss {float(loss_k):.6f} vs {float(loss_p):.6f} (rel {loss_rel:.2e}, tol "
          f"1e-5), gradients max |diff| / max |g| {worst_grad:.2e} over {len(leaves)} leaves "
          f"(tol 1e-3)")

    # -- 9c: fit -----------------------------------------------------------------
    t0 = time.perf_counter()
    state = trainer.fit(train, val, state=state, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    hist = state.history
    bad = [k for k, v in hist.items() if not np.all(np.isfinite(v))]
    if bad or len(hist["loss"]) != tcfg.epochs:
        raise SystemExit(f"chip_smoke: non-finite or missing history {bad}: {hist}")
    if not hist["loss"][-1] < hist["loss"][0]:
        raise SystemExit(f"chip_smoke: training loss did not fall: {hist['loss']}")
    print(f"phase 9c: fit {tcfg.epochs} epochs in {fit_s:.2f} s (host clock, first-call "
          f"costs included): loss {[round(v, 4) for v in hist['loss']]}, val_loss "
          f"{[round(v, 4) for v in hist['val_loss']]}, val_h_rmsd "
          f"{[round(v, 4) for v in hist['val_h_rmsd']]}")
    with tempfile.TemporaryDirectory() as tmp:
        save_model(tmp, state.params, cfg)
        loaded, cfg_loaded = load_model(tmp, device=dev)
    with torch.no_grad():
        want = apply_banded_fragments(state.params, cfg, graph)
        got = apply_banded_fragments(loaded, cfg_loaded, graph)
    if cfg_loaded != cfg or not torch.equal(got, want):
        raise SystemExit("chip_smoke: save_model -> load_model changed the peaks")
    print("phase 9c: save_model -> load_model: config and peaks equal")

    # -- 9d: times -----------------------------------------------------------------
    opt = trainer.optimizer(state)
    step = lambda tr: tr.train_step(state, opt, graph, y, w, gen)  # noqa: E731
    gather = Trainer(cfg, dataclasses.replace(tcfg, mp_path="gather"), device=dev)
    step_ms = {"banded": _time_ms(lambda: step(trainer), 10, 5),
               "gather": _time_ms(lambda: step(gather), 10, 5)}
    split_ms = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(12):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = trainer.loss_fn(state.params, graph, y, w, gen)
        ev[1].record()
        grads = torch.autograd.grad(loss, gnn.trainable_leaves(state.params))
        ev[2].record()
        for t, g in zip(gnn.trainable_leaves(state.params), grads):
            t.grad = g
        opt.step()
        ev[3].record()
        ev[3].synchronize()
        for k, a, b in zip(split_ms, ev, ev[1:]):
            split_ms[k].append(a.elapsed_time(b))
    split_ms = {k: float(np.median(v[2:])) for k, v in split_ms.items()}
    # a resident step makes the host wait for the device nowhere (the JAX
    # package's compiled epoch: one loss readback an epoch)
    dg, dy, dw = trainer._resident_dataset(train)
    rows = trainer._batch_rows(np.arange(3 * B))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ib in rows:
            step_loss = trainer.train_step(state, opt, Graph(*[a[ib] for a in dg]), dy[ib],
                                           dw[ib], gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"phase 9d: {len(rows)} resident steps ran with no host sync (sync debug mode "
          f"\"error\"); last loss {float(step_loss):.4f}")
    loader = FragmentLoader(train, pad_to=N, batch_size=B, seed=args.seed)
    epoch_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, steps = trainer._train_epoch(state, opt, loader, train, gen)
        epoch_s.append(time.perf_counter() - t0)
    epoch_s = float(np.median(epoch_s))
    print(f"phase 9d: one training step (forward + backward + Adam, {B} x {N}) on the card "
          f"{step_ms['banded']:.4f} ms banded, {step_ms['gather']:.4f} ms on the gather path "
          f"(a yardstick; median of 10 runs of 5, CUDA events); split (CUDA events, median of "
          f"10): forward {split_ms['forward']:.4f} ms, backward {split_ms['backward']:.4f} ms, "
          f"optimizer {split_ms['optimizer']:.4f} ms")
    print(f"phase 9d: a resident epoch of {steps} steps in {epoch_s * 1e3:.2f} ms (host clock, "
          f"median of 3): {steps / epoch_s:.1f} steps/s, {len(train) / epoch_s:.1f} fragments/s")
    profile = None
    if args.profile:
        profile = _profile_forward(lambda: step(trainer), step_ms["banded"], "training step")
        if profile is not None:
            fwd_kernels = sum(r["ms"] for r in profile["rows"]
                              if any(k in r["kernel"] for k in
                                     ("build_band_kernel", "mp_banded_kernel",
                                      "band_occupancy")))
            print(f"profiler (training step): B2 + B1 + occupancy kernels {fwd_kernels:.4f} ms "
                  f"of {profile['busy_ms']:.4f} ms of kernels")
            profile["b2_b1_ms"] = fwd_kernels
        profile = profile or {}
        profile["host_ops"] = _host_ops(lambda: step(trainer), "training step")
    return {
        "fragments": written, "train": len(train), "val": len(val), "parameters": n_params,
        "launches": step_launches, "peaks_max_abs_err": peak_err, "loss_rel_err": loss_rel,
        "grad_max_rel_err": worst_grad, "history": hist, "fit_s": fit_s, "step_ms": step_ms,
        "step_split_ms": split_ms, "epoch_s": epoch_s, "epoch_steps": steps,
        "steps_per_s": steps / epoch_s, "fragments_per_s": len(train) / epoch_s,
        "profile": profile,
    }


def _phase10(args, dev, small, large, check, counts, expect) -> dict:
    """The attention family at the baseline's width (see the module's
    docstring, phase 10). ``small``: phase 4's inputs (its 3 frames, their
    RCM order and the 2,482-atom coordinates); ``large``: phase 5's (the
    supercell's frame 0 and coordinates). Returns its results."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
    from nmrgnn_tpu_torch.data.dataset import read_fragments, split_dataset
    from nmrgnn_tpu_torch.data.device_graph import fragment_device
    from nmrgnn_tpu_torch.data.embeddings import load_standards
    from nmrgnn_tpu_torch.data.neighbors import neighbors_device, neighbors_host
    from nmrgnn_tpu_torch.data.organic import random_molecule, write_organic_fragments
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.infer import (_edge_features, apply_banded_attention,
                                               padding_rows)
    from nmrgnn_tpu_torch.models.serving import CHEB_DEGREE, ServingModel
    from nmrgnn_tpu_torch.ops import banded
    from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev
    from nmrgnn_tpu_torch.ops.message_passing import attention_weights
    from nmrgnn_tpu_torch.train.trainer import Trainer

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = ModelConfig(mp_type="attention")
    params = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed), load_standards(),
                             device=dev)
    L = cfg.mp_layers
    graphs = small["graphs"]
    n_params = gnn.count_params(params)

    # -- 10a: serving the 2,482-atom frames --------------------------------------
    _reset_counts()
    model = ServingModel(params, cfg, device=dev)
    peaks, frame_s = [], []
    for g in graphs:
        t0 = time.perf_counter()
        peaks.append(model.predict(g))
        frame_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    exact_launches = counts()
    if model._resolved != "banded_attn":
        raise SystemExit(f"chip_smoke: the attention model resolved {model._resolved!r}")
    plan = model._plan
    print(f"phase 10a: attention model, {n_params} parameters (F={cfg.atom_feature_size} "
          f"E={cfg.edge_feature_size} H={cfg.edge_hidden_size} K={cfg.neighbor_number}, "
          f"{L} MP layers, random weights from --seed); {len(graphs)} frames of "
          f"{graphs[0].nlist.shape[0]} atoms through {model._resolved!r} (T={plan.num_tiles}, "
          f"W={plan.window}), launches {exact_launches}, per-frame wall ms "
          f"{[round(t * 1e3, 3) for t in frame_s]}")
    nf = len(graphs)
    expect(exact_launches, build_band=L * nf, mp_banded_partial=L * nf, band_occupancy=nf)
    gather = ServingModel(params, cfg, device=dev)
    gather._resolved = "gather"
    worst = 0.0
    for f, (g, p) in enumerate(zip(graphs, peaks)):
        ref = gather.predict(g)
        if p.shape != ref.shape or not np.all(np.isfinite(p)):
            raise SystemExit(f"chip_smoke: attention frame {f}: peaks not finite")
        np.testing.assert_allclose(p, ref, rtol=2e-4, atol=2e-4)
        worst = max(worst, float(np.max(np.abs(p - ref))))
    if np.array_equal(peaks[0], peaks[1]):
        raise SystemExit("chip_smoke: jittered frames gave identical attention peaks")
    print(f"phase 10a: exact peaks finite, max|banded_attn - gather| = {worst:.3e} (rtol/atol "
          f"2e-4)")

    # the forward on frame 0 directly, and its kernels against their plain versions
    g_rcm = permute_graph(graphs[0], model._order, pin_zero=False)[0]
    gt = _on_card(g_rcm, dev)
    plan_d = banded.plan_on_device(plan, dev)
    rows = padding_rows(g_rcm.nlist, g_rcm.edges)
    T, B, W = plan.num_tiles, plan.block_rows, plan.window
    N, K = g_rcm.nlist.shape
    F = cfg.atom_feature_size
    def fwd(c=cfg, **kw):
        return apply_banded_attention(params, c, gt, plan_d, pad_rows=rows, **kw)

    _reset_counts()
    direct = fwd()
    torch.cuda.synchronize()
    direct_launches = counts()
    expect(direct_launches, build_band=L, mp_banded_partial=L, band_occupancy=1)
    plain = fwd(use_kernels=False)
    torch.testing.assert_close(direct, plain, rtol=2e-4, atol=2e-4)
    print(f"phase 10a: apply_banded_attention launches {direct_launches}; kernels vs plain max "
          f"|diff| {float((direct - plain).abs().max()):.3e} (rtol/atol 2e-4)")
    e = _edge_features(params, cfg, gt.edges)
    nodes = torch.nn.functional.pad(gnn.dense(params["embed"], gt.atoms),
                                    (0, 0, 0, plan.n_padded - N))
    p0 = params["mp"][0]
    a = attention_weights(p0["wq"], p0["wk"], nodes[:N], e, gt.inv_degree)
    a_band = torch.where(gt.edges > 0, a, 0.0)[..., None].contiguous()
    real_edges = int((g_rcm.edges > 0).sum())
    M = check(
        "build_band_attn", "nmrgnn_tpu/ops/banded.py:484",
        lambda: banded.build_band(gt.nlist, a_band, plan_d),
        lambda: banded.build_band_plain(gt.nlist, a_band, plan_d),
        tol=0.0, exact=True, flops=2 * real_edges,
        nbytes=N * K * 8 + T * 4 + T * B * W * 4, phase=10,
        **_build_timing(dev, "build_band", (T, 1, B, W), f32))
    occ = banded.band_occupancy(gt.nlist, gt.edges, plan_d.lo, W, B, plan.n_padded)
    _, _, row_chunks, load = _mp_load([(occ, B, W)], F)
    wv = p0["wv"][:, :, None]
    for dt, tag, eb, peak in ((f32, "float32", 4, PEAK_F32_FLOPS),
                              (bf16, "bfloat16", 2, PEAK_BF16_FLOPS)):
        Md, table = M.to(dt), nodes.to(dt)
        nnz = int((Md != 0).sum())
        check(
            "mp_banded_partial_attn", "nmrgnn_tpu/ops/banded.py:833",
            lambda Md=Md, table=table: banded.mp_banded_partial(Md, plan_d.lo, table, wv, occ),
            lambda Md=Md, table=table: banded.mp_banded_partial_plain(Md, plan_d.lo, table, wv),
            tol=2e-4, tol_of_max=BF16_STEP if dt == bf16 else 0.0,
            flops=2 * nnz * F + 2 * T * B * F * F,
            nbytes=(row_chunks * 16 * eb + occ.numel() * 4 + T * 4 + T * B * F * 4
                    + plan.n_padded * F * eb + F * F * eb),
            peak=peak, source="hbm.cu", dtype=tag, row=dt == f32, phase=10,
            extra=f"; E=1, band {nnz} nonzeros{load}")

    # fast and exact bfloat16 serving, and predict_frames
    cheb = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                              rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation,
                              degree=CHEB_DEGREE)
    cheb_d = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    served = {}
    for tag, kw in (("fast", dict(precision="fast")), ("exact_bf16", {})):
        _reset_counts()
        m = ServingModel(params, cfg16 if tag == "exact_bf16" else cfg, device=dev, **kw)
        served[tag] = [m.predict(g) for g in graphs]
        torch.cuda.synchronize()
        launches = counts()
        expect(launches, build_band=L * nf, mp_banded_partial=L * nf, band_occupancy=nf)
        for f, p in enumerate(served[tag]):
            print(f"phase 10a: {tag} frame {f} ({m._resolved}) vs exact frame {f}: "
                  f"{_near_exact(p, peaks[f], f'attention {tag} frame {f}')}")
        # the kernels against their plain versions in the same arithmetic
        ch = cheb_d if tag == "fast" else None
        print(f"phase 10a: {tag} forward, kernels vs plain: " + _in_fast_band(
            fwd(cfg16, cheb=ch).cpu().numpy(),
            fwd(cfg16, cheb=ch, use_kernels=False).cpu().numpy(),
            f"attention {tag} kernels vs plain", 0.05))
    _reset_counts()
    batch = ServingModel(params, cfg, device=dev).predict_frames(graphs)
    torch.cuda.synchronize()
    frames_launches = counts()
    expect(frames_launches, build_band=L, mp_banded_partial=L, band_occupancy=1)
    np.testing.assert_allclose(batch, np.stack(peaks), rtol=2e-4, atol=2e-4)
    print(f"phase 10a: predict_frames of {nf} frames: launches {frames_launches}, max "
          f"|batch - per-frame predict| {float(np.max(np.abs(batch - np.stack(peaks)))):.3e} "
          f"(rtol/atol 2e-4)")

    fwd_fns = {
        "exact": lambda: fwd(),
        "exact_plain": lambda: fwd(use_kernels=False),
        "fast": lambda: fwd(cfg16, cheb=cheb_d),
        "exact_bf16": lambda: fwd(cfg16),
        "gather": lambda: gnn.apply(params, cfg, gt),
    }
    fwd_ms = {k: _time_ms(f, 10) for k, f in fwd_fns.items()}
    predict_ms = {"exact": _wall_ms(model, graphs[-1], 10)}
    print("phase 10a: forwards on the card (median of 10, CUDA events): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in fwd_ms.items())
          + f"; predict() wall {predict_ms['exact']:.3f} ms (host clock)")
    breakdown = ({k: _profile_forward(fwd_fns[k], fwd_ms[k], f"attention {k}")
                  for k in ("exact", "fast", "gather")} if args.profile else None)

    # -- 10b: the padding row of a small molecule ------------------------------------
    rng = np.random.default_rng(args.seed)
    while True:
        coords_m, elem = random_molecule(rng)
        if coords_m.shape[0] < cfg.neighbor_number + 1:
            break
    nl_m, d_m = neighbors_host(coords_m, cfg.neighbor_number)
    mol = Graph(np.eye(cfg.num_elements, dtype=np.float32)[elem], nl_m.astype(np.int32),
                (d_m * 0.1).astype(np.float32), inv_degree_from_nlist(nl_m))
    m = ServingModel(params, cfg, device=dev)
    got = m.predict(mol)
    gm = ServingModel(params, cfg, device=dev)
    gm._resolved = "gather"
    want = gm.predict(mol)
    mol_rcm = permute_graph(mol, m._order, pin_zero=False)[0]
    pad_at = padding_rows(mol_rcm.nlist, mol_rcm.edges).tolist()
    if m._resolved != "banded_attn" or pad_at == [0] or not pad_at:
        raise SystemExit(f"chip_smoke: the molecule resolved {m._resolved!r} with padding "
                         f"rows {pad_at}")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    print(f"phase 10b: a molecule of {mol.nlist.shape[0]} atoms "
          f"({int((mol.edges == 0).sum())} padding slots, which name row {pad_at} after the "
          f"RCM reorder): max|banded_attn - gather| {float(np.max(np.abs(got - want))):.3e} "
          f"(rtol/atol 2e-4)")

    # -- 10c: the 44,676-atom supercell --------------------------------------------------
    big = ServingModel(params, cfg, device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    big_peaks = big.predict(large["graph"])
    big_wall = time.perf_counter() - t0
    big_launches = counts()
    if big._resolved != "gather":
        raise SystemExit(f"chip_smoke: the supercell resolved {big._resolved!r}")
    expect(big_launches, amp=L)
    if not np.all(np.isfinite(big_peaks)):
        raise SystemExit("chip_smoke: supercell attention peaks not finite")
    big_gt = _on_card(large["graph"], dev)
    big_ms = _time_ms(lambda: gnn.apply(params, cfg, big_gt), 3, 2)
    print(f"phase 10c: {large['graph'].nlist.shape[0]} atoms resolve {big._resolved!r} (the "
          f"E=1 band past the node-table budget); peaks finite, first predict() "
          f"{big_wall * 1e3:.1f} ms (host clock), the gather forward {big_ms:.4f} ms (median "
          f"of 3, CUDA events)")

    # -- 10d: training ----------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    cfg_t = cfg.replace(learning_rate=1e-3)
    noise = torch.randn((N, K), generator=gen, device=dev)
    keep = torch.rand((N, F // 2), generator=gen, device=dev) < 1.0 - cfg.dropout_rate
    wts = torch.rand((N,), generator=gen, device=dev)
    leaves = gnn.trainable_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    grads, peaks_d = [], []
    for use_kernels in (True, False):
        _reset_counts()
        out = apply_banded_attention(params, cfg_t, gt, plan_d, pad_rows=rows,
                                     differentiable=True, training=True, noise=noise,
                                     dropout_mask=keep, use_kernels=use_kernels)
        grads.append(torch.autograd.grad((out * wts).sum(), leaves))
        peaks_d.append(out.detach())
        if use_kernels:
            torch.cuda.synchronize()
            df_launches = counts()
    for t in leaves:
        t.requires_grad_(False)
    expect(df_launches, build_band=L, mp_banded_partial=L, band_occupancy=1)
    torch.testing.assert_close(peaks_d[0], peaks_d[1], rtol=2e-4, atol=2e-4)
    # the last EdgeFC bias moves every real key of a row alike, to which the
    # softmax is blind: with no padding slot in the graph its gradient is 0
    # but for rounding, so it is held to the largest gradient's scale
    blind = id(params["edge_fc"][-1]["bias"])
    top = max(float(g.abs().max()) for g in grads[1])
    worst_grad = 0.0
    for i, (t, gk, gp) in enumerate(zip(leaves, *grads)):
        scale = top if id(t) == blind else float(gp.abs().max())
        err = float((gk - gp).abs().max())
        if not torch.isfinite(gk).all() or err > 1e-6 * scale:
            raise SystemExit(f"chip_smoke: attention gradient leaf {i} {tuple(gp.shape)}: max "
                             f"|kernels - plain| {err:.3e} > 1e-6 x {scale:.3e}")
        worst_grad = max(worst_grad, err / max(scale, 1e-30))
    print(f"phase 10d: differentiable apply_banded_attention (noise and dropout on) launches "
          f"{df_launches}; gradients kernels vs plain max |diff| / max |g| {worst_grad:.2e} "
          f"over {len(leaves)} leaves (tol 1e-6)")
    tcfg = TrainConfig(batch_size=8, pad_to=64, seed=args.seed, epochs=2, validation=0.1)
    with tempfile.TemporaryDirectory() as tmp:
        records = os.path.join(tmp, "organic.tfrecord")
        t0 = time.perf_counter()
        written = write_organic_fragments(records, n_molecules=320, seed=args.seed)
        write_s = time.perf_counter() - t0
        train, val = split_dataset([records], tcfg.validation)
        if len(list(read_fragments(records))) != written:
            raise SystemExit("chip_smoke: organic fragments not read back")
    trainer = Trainer(cfg_t, tcfg, device=dev)
    if trainer.use_banded:
        raise SystemExit("chip_smoke: the attention trainer took the banded path")
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    t0 = time.perf_counter()
    state = trainer.fit(train, val, state=state, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    hist = state.history
    if not all(np.all(np.isfinite(v)) for v in hist.values()) or not \
            hist["loss"][-1] < hist["loss"][0]:
        raise SystemExit(f"chip_smoke: attention training: {hist}")
    opt = trainer.optimizer(state)
    dg, dy, dw = trainer._resident_dataset(train)
    idx = trainer._batch_rows(np.arange(3 * tcfg.batch_size))
    batch = lambda ib: (Graph(*[a[ib] for a in dg]), dy[ib], dw[ib])  # noqa: E731
    step_ms = _time_ms(lambda: trainer.train_step(state, opt, *batch(idx[0]), gen), 10, 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ib in idx:
            last = trainer.train_step(state, opt, *batch(ib), gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"phase 10d: {written} organic molecules written in {write_s:.2f} s ({len(train)} "
          f"train, {len(val)} validation); fit {tcfg.epochs} epochs on the gather path in "
          f"{fit_s:.2f} s: loss {[round(v, 4) for v in hist['loss']]}, val_loss "
          f"{[round(v, 4) for v in hist['val_loss']]}; {len(idx)} resident steps with no host "
          f"sync (last loss {float(last):.4f}); one step ({tcfg.batch_size} x {tcfg.pad_to}) "
          f"{step_ms:.4f} ms (median of 10 runs of 5, CUDA events)")

    # -- 10e: device graph builds -------------------------------------------------------
    builds = {}
    for label, coords in ((str(N), small["coords"]), (str(large["coords"].shape[0]),
                                                       large["coords"])):
        k = cfg.neighbor_number
        c_d = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
        knn_ms = _time_ms(lambda: neighbors_device(c_d, k), 3, 1)
        seeds = torch.arange(0, c_d.shape[0], 64, device=dev)
        frag_ms = _time_ms(lambda: fragment_device(c_d, seeds, 256, k), 3, 1)
        t0 = time.perf_counter()
        neighbors_host(np.asarray(coords, np.float32), k)
        host_ms = (time.perf_counter() - t0) * 1e3
        hi, hd = neighbors_host(np.asarray(coords, np.float32), k + 1)
        nl_d, d_d = (t.cpu().numpy() for t in neighbors_device(c_d, k))
        clear = hd[:, k] - hd[:, k - 1] > 0.05
        bad = sum(set(nl_d[i]) != set(hi[i, :k]) for i in np.flatnonzero(clear))
        d_err = float(np.max(np.abs(np.sort(d_d, 1) - hd[:, :k])))
        if bad or d_err > 0.02:
            raise SystemExit(f"chip_smoke: neighbors_device at {label} atoms: {bad} rows' sets "
                             f"differ from the host's, distances off by {d_err:.3e} A")
        members, nbr, dist, weight = fragment_device(c_d, seeds, 256, k)
        if int(nbr.max()) >= 256 or not bool((dist > 0).all()):
            raise SystemExit(f"chip_smoke: fragment_device at {label} atoms out of range")
        builds[label] = {"neighbors_device_ms": knn_ms, "fragment_device_ms": frag_ms,
                         "fragments": int(seeds.numel()), "neighbors_host_ms": host_ms,
                         "rows_checked": int(clear.sum()), "max_dist_err": d_err}
        print(f"phase 10e: {label} atoms: neighbors_device {knn_ms:.4f} ms, fragment_device "
              f"({seeds.numel()} fragments of 256) {frag_ms:.4f} ms (median of 3, CUDA events); "
              f"neighbors_host {host_ms:.2f} ms (host clock); sets equal the host's on "
              f"the {int(clear.sum())} of {len(clear)} rows whose 16th and 17th distances "
              f"differ by > 0.05 A, distances within {d_err:.2e} A")
    return {
        "parameters": n_params, "launches": exact_launches, "direct_launches": direct_launches,
        "frames_launches": frames_launches, "df_launches": df_launches,
        "padding_rows": pad_at, "max_gather_diff": worst, "forward_ms": fwd_ms,
        "predict_wall_ms": predict_ms, "frame_wall_s": frame_s, "forward_breakdown": breakdown,
        "supercell": {"path": big._resolved, "gather_ms": big_ms, "first_predict_s": big_wall},
        "grad_max_rel_err": worst_grad, "training": {
            "molecules": written, "history": hist, "fit_s": fit_s, "step_ms": step_ms},
        "graph_builds": builds,
    }


# Phase 11a's configurations: widths the kernels are not instantiated for
# (node tables padded to the MP kernel's width, edge channels in groups,
# EdgeFC widths padded, K = 12 not dividing the fused build's slots).
C5_CONFIGS = (
    dict(atom_feature_size=96, edge_feature_size=8, edge_hidden_size=64),
    dict(atom_feature_size=32, edge_feature_size=64, edge_hidden_size=256),
    dict(atom_feature_size=256, edge_feature_size=8, edge_hidden_size=128, neighbor_number=12),
)
C5_HBM = 0  # the configuration also served at 44,676 atoms ("banded_hbm")
# Past the widths the kernels took before fault C6 was repaired: F = 768 at
# one edge channel (three column blocks of 256, the F-split), served only.
C6_CONFIGS = (dict(atom_feature_size=768, edge_feature_size=1, edge_hidden_size=128),)


def _c5_label(kw) -> str:
    return (f"F={kw['atom_feature_size']} E={kw['edge_feature_size']} "
            f"H={kw['edge_hidden_size']} K={kw.get('neighbor_number', 16)}")


class _PlainCalls:
    """Counts the calls of every plain version of the port's kernels (each
    ``*_plain`` function of ops/banded.py and ops/blocksparse.py, and the
    references to them in models/infer.py and models/serving.py) made while
    it is entered. The training backward's recomputation under autograd
    (``banded._plain_vjp``, the JAX package's XLA backward) is counted
    apart, as ``vjp``."""

    MODULES = ("nmrgnn_tpu_torch.ops.banded", "nmrgnn_tpu_torch.ops.blocksparse",
               "nmrgnn_tpu_torch.models.infer", "nmrgnn_tpu_torch.models.serving")

    def __enter__(self):
        import importlib

        self.calls, self.vjp, self._depth, self._saved = {}, 0, 0, []
        for name in self.MODULES:
            mod = importlib.import_module(name)
            for attr, fn in list(vars(mod).items()):
                if attr.endswith("_plain") and callable(fn):
                    self._saved.append((mod, attr, fn))
                    setattr(mod, attr, self._counted(attr, fn))
        banded = importlib.import_module(self.MODULES[0])
        vjp = banded._plain_vjp

        def counted_vjp(*a, **k):
            self.vjp += 1
            self._depth += 1
            try:
                return vjp(*a, **k)
            finally:
                self._depth -= 1

        self._saved.append((banded, "_plain_vjp", vjp))
        banded._plain_vjp = counted_vjp
        return self

    def _counted(self, name, fn):
        def counted(*a, **k):
            if not self._depth:
                self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        return False


def _phase11a(args, dev, small, large, counts) -> dict:
    """Serving and training at widths the kernels are not instantiated for
    (C5_CONFIGS), through the kernels: launches, no plain version, peaks
    against the plain gather forward, training gradients kernels vs plain;
    one configuration at 44,676 atoms."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
    from nmrgnn_tpu_torch.data.dataset import batch_samples, split_dataset
    from nmrgnn_tpu_torch.data.embeddings import load_standards
    from nmrgnn_tpu_torch.data.fragment import write_structure_fragments
    from nmrgnn_tpu_torch.data.parse import structure2graph
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.infer import apply_banded_fragments
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.train.losses import name_loss
    from nmrgnn_tpu_torch.train.trainer import Trainer, fold_sample_weight

    out = {}
    for ci, kw in enumerate(C5_CONFIGS + C6_CONFIGS):
        label = _c5_label(kw)
        cfg = ModelConfig(**kw)
        k = cfg.neighbor_number
        params = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed + ci),
                                 load_standards(), device=dev)
        graphs = small["graphs"] if k == 16 else [
            structure2graph(small["struct"], k, frame=f) for f in range(N_FRAMES)]
        with torch.no_grad():
            ref = [gnn.apply(params, cfg, _on_card(g, dev)).cpu().numpy() for g in graphs]
        rec = {"serving": {}, "launches": {}}
        for precision in ("exact", "fast"):
            model = ServingModel(params, cfg, device=dev, mode="banded", precision=precision)
            _reset_counts()
            t0 = time.perf_counter()
            with _PlainCalls() as plain:
                peaks = [model.predict(g) for g in graphs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: v for n, v in counts().items() if v}
            mp = launches.get("mp_banded", 0) + launches.get("mp_banded_partial", 0)
            if plain.calls or mp < cfg.mp_layers * len(graphs):
                raise SystemExit(f"chip_smoke: 11a {label} {precision}: plain calls "
                                 f"{plain.calls}, launches {launches}")
            for f, (p, r) in enumerate(zip(peaks, ref)):
                if precision == "exact":
                    err = float(np.abs(p - r).max())
                    if not np.all(np.isfinite(p)) or not np.allclose(p, r, rtol=5e-4,
                                                                     atol=5e-4):
                        raise SystemExit(f"chip_smoke: 11a {label} exact frame {f}: max "
                                         f"|served - gather| {err:.3e}")
                    agree = f"max |served - gather| {err:.3e} (rtol/atol 5e-4)"
                else:
                    agree = _in_fast_band(p, r, f"11a {label} fast frame {f}")
            predict_ms = _wall_ms(model, graphs[-1], 5)
            rec["serving"][precision] = {"path": model._resolved, "agree_last": agree,
                                         "wall_s": wall, "launches": launches,
                                         "predict_wall_ms": predict_ms}
            for n, v in launches.items():
                rec["launches"][n] = rec["launches"].get(n, 0) + v
            print(f"phase 11a: {label} {precision}: path {model._resolved}, {len(graphs)} frames "
                  f"in {wall:.2f} s (first calls), then predict() {predict_ms:.3f} ms wall "
                  f"(median of 5, host clock); launches {launches}, no plain version called; "
                  f"frame {len(graphs) - 1} vs the plain gather forward: {agree}")

        if kw in C6_CONFIGS:  # served only
            out[label] = rec
            continue
        # training: the fragments of phase 4's structure at this K
        with tempfile.TemporaryDirectory() as tmp:
            recs = os.path.join(tmp, "f.tfrecord")
            write_structure_fragments(recs, small["struct"], frames=range(1),
                                      fragment_size=256, neighbor_number=k)
            train, _ = split_dataset([recs], 0.0)
        tcfg = TrainConfig(batch_size=8, pad_to=256, seed=args.seed)
        trainer = Trainer(cfg, tcfg, device=dev)
        state = trainer.init_state(torch.Generator().manual_seed(args.seed))
        graph, y, w = trainer._to_device(*batch_samples(train[:8], 256))
        leaves = gnn.trainable_leaves(state.params)
        for t in leaves:
            t.requires_grad_(True)

        def loss_grads(use_kernels):
            peaks = apply_banded_fragments(state.params, cfg, graph, use_kernels=use_kernels)
            loss = name_loss(fold_sample_weight(y, w).reshape(-1, 3), peaks.reshape(-1),
                             trainer.loss_idx)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        _reset_counts()
        with _PlainCalls() as plain:
            loss_k, grads_k = loss_grads(True)
        torch.cuda.synchronize()
        df_launches = {n: v for n, v in counts().items() if v}
        loss_p, grads_p = loss_grads(False)
        if plain.calls or df_launches.get("mp_banded", 0) != cfg.mp_layers:
            raise SystemExit(f"chip_smoke: 11a {label} training forward: plain calls "
                             f"{plain.calls}, launches {df_launches}")
        worst = 0.0
        for i, (gk, gp) in enumerate(zip(grads_k, grads_p)):
            scale = float(gp.abs().max())
            err = float((gk - gp).abs().max())
            if not torch.isfinite(gk).all() or err > 1e-3 * scale:
                raise SystemExit(f"chip_smoke: 11a {label} gradient leaf {i}: max |kernels - "
                                 f"plain| {err:.3e} > 1e-3 x {scale:.3e}")
            worst = max(worst, err / max(scale, 1e-30))
        _reset_counts()
        opt = trainer.optimizer(state)
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        losses = [float(trainer.train_step(state, opt, graph, y, w, gen)) for _ in range(3)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        step_launches = {n: v for n, v in counts().items() if v}
        if not np.all(np.isfinite(losses)) or (
                trainer.use_banded and step_launches.get("mp_banded", 0) != 3 * cfg.mp_layers):
            raise SystemExit(f"chip_smoke: 11a {label} steps: losses {losses}, launches "
                             f"{step_launches}")
        for n, v in step_launches.items():
            rec["launches"][n] = rec["launches"].get(n, 0) + v
        rec["training"] = {"path": "banded" if trainer.use_banded else "gather",
                           "df_launches": df_launches, "step_launches": step_launches,
                           "grad_max_rel_err": worst, "vjp_calls": plain.vjp,
                           "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(
                               float(loss_p)), "losses": losses, "step_ms": step_ms}
        print(f"phase 11a: {label} training: apply_banded_fragments launches {df_launches} "
              f"(no plain version in the forward; {plain.vjp} plain VJPs in the backward, the "
              f"JAX package's backward form), gradients kernels vs plain max |diff| / max |g| "
              f"{worst:.2e} (tol 1e-3); 3 Trainer steps on the {rec['training']['path']} path "
              f"(the JAX package's rule), losses {[round(x, 4) for x in losses]}, "
              f"{step_ms:.1f} ms a step (host clock), launches {step_launches}")
        out[label] = rec

    # one configuration at 44,676 atoms
    kw = C5_CONFIGS[C5_HBM]
    label = _c5_label(kw)
    cfg = ModelConfig(**kw)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed), load_standards(),
                             device=dev)
    g = large["graph"]
    model = ServingModel(params, cfg, device=dev)
    _reset_counts()
    with _PlainCalls() as plain:
        p = model.predict(g)
    torch.cuda.synchronize()
    launches = {n: v for n, v in counts().items() if v}
    with torch.no_grad():
        r = gnn.apply(params, cfg, _on_card(g, dev)).cpu().numpy()
    err = float(np.abs(p - r).max())
    if (model._resolved != "banded_hbm" or plain.calls or not launches.get("mp_banded_hbm")
            or not np.allclose(p, r, rtol=5e-4, atol=5e-4)):
        raise SystemExit(f"chip_smoke: 11a {label} at {len(p)} atoms: path {model._resolved}, "
                         f"plain calls {plain.calls}, launches {launches}, max |diff| {err:.3e}")
    fwd_ms = _wall_ms(model, g, 3)
    out["supercell"] = {"config": label, "path": model._resolved, "launches": launches,
                        "max_gather_diff": err, "predict_wall_ms": fwd_ms}
    print(f"phase 11a: {label} at {len(p)} atoms: path {model._resolved}, launches {launches}, "
          f"no plain version called, max |served - gather| {err:.3e} (rtol/atol 5e-4), "
          f"predict() {fwd_ms:.2f} ms wall (median of 3, host clock)")
    return out


def _cli(*args, log: str, device: str = "cuda") -> subprocess.Popen:
    """Start ``python -m nmrgnn_tpu_torch.cli *args --device device`` in
    the directory of ``log``, its output in ``log``."""
    import nmrgnn_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(nmrgnn_tpu_torch.__file__)))
    path = [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    with open(log, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "nmrgnn_tpu_torch.cli", *args, "--device", device],
            stdout=out, stderr=subprocess.STDOUT, cwd=os.path.dirname(log),
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)))


def _wait_cli(procs: dict, timeout: float = 300) -> dict:
    """Wait for every started CLI process ({name: (process, log, start)});
    fail (killing the others) when one fails or the time runs out.
    Returns {name: (seconds from its start to its exit, output)}."""
    out, t0 = {}, time.perf_counter()
    try:
        while len(out) < len(procs):
            for name, (proc, log, start) in procs.items():
                if name in out or proc.poll() is None:
                    continue
                with open(log) as fh:
                    text = fh.read()
                if proc.returncode != 0:
                    raise SystemExit(f"chip_smoke: CLI {name} exited {proc.returncode}:\n"
                                     f"{text[-3000:]}")
                out[name] = (time.perf_counter() - start, text)
            if time.perf_counter() - t0 > timeout:
                raise SystemExit(f"chip_smoke: CLI {sorted(set(procs) - set(out))} still "
                                 f"running after {timeout} s")
            time.sleep(0.05)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _read_rows(path: str):
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _phase11b(args, dev, params, cfg, small, counts) -> dict:
    """The port's CLI as subprocesses, against in-process results."""
    import torch

    from nmrgnn_tpu_torch.data.dataset import FragmentLoader, split_dataset
    from nmrgnn_tpu_torch.data.parse import structure2graph
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.data.tfrecord import read_tfrecord
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.library import load_model
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.serving import ServingModel

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "synthetic.pdb")
        write_synthetic_pdb(pdb, n_atoms=N_ATOMS, seed=args.seed, frames=N_FRAMES)
        big = os.path.join(tmp, "supercell.pdb")
        write_supercell_pdb(big, grid=SUPERCELL_GRID, n_atoms=N_ATOMS, seed=args.seed)
        frags = os.path.join(tmp, "frags.tfrecord")
        run = lambda name, *a: (name, _cli(*a, log=os.path.join(tmp, f"{name}.log"),  # noqa
                                           device=dev.type))
        t0 = time.perf_counter()
        first = dict([
            run("eval-struct", "eval-struct", pdb, "plain.csv"),
            run("eval-struct --fast exact", "eval-struct", pdb, "exact.csv", "--fast",
                "--profile", "prof"),
            run("eval-struct --fast fast", "eval-struct", pdb, "fast.csv", "--fast",
                "--precision", "fast"),
            run("eval-struct --fast 44,676", "eval-struct", big, "big.csv", "--fast"),
            run("make-fragments", "make-fragments", pdb, frags),
        ])
        done = _wait_cli({n: (p, os.path.join(tmp, f"{n}.log"), t0) for n, p in first.items()})
        t1 = time.perf_counter()
        second = dict([
            run("train", "train", frags, "model", "2", "--checkpoint-path", "ckpt",
                "--tensorboard", "tb"),
            run("hyper", "hyper", frags, "1", "--trials", "3", "--seed", "0", "--tuning_path",
                "tuning"),
        ])
        done.update(_wait_cli({n: (p, os.path.join(tmp, f"{n}.log"), t1)
                               for n, p in second.items()}))
        t2 = time.perf_counter()
        done.update(_wait_cli({"train --load": (
            _cli("train", frags, "model2", "1", "--checkpoint-path", "ckpt", "--load",
                 log=os.path.join(tmp, "train --load.log"), device=dev.type),
            os.path.join(tmp, "train --load.log"), t2)}))
        t3 = time.perf_counter()
        done.update(_wait_cli({"eval-tfrecords": (
            _cli("eval-tfrecords", frags, "--model-file", "model2",
                 log=os.path.join(tmp, "eval-tfrecords.log"), device=dev.type),
            os.path.join(tmp, "eval-tfrecords.log"), t3)}))
        res["wall_s"] = {n: round(s, 2) for n, (s, _) in done.items()}
        res["total_s"] = time.perf_counter() - t0

        # eval-struct: rows and peaks against the in-process forwards
        struct = read_structure(pdb)
        header = ["index", "residues", "resids", "names", "peaks", "confident", "time",
                  "frame"]
        exact = ServingModel(params, cfg, device=dev)
        fast = ServingModel(params, cfg, device=dev, precision="fast")
        with torch.no_grad():
            want = {
                "plain.csv": [gnn.apply(params, cfg, _on_card(g, dev)).cpu().numpy()
                              for g in small["graphs"]],
                "exact.csv": [exact.predict(g) for g in small["graphs"]],
                "fast.csv": [fast.predict(g) for g in small["graphs"]],
            }
        for name, ref in want.items():
            h, rows = _read_rows(os.path.join(tmp, name))
            got = np.array([float(r[4]) for r in rows]).reshape(N_FRAMES, N_ATOMS)
            if h != header or len(rows) != N_FRAMES * N_ATOMS or [r[3] for r in rows[
                    :N_ATOMS]] != list(struct.names):
                raise SystemExit(f"chip_smoke: CLI {name}: header {h}, {len(rows)} rows")
            err = float(np.abs(got - np.round(np.stack(ref), 2)).max())
            if err > 0.01 + 1e-6:
                raise SystemExit(f"chip_smoke: CLI {name}: peaks off the in-process ones by "
                                 f"{err:.3e}")
            res[name] = err
        h, rows = _read_rows(os.path.join(tmp, "big.csv"))
        g_big = structure2graph(read_structure(big), frame=0)
        big_model = ServingModel(params, cfg, device=dev)
        ref = np.round(big_model.predict(g_big), 2)
        got = np.array([float(r[4]) for r in rows])
        if len(rows) != len(ref) or float(np.abs(got - ref).max()) > 0.01 + 1e-6:
            raise SystemExit(f"chip_smoke: CLI eval-struct --fast at {len(ref)} atoms: "
                             f"{len(rows)} rows, peaks off by {np.abs(got - ref).max():.3e}")
        res["big.csv"] = float(np.abs(got - ref).max())
        if big_model._resolved != "banded_hbm":
            raise SystemExit(f"chip_smoke: the supercell resolved {big_model._resolved}")
        traces = os.listdir(os.path.join(tmp, "prof"))
        trace_text = open(os.path.join(tmp, "prof", traces[0])).read() if traces else ""
        if len(traces) != 1 or "mp_banded_kernel" not in trace_text:
            raise SystemExit(f"chip_smoke: eval-struct --profile wrote {traces}")
        res["profile_bytes"] = len(trace_text)

        # train: the banded step, events read back, resumed, evaluated
        train_log = done["train"][1]
        if "training step: banded CUDA kernels" not in train_log:
            raise SystemExit(f"chip_smoke: CLI train did not take the banded step:\n{train_log}")
        (ev,) = [f for f in os.listdir(os.path.join(tmp, "tb")) if f.startswith("events")]
        recs = list(read_tfrecord(os.path.join(tmp, "tb", ev), check_crc=True))
        if len(recs) < 3 or not any(b"val_loss" in r for r in recs):
            raise SystemExit(f"chip_smoke: --tensorboard wrote {len(recs)} events")
        res["tensorboard_events"] = len(recs)
        hist = __import__("pickle").load(open(os.path.join(tmp, "model2-history-0.pb"), "rb"))
        if len(hist["loss"]) != 3:
            raise SystemExit(f"chip_smoke: train --load history {hist}")
        h, rows = _read_rows(os.path.join(tmp, "model2.csv"))
        p2, c2 = load_model(os.path.join(tmp, "model2"), device=dev)
        data = split_dataset([frags], 0.0, c2.num_elements)[0]
        yhat = []
        dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
        with torch.no_grad():
            for gb, yb, wb in FragmentLoader(data, pad_to=256, batch_size=8,
                                             shuffle=False).batches():
                gt = Graph(*[torch.as_tensor(np.asarray(a)).to(dev, dt)
                             for a, dt in zip(gb, dtypes)])
                pred = gnn.apply_batched(p2, c2, gt).cpu().numpy()
                for b in range(yb.shape[0]):
                    yhat.extend(pred[b][wb[b] > 0])
        got = np.array([float(r[2]) for r in rows])
        if h != ["element", "y", "yhat", "class", "name"] or len(rows) != len(yhat) or \
                not np.allclose(got, yhat, rtol=5e-4, atol=5e-4):
            raise SystemExit(f"chip_smoke: CLI eval-tfrecords: {len(rows)} rows vs "
                             f"{len(yhat)}, the banded eval vs the plain gather forward")
        res["eval_tfrecords_max_diff"] = float(np.abs(got - np.array(yhat)).max())
        if not os.path.exists(os.path.join(tmp, "model2.md")):
            raise SystemExit("chip_smoke: CLI eval-tfrecords wrote no markdown table")

        # hyper: each trial's widths and path
        hyper_log = done["hyper"][1]
        trials = [ln for ln in hyper_log.splitlines() if ln.startswith("trial ")]
        if len(trials) != 3 or "trial 0: F=256 E=8 H=64" not in trials[0] or \
                "path=banded" not in trials[0]:
            raise SystemExit(f"chip_smoke: CLI hyper trials {trials}")
        for f in ("results.json", "best_config.json", os.path.join("best_model",
                                                                   "params.msgpack")):
            if not os.path.exists(os.path.join(tmp, "tuning", f)):
                raise SystemExit(f"chip_smoke: CLI hyper wrote no {f}")
        res["hyper_trials"] = trials
    for name, (secs, _) in done.items():
        print(f"phase 11b: CLI {name}: {secs:.1f} s wall (host clock, process start included)")
    print(f"phase 11b: eval-struct peaks vs in-process (rounded to 0.01): "
          f"{json.dumps({k: res[k] for k in ('plain.csv', 'exact.csv', 'fast.csv', 'big.csv')})}"
          f"; --profile trace {res['profile_bytes']} bytes with the MP kernel; "
          f"{res['tensorboard_events']} tfevents read back; eval-tfrecords (banded) vs the "
          f"plain gather forward max |diff| {res['eval_tfrecords_max_diff']:.2e}")
    for t in res["hyper_trials"]:
        print(f"phase 11b: hyper {t}")
    return res


# -- phase 12: atom-partitioned serving over ranks sharing the card -------------------


def _part_check_kernels(par, banded, plan, own, s, params, cfg, cheb, dev) -> dict:
    """B7a, B7b and B6 at this shard's shapes of ``plan`` against their
    plain versions (outside the counted forwards): the interior and halo
    bands of B7a and B7b bit for bit, B6 over both bands within phase 3's
    MP tolerances (float32 rtol/atol 2e-4; bfloat16 rtol one step, atol two
    steps of the output's scale); B6 and the builds timed (CUDA events),
    B6 beside its plain version and the dense-band torch.bmm yardstick."""
    import torch

    from nmrgnn_tpu_torch.models.gnn import edge_features

    m, B, W, Wh = plan.halo.rows_per_shard, plan.block_rows, plan.window, plan.halo_window
    _, lnl, lo, bids, hlo = par.halo.shard_arrays(plan, s, dev)
    edges = own.edges
    rows = (bids.long()[:, None] * B + torch.arange(B, device=dev)[None, :]).reshape(-1)
    lnl_h, edges_h = lnl[rows] - m, edges[rows].contiguous()
    e = edge_features(params, cfg.replace(compute_dtype="float32"), edges)
    e_h = e[rows].contiguous()
    F, E = cfg.atom_feature_size, cfg.edge_feature_size
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        pairs = {
            "B7a interior": (banded.build_band_tracedlo(lnl, e, lo, W, B, dt),
                             banded.build_band_tracedlo_plain(lnl, e, lo, W, B, dt)),
            "B7a halo": (banded.build_band_tracedlo(lnl_h, e_h, hlo, Wh, B, dt),
                         banded.build_band_tracedlo_plain(lnl_h, e_h, hlo, Wh, B, dt)),
            "B7b interior": (banded.build_band_poly_tracedlo(lnl, edges, cheb, lo, W, B, dt),
                             banded.build_band_poly_tracedlo_plain(lnl, edges, cheb, lo, W, B,
                                                                   dt)),
            "B7b halo": (banded.build_band_poly_tracedlo(lnl_h, edges_h, cheb, hlo, Wh, B, dt),
                         banded.build_band_poly_tracedlo_plain(lnl_h, edges_h, cheb, hlo, Wh,
                                                               B, dt)),
        }
        for name, (got, want) in pairs.items():
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} {tag}: kernel != plain")
            out[f"{name} {tag}"] = "bit for bit"
        gen = torch.Generator(device=dev).manual_seed(s)
        table = torch.randn((m, F), device=dev, generator=gen).to(dt)
        halo = torch.randn((plan.halo_lanes, F), device=dev, generator=gen).to(dt)
        w = torch.randn((F, F, E), device=dev, generator=gen) / F ** 0.5
        M_int, M_halo = pairs["B7a interior"][0], pairs["B7a halo"][0]
        occ = banded.band_occupancy(lnl, edges, lo, W, B, m)
        occ_h = banded.band_occupancy(lnl_h, edges_h, hlo, Wh, B, rows.shape[0])
        for name, (M, lo_, tab, oc) in {"B6 interior": (M_int, lo, table, occ),
                                        "B6 halo": (M_halo, hlo, halo, occ_h)}.items():
            got = banded.mp_banded_partial(M, lo_, tab, w, oc)
            want = banded.mp_banded_partial_plain(M, lo_, tab, w, oc)
            diff = (got - want).abs()
            if dt == torch.float32:
                bad = diff > 2e-4 + 2e-4 * want.abs()
            else:
                step = 2.0 ** -7
                bad = diff > 2 * step * float(want.abs().max()) + step * want.abs()
            if not torch.isfinite(got).all() or bool(bad.any()):
                raise RuntimeError(f"{name} {tag}: max |kernel - plain| {float(diff.max()):.3e}")
            out[f"{name} {tag}"] = float(diff.max())
        T = M_int.shape[0]
        win = torch.stack([table[a:a + W] for a in lo.tolist()])
        # B6's bound on the interior band: its nonzeros and the second
        # product; the occupied chunks, the occupancy and lo, the table,
        # the weights and the float32 output moved once
        eb = 4 if dt == torch.float32 else 2
        row_chunks = int(banded.occupancy_bits(occ, W).sum())
        bound_ms, bound_by = _bound(
            2 * int((M_int != 0).sum()) * F + 2 * T * E * B * F * F,
            row_chunks * 16 * E * eb + occ.numel() * 4 + T * 4 + m * F * eb + F * F * E * eb
            + T * B * F * 4,
            PEAK_F32_FLOPS if dt == torch.float32 else PEAK_BF16_FLOPS)
        out[f"bound {tag}"] = {"B6": bound_ms, "by": bound_by}
        out[f"ms {tag}"] = {
            "B6": _time_ms(lambda: banded.mp_banded_partial(M_int, lo, table, w, occ), 5),
            "B6 plain": _time_ms(lambda: banded.mp_banded_partial_plain(M_int, lo, table, w,
                                                                        occ), 3, 2),
            "B6 bmm yardstick": _time_ms(lambda: torch.bmm(M_int.view(T, E * B, W), win), 5),
            "B7a": _time_ms(lambda: banded.build_band_tracedlo(lnl, e, lo, W, B, dt), 5),
            "B7b": _time_ms(lambda: banded.build_band_poly_tracedlo(lnl, edges, cheb, lo, W,
                                                                    B, dt), 5),
        }
    out["shapes"] = {"m": m, "T": int(lo.shape[0]), "Tb": int(bids.shape[0]), "B": B, "W": W,
                     "Wh": Wh, "halo_lanes": plan.halo_lanes, "F": F, "E": E}
    return out


def _part_serve(task, case, mesh, dev) -> dict:
    """One phase 12 serving task in one rank: ServingModel(mesh=...) over
    the task's frames with every ``*_plain`` function counted (none may
    run), the launches a frame, then the forward's time (CUDA events),
    the exchange's host time, the halo volumes and, where asked, the
    kernels against their plain versions at the shard's shapes."""
    import torch
    import torch.distributed as dist

    from nmrgnn_tpu_torch import parallel as par
    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.data.embeddings import load_standards
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.library import load_model
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import banded

    if task["model"] == "baseline":
        params, cfg = load_model(device=dev)
    else:
        cfg = ModelConfig(**task["config"])
        params = gnn.init_params(cfg, torch.Generator().manual_seed(task["seed"]),
                                 load_standards(), device=dev)
    graphs = [Graph(*g) for g in case["graphs"][task["graphs"]]]
    sm = ServingModel(params, cfg, device=dev, precision=task["precision"], mesh=mesh)
    res = {"peaks": [], "launches": []}
    with _PlainCalls() as plain:
        for g in graphs:
            _reset_counts()
            res["peaks"].append(sm.predict(g))
            torch.cuda.synchronize()
            res["launches"].append({f.__name__: f.launches for f in _wrappers() if f.launches})
    res["plain_calls"] = dict(plain.calls)
    plan, is_banded, arrays = sm._part_plan
    res["path"] = "banded" if is_banded else "halo-gather"
    base = plan.halo if is_banded else plan
    F = cfg.atom_feature_size
    rep = par.halo_comm_report(base, F, 2 if sm.config.compute_dtype == "bfloat16" else 4)
    res["comm"] = rep.as_dict()
    # the last frame, whose plan is the cached one
    gp = par.pad_to_multiple(sm._permute_host(graphs[-1]), base.n_shards * 128)
    fwd = par.apply_partitioned_banded if is_banded else par.apply_partitioned_halo
    cheb = sm._edge_cheb() if (is_banded and task["precision"] == "fast"
                               and cfg.mp_type != "attention") else None
    kw = dict(cheb=cheb) if is_banded else {}
    call = lambda: fwd(sm.params, sm.config, gp, plan, mesh, arrays=arrays, **kw)  # noqa: E731
    if task.get("plain") and is_banded:  # the last frame through the plain versions
        plain_fwd = fwd(sm.params, sm.config, gp, plan, mesh, arrays=arrays, use_kernels=False,
                        **kw)
        res["peaks_plain"] = plain_fwd.cpu().numpy()[:graphs[-1].atoms.shape[0]][sm._inverse]
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    dist.barrier(group=mesh.group("graph"))
    times = []
    for _ in range(task.get("repeats", 5)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    res["forward_ms"] = float(np.median(times))
    s = mesh.index("graph")
    send = arrays[0]
    table = torch.zeros((base.rows_per_shard, F), device=dev)
    ex = []
    for _ in range(10):
        t0 = time.perf_counter()
        par.ring_exchange(table, send, base.offsets, mesh.group("graph")).wait()
        ex.append((time.perf_counter() - t0) * 1e3)
    res["exchange_host_ms"] = float(np.median(ex))
    if task.get("kernels"):
        own = par.halo._own(gp, s, base.rows_per_shard, dev)
        c = sm._edge_cheb() if cfg.mp_type != "attention" else None
        if c is None:
            from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev

            c = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low,
                                   rbf_high=cfg.rbf_high, rbf_count=cfg.edge_hidden_size,
                                   activation=cfg.fc_activation, degree=64)
            c = c._replace(coeffs=torch.as_tensor(c.coeffs, device=dev))
        res["kernels"] = _part_check_kernels(par, banded, plan, own, s, params, cfg, c, dev)
    return res


def _partition_rank(rank, world, init, case_path, out_dir) -> None:
    """A phase 12 or 13 rank: the process group at ``init`` (gloo: the ranks
    share the card), a (1, world) mesh, the case's tasks (phase 13's on
    meshes of their own); its results in
    ``out_dir/rank<r>.pkl``, a failure's traceback in ``rank<r>.err``."""
    import pickle
    import traceback

    try:
        import torch

        from nmrgnn_tpu_torch import parallel as par

        with open(case_path, "rb") as f:
            case = pickle.load(f)
        torch.backends.cuda.matmul.allow_tf32 = False
        par.initialize_distributed(init, rank=rank, world_size=world, timeout_s=300)
        mesh = par.make_mesh(1, world)
        dev = torch.device("cuda", torch.cuda.current_device())
        results = [_part_train(t, case, dev) if t.get("kind") else
                   _part_serve(t, case, mesh, dev) for t in case["tasks"]]
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def _run_ranks(world: int, case: dict, tmp: str, timeout: float = 600) -> list:
    """Spawn ``world`` phase 12 or 13 ranks on ``case`` and return their results;
    fail when a rank fails or the time runs out (every rank is ended)."""
    import multiprocessing as mp
    import pickle

    case_path = os.path.join(tmp, f"case{world}.pkl")
    out_dir = os.path.join(tmp, f"out{world}")
    os.makedirs(out_dir, exist_ok=True)
    with open(case_path, "wb") as f:
        pickle.dump(case, f)
    init = "file://" + os.path.join(tmp, f"init{world}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_partition_rank, args=(r, world, init, case_path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(out_dir, f"rank{r}.err")
        if p.exitcode != 0:
            errors.append(f"rank {r} exited {p.exitcode}:\n"
                          + (open(err).read()[-3000:] if os.path.exists(err) else ""))
    if errors:
        raise SystemExit("chip_smoke: rank failure\n" + "\n".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _ms_list(times) -> str:
    return ", ".join(f"{t:.3f}" for t in times)


def _phase12(args, dev, params, cfg, small, large) -> dict:
    """Atom-partitioned serving over gloo ranks sharing the card (see the
    module's docstring, phase 12)."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.data.embeddings import load_standards
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.serving import ServingModel

    acfg = ModelConfig(mp_type="attention")
    aparams = gnn.init_params(acfg, torch.Generator().manual_seed(args.seed), load_standards(),
                              device=dev)
    graphs = small["graphs"]
    single = {
        "exact": small["peaks"],
        "fast": [ServingModel(params, cfg, device=dev, precision="fast").predict(g)
                 for g in graphs],
        "attention": [ServingModel(aparams, acfg, device=dev).predict(g) for g in graphs],
    }
    big = large["graph"]
    single_big = {p: ServingModel(params, cfg, device=dev, precision=p).predict(big)
                  for p in ("exact", "fast")}
    acfg_kw = dataclasses.asdict(acfg)
    tasks2 = [dict(model="baseline", precision="exact", graphs="small", kernels=True),
              dict(model="baseline", precision="fast", graphs="small", plain=True),
              dict(model="attention", config=acfg_kw, seed=args.seed, precision="exact",
                   graphs="small")]
    tasks4 = [dict(model="baseline", precision=p, graphs="big", repeats=3)
              for p in ("exact", "fast")]
    case = {"graphs": {"small": [tuple(g) for g in graphs], "big": [tuple(big)]}}
    out, res = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        r2 = _run_ranks(2, dict(case, tasks=tasks2), tmp)
        out["ranks2_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r4 = _run_ranks(4, dict(case, tasks=tasks4), tmp)
        out["ranks4_s"] = time.perf_counter() - t0

        # (c) the CLI under torchrun, two processes on the card
        pdb = os.path.join(tmp, "synthetic.pdb")
        write_synthetic_pdb(pdb, n_atoms=N_ATOMS, seed=args.seed, frames=N_FRAMES)
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "nmrgnn_tpu_torch.cli", "eval-struct", pdb,
             os.path.join(tmp, "gp.csv"), "--graph-parallel", "2"],
            capture_output=True, text=True, cwd=root, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])))
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0 or "graph-parallel serving: mesh" not in proc.stdout:
            raise SystemExit(f"chip_smoke: 12c torchrun eval-struct exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        backend = [ln for ln in proc.stderr.splitlines() if "backend" in ln]
        rows = _read_rows(os.path.join(tmp, "gp.csv"))[1]

    # (a) the 2,482-atom frames at D = 2
    names = ("exact", "fast", "attention")
    want_launches = {"exact": {"build_band_tracedlo": 2, "mp_banded_partial": 8},
                     "fast": {"build_band_poly_tracedlo": 2, "mp_banded_partial": 8},
                     "attention": {"build_band_tracedlo": 8, "mp_banded_partial": 8}}
    for i, name in enumerate(names):
        recs = [r[i] for r in r2]
        for r in recs[1:]:
            for a, b in zip(r["peaks"], recs[0]["peaks"]):
                if not np.array_equal(a, b):
                    raise SystemExit(f"chip_smoke: 12a {name}: the ranks' peaks differ")
        for rank, rec in enumerate(recs):
            if rec["plain_calls"] or rec["path"] != "banded":
                raise SystemExit(f"chip_smoke: 12a {name} rank {rank}: path {rec['path']}, "
                                 f"plain calls {rec['plain_calls']}")
            for f, got in enumerate(rec["launches"]):
                need = want_launches[name]
                if any(got.get(k) != v for k, v in need.items()):
                    raise SystemExit(f"chip_smoke: 12a {name} rank {rank} frame {f}: launches "
                                     f"{got}, need {need}")
        agree = []
        for f, (p, q) in enumerate(zip(recs[0]["peaks"], single[name])):
            if not np.all(np.isfinite(p)):
                raise SystemExit(f"chip_smoke: 12a {name} frame {f}: non-finite peaks")
            if name == "exact":
                err = float(np.abs(p - q).max())
                if not np.allclose(p, q, rtol=5e-4, atol=5e-4):
                    raise SystemExit(f"chip_smoke: 12a exact frame {f}: max |2 ranks - one "
                                     f"card| {err:.3e}")
                agree.append(f"max |diff| {err:.3e} (rtol/atol 5e-4)")
            elif name == "fast":
                # the partitioned forward keeps its node state in float32 between the
                # layers (nmrgnn_tpu/parallel/halo.py:646, 704), the one-card fast forward
                # in bfloat16: held to the exact peaks' fast band and, on the last frame,
                # within a mean 0.05 ppm of its own plain versions on the card
                agree.append(_in_fast_band(p, single["exact"][f], f"12a fast frame {f}"))
                ex = float(np.abs(p - single["exact"][f]).mean())
                one = float(np.abs(q - single["exact"][f]).mean())
                fast_gap = float(np.abs(p - q).mean())
                agree[-1] += (f"; mean |diff| from one card's fast {fast_gap:.4f} ppm; from "
                              f"exact {ex:.4f} ppm (one card's fast: {one:.4f})")
                if f == len(graphs) - 1:
                    mean = float(np.abs(p - recs[0]["peaks_plain"]).mean())
                    if mean >= 0.05:
                        raise SystemExit(f"chip_smoke: 12a fast: mean |kernels - plain| "
                                         f"{mean:.4f} ppm >= 0.05")
                    agree[-1] += f"; mean |kernels - plain versions| {mean:.2e} ppm"
            else:
                r = _pearson(p, q)
                mean = float(np.abs(p - q).mean())
                if r <= 0.9999 or mean >= 1.0:
                    raise SystemExit(f"chip_smoke: 12a attention frame {f}: r {r:.6f}, mean "
                                     f"|diff| {mean:.4f} ppm")
                agree.append(f"r {r:.7f}, mean |diff| {mean:.2e} ppm, max "
                             f"{float(np.abs(p - q).max()):.2e}")
        res[name] = {
            "launches_a_frame": [r["launches"][0] for r in recs],
            "forward_ms": [r["forward_ms"] for r in recs],
            "exchange_host_ms": [r["exchange_host_ms"] for r in recs],
            "comm": recs[0]["comm"], "agree": agree,
        }
        c = recs[0]["comm"]
        print(f"phase 12a: D=2 {name}: path partitioned/{recs[0]['path']}, launches a forward "
              f"by rank {res[name]['launches_a_frame']}, no plain version called; forward "
              f"{_ms_list(res[name]['forward_ms'])} ms a rank (median, "
              f"CUDA events), exchange {_ms_list(res[name]['exchange_host_ms'])} "
              f"ms (host clock, post to received); halo {c['halo_rows_padded']} rows "
              f"({c['halo_rows_unique']} distinct) = {c['halo_bytes']} B a layer a shard vs "
              f"all-gather {c['allgather_bytes']} B; vs one card: {agree[-1]}")
    kern = r2[0][0]["kernels"]
    res["kernels"] = kern
    print(f"phase 12a: rank 0's B7a, B7b (bit for bit) and B6 (max |kernel - plain| "
          f"{json.dumps({k: v for k, v in kern.items() if k.startswith('B6')})}) at the shard's "
          f"shapes; ms {json.dumps({k: v for k, v in kern.items() if k.startswith('ms')})}; "
          f"B6 bound {json.dumps({k: v for k, v in kern.items() if k.startswith('bound')})}; "
          f"shapes {json.dumps(kern['shapes'])}")

    # (b) 44,676 atoms at D = 4: the path the rule picks
    for i, p in enumerate(("exact", "fast")):
        recs = [r[i] for r in r4]
        got, ref = recs[0]["peaks"][0], single_big[p]
        if any(r["plain_calls"] and r["path"] == "banded" for r in recs):
            raise SystemExit(f"chip_smoke: 12b {p}: plain calls on the kernel path")
        if p == "exact":
            err = float(np.abs(got - ref).max())
            if not np.allclose(got, ref, rtol=5e-4, atol=5e-4):
                raise SystemExit(f"chip_smoke: 12b exact: max |4 ranks - one card| {err:.3e}")
            agree = f"max |diff| {err:.3e} (rtol/atol 5e-4)"
        else:
            agree = _in_fast_band(got, single_big["exact"], "12b fast")
        res[f"supercell_{p}"] = {"path": recs[0]["path"], "forward_ms": [r["forward_ms"]
                                                                         for r in recs],
                                 "exchange_host_ms": [r["exchange_host_ms"] for r in recs],
                                 "launches": recs[0]["launches"][0], "comm": recs[0]["comm"],
                                 "agree": agree}
        c = recs[0]["comm"]
        print(f"phase 12b: D=4 {len(got)} atoms {p}: the rule picks {recs[0]['path']}; "
              f"launches by rank {[r['launches'][0] for r in recs]}; forward "
              f"{_ms_list(res[f'supercell_{p}']['forward_ms'])} ms a rank, "
              f"exchange {_ms_list(res[f'supercell_{p}']['exchange_host_ms'])} "
              f"ms; halo {c['halo_rows_padded']} rows = {c['halo_bytes']} B a layer a shard; vs "
              f"one card: {agree}")

    # (c) the CLI's output against the single-card exact peaks
    peaks = np.array([float(r[4]) for r in rows])
    frames = np.array([int(r[7]) for r in rows])
    worst = max(float(np.abs(peaks[frames == f] - np.round(small["peaks"][f], 2)).max())
                for f in range(N_FRAMES))
    if worst > 0.01 + 1e-6:
        raise SystemExit(f"chip_smoke: 12c eval-struct --graph-parallel 2: max |csv - one card| "
                         f"{worst:.3f} > 0.01")
    res["cli"] = {"wall_s": cli_s, "backend": backend, "max_csv_diff": worst}
    print(f"phase 12c: torchrun --nproc-per-node 2 eval-struct --graph-parallel 2: {cli_s:.1f} s "
          f"wall (host clock); {backend[0] if backend else 'no backend line'}; CSV vs one card's "
          f"exact peaks max |diff| {worst:.3f} (the file rounds to 0.01)")
    res.update(out)
    return res


# -- phase 13: partitioned and multi-GPU training over ranks sharing the card -------------


def _leaves_np(leaves, grad: bool = False) -> list:
    return [np.array((t.grad if grad else t).detach().float().cpu()) for t in leaves]


def _step_ms(step, repeats: int = 5, warmup: int = 2) -> float:
    """The median of ``repeats`` calls of ``step`` (CUDA events), after
    ``warmup`` calls: every rank calls it alike."""
    import torch

    for _ in range(warmup):
        step()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _exchange_ms(par, prep, F: int, group, dev, runs: int = 10) -> dict:
    """The halo exchange's host time (post to received rows on the card),
    forward and backward (the reverse ring and the index_add into the
    nodes' cotangent), the median of ``runs``."""
    import torch

    plan = prep.plan
    send = prep.arrays[0]
    fwd, bwd = [], []
    for _ in range(runs):
        x = torch.randn((plan.halo.rows_per_shard, F), device=dev, requires_grad=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = par.ring_exchange(x, send, plan.halo.offsets, group, lanes=plan.halo_lanes).wait()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(r, x, torch.ones_like(r))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((t2 - t1) * 1e3)
    return {"forward": float(np.median(fwd)), "backward": float(np.median(bwd))}


def _part_train(task, case, dev) -> dict:
    """One phase 13 task in one rank, on the task's own (data, graph) mesh
    (see the module's docstring, phase 13)."""
    import torch

    from nmrgnn_tpu_torch import parallel as par
    from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
    from nmrgnn_tpu_torch.data.dataset import Sample
    from nmrgnn_tpu_torch.data.embeddings import load_standards
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.parallel import sharding
    from nmrgnn_tpu_torch.train import PartitionedTrainer, Trainer
    from nmrgnn_tpu_torch.train.trainer import TrainState, adam

    mesh = par.make_mesh(task["data"], task["graph"])
    cfg = ModelConfig(**task["config"])
    params = gnn.init_params(cfg, torch.Generator().manual_seed(task["seed"]), load_standards(),
                             device=dev)
    lr, kind, res = task["lr"], task["kind"], {}
    if kind == "partitioned":
        samples = [Sample(Graph(*g), y, w) for g, y, w in case[task["frames"]]]
        tr = PartitionedTrainer(cfg, TrainConfig(seed=task["seed"]), mesh=mesh, device=dev)
        t0 = time.perf_counter()
        prep = tr.prepare(samples[0])
        res["prepare_s"] = time.perf_counter() - t0
        leaves = gnn.trainable_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        # the differentiable forward alone: its launches, no plain version
        _reset_counts()
        with _PlainCalls() as plain:
            peaks = par.apply_partitioned_banded(params, cfg, prep.graph, prep.plan, mesh,
                                                 differentiable=True, arrays=prep.arrays)
        torch.cuda.synchronize()
        res["forward_launches"] = {f.__name__: f.launches for f in _wrappers() if f.launches}
        res["plain_calls"] = dict(plain.calls)
        del peaks
        opt = adam(TrainState(params=params, opt_state={}, lr=lr))
        step = tr._train_step(prep)
        _reset_counts()
        with _PlainCalls() as plain:
            loss = step(params, opt, prep.graph, prep.y, prep.w, arrays=prep.arrays)
        torch.cuda.synchronize()
        res["step_launches"] = {f.__name__: f.launches for f in _wrappers() if f.launches}
        res["step_plain_calls"], res["step_vjp"] = dict(plain.calls), plain.vjp
        res["loss"] = float(loss)
        if mesh.rank == 0:
            res["grads"] = _leaves_np(leaves, grad=True)
            res["params"] = _leaves_np(leaves)
        res["finite"] = bool(np.isfinite(res["loss"]) and all(
            bool(torch.isfinite(t.grad).all()) for t in leaves))
        res["step_ms"] = _step_ms(lambda: step(params, opt, prep.graph, prep.y, prep.w,
                                               arrays=prep.arrays), task.get("repeats", 5))
        res["exchange_host_ms"] = _exchange_ms(par, prep, cfg.atom_feature_size,
                                               mesh.group("graph"), dev)
        res["halo"] = {"rows_a_layer": prep.plan.halo.halo_rows,
                       "rows_per_shard": prep.plan.halo.rows_per_shard,
                       "offsets": list(prep.plan.halo.offsets),
                       "n_padded": int(prep.graph.atoms.shape[0])}
        if task.get("fit"):
            fcfg = ModelConfig(**task["fit_config"])
            ftr = PartitionedTrainer(fcfg, TrainConfig(epochs=2, seed=task["seed"]), mesh=mesh,
                                     device=dev)
            t0 = time.perf_counter()
            st = ftr.fit(samples, samples[:1], verbose=False)
            torch.cuda.synchronize()
            res["fit"] = {"s": time.perf_counter() - t0, "history": st.history}
        return res
    # 13c and 13d: the fragment Trainer on a mesh, one step
    tcfg = TrainConfig(**task["tcfg"])
    tr = Trainer(cfg, tcfg, device=dev, mesh=mesh, tensor_parallel=task.get("tp", False))
    state = TrainState(params=tr._local(params), opt_state={}, lr=lr)
    opt = adam(state)
    graph, y, w = tr._to_device(*case["batch"])
    gen = torch.Generator(device=dev).manual_seed(task["seed"] + 2)
    _reset_counts()
    loss = tr.train_step(state, opt, graph, y, w, gen)
    torch.cuda.synchronize()
    res["launches"] = {f.__name__: f.launches for f in _wrappers() if f.launches}
    res["loss"], res["banded"] = float(loss), tr.use_banded
    grads = gnn.tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
                         state.params)
    if tr._specs is not None:  # the whole gradients and weights from the slices
        grads = sharding.unshard_params(grads, tr._specs, mesh)
        whole = sharding.unshard_params(state.params, tr._specs, mesh)
    else:
        whole = state.params
    if mesh.rank == 0:
        res["grads"] = _leaves_np(gnn.trainable_leaves(grads))
        res["params"] = _leaves_np(gnn.trainable_leaves(whole))
    res["step_ms"] = _step_ms(lambda: tr.train_step(state, opt, graph, y, w, gen))
    return res


def _gate_step(name: str, got: dict, loss: float, grads, params, lr: float) -> dict:
    """A parallel step against the same step on one card: loss rel 1e-5,
    each gradient leaf within 1e-3 of its largest (phase 9's gate), and the
    Adam-updated weights within rtol 2e-3 / atol 2e-5 wherever the one-card
    gradient fixes the step's sign: past 1e-3 of the leaf's largest, or past
    twice the leaf's measured gradient error (and 1e-6, a hundred times
    Adam's eps). Adam's first step moves every weight by lr times the sign
    of its gradient, so where a gradient of rounding size may flip sign the
    weights can differ by up to 2 lr whatever the step did; only the
    gradient gate covers those weights (``unresolved`` counts them)."""
    rel = abs(got["loss"] - loss) / abs(loss)
    if not np.isfinite(got["loss"]) or rel > 1e-5:
        raise SystemExit(f"chip_smoke: {name}: loss {got['loss']} vs one card {loss}")
    worst, unresolved = 0.0, 0
    for i, (g, want) in enumerate(zip(got["grads"], grads)):
        scale = float(np.abs(want).max())
        err = float(np.abs(g - want).max())
        if not np.all(np.isfinite(g)) or err > 1e-3 * scale:
            raise SystemExit(f"chip_smoke: {name}: gradient leaf {i} {want.shape}: max |diff| "
                             f"{err:.3e} > 1e-3 x {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
        mag = np.abs(want)
        resolved = (mag > 1e-3 * scale) | ((mag > 2 * err) & (mag > 1e-6))
        unresolved += int((~resolved).sum())
        d = np.abs(got["params"][i] - params[i])
        bad = resolved & (d > 2e-5 + 2e-3 * np.abs(params[i]))
        if bad.any():
            raise SystemExit(f"chip_smoke: {name}: weights leaf {i} {want.shape}: max |diff| "
                             f"{float(d[bad].max()):.3e} where the gradient fixes the step")
    return {"loss_rel_err": rel, "grad_max_rel_err": worst, "unresolved": unresolved}


def _phase13(args, dev, small, large) -> dict:
    """Partitioned and multi-GPU training over gloo ranks sharing the card
    (see the module's docstring, phase 13)."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
    from nmrgnn_tpu_torch.data.dataset import batch_samples, read_fragments
    from nmrgnn_tpu_torch.data.embeddings import load_standards
    from nmrgnn_tpu_torch.data.fragment import write_structure_fragments
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.library import load_model
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.train import Trainer
    from nmrgnn_tpu_torch.train.losses import name_loss
    from nmrgnn_tpu_torch.train.trainer import TrainState, adam, fold_sample_weight

    seed, lr = args.seed, 1e-3
    rng = np.random.default_rng(seed + 13)

    def labelled(g):
        n = g.atoms.shape[0]
        y = np.stack([rng.normal(size=n).astype(np.float32) * 3,
                      rng.integers(0, 6, n).astype(np.float32), np.ones(n, np.float32)], -1)
        return tuple(np.asarray(a) for a in g), y, np.ones(n, np.float32)

    frames = [labelled(g) for g in small["graphs"]]
    big = [labelled(large["graph"])]
    exact = dataclasses.asdict(ModelConfig(noise=0.0, dropout=False))
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "synthetic.pdb")
        write_synthetic_pdb(pdb, n_atoms=N_ATOMS, seed=seed, frames=N_FRAMES)
        records = os.path.join(tmp, "fragments.tfrecord")
        write_structure_fragments(records, read_structure(pdb), fragment_size=256)
        batch = batch_samples(list(read_fragments(records))[:8], 256)

    # the one-card references
    ref = {}
    cfg0 = ModelConfig(**exact)
    p = gnn.init_params(cfg0, torch.Generator().manual_seed(seed), load_standards(), device=dev)
    leaves = gnn.trainable_leaves(p)
    opt = adam(TrainState(params=p, opt_state={}, lr=lr))
    (atoms, nlist, edges, inv), y, w = frames[0]
    gt = Graph(*[torch.as_tensor(a).to(dev) for a in (atoms, nlist, edges, inv)])
    loss_idx = Trainer(cfg0, device=dev).loss_idx
    loss = name_loss(fold_sample_weight(torch.as_tensor(y, device=dev),
                                        torch.as_tensor(w, device=dev)),
                     gnn.apply(p, cfg0, gt), loss_idx)
    grads = torch.autograd.grad(loss, leaves)
    for t, g in zip(leaves, grads):
        t.grad = g
    opt.step()
    ref["partitioned"] = (float(loss.detach()), [g.cpu().numpy() for g in grads],
                          _leaves_np(leaves))
    cfg = ModelConfig()  # noise and dropout on
    for name, path in (("dp", "banded"), ("tp", "gather")):
        tcfg = TrainConfig(batch_size=8, pad_to=256, mp_path=path, seed=seed)
        tr = Trainer(cfg, tcfg, device=dev)
        st = TrainState(params=gnn.init_params(cfg, torch.Generator().manual_seed(seed),
                                               load_standards(), device=dev),
                        opt_state={}, lr=lr)
        o = adam(st)
        graph, yb, wb = tr._to_device(*batch)
        loss = tr.train_step(st, o, graph, yb, wb,
                             torch.Generator(device=dev).manual_seed(seed + 2))
        ls = gnn.trainable_leaves(st.params)
        ref[name] = (float(loss), _leaves_np(ls, grad=True), _leaves_np(ls))
    torch.cuda.synchronize()

    part = dict(kind="partitioned", data=1, config=exact, seed=seed, lr=lr)
    tasks2 = [dict(part, graph=2, frames="small", fit=True,
                   fit_config=dataclasses.asdict(ModelConfig())),
              dict(kind="trainer", data=2, graph=1, config=dataclasses.asdict(cfg), seed=seed,
                   lr=lr, tcfg=dict(batch_size=8, pad_to=256, mp_path="banded", seed=seed)),
              dict(kind="trainer", data=1, graph=2, tp=True, config=dataclasses.asdict(cfg),
                   seed=seed, lr=lr,
                   tcfg=dict(batch_size=8, pad_to=256, mp_path="gather", seed=seed))]
    tasks4 = [dict(part, graph=4, frames="big", repeats=3)]
    case = {"small": frames, "big": big, "batch": batch}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        r2 = _run_ranks(2, dict(case, tasks=tasks2), tmp)
        out["ranks2_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r4 = _run_ranks(4, dict(case, tasks=tasks4), tmp)
        out["ranks4_s"] = time.perf_counter() - t0

        # (e) train --graph-parallel 2 under torchrun
        pdb = os.path.join(tmp, "synthetic.pdb")
        write_synthetic_pdb(pdb, n_atoms=N_ATOMS, seed=seed, frames=N_FRAMES)
        rec = os.path.join(tmp, "struct.tfrecord")
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
        subprocess.run([sys.executable, "-m", "nmrgnn_tpu_torch.cli", "make-struct-records",
                        pdb, rec], check=True, capture_output=True, cwd=root, env=env,
                       timeout=300)
        model = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "nmrgnn_tpu_torch.cli", "train", rec, model, "1", "--graph-parallel",
             "2", "--validation", "0.34", "--checkpoint-path", os.path.join(tmp, "ckpt")],
            capture_output=True, text=True, cwd=root, timeout=300, env=env)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0 or "graph-parallel training: mesh" not in proc.stdout:
            raise SystemExit(f"chip_smoke: 13e torchrun train exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        loaded, lcfg = load_model(model, device=dev)
        if not all(bool(torch.isfinite(t).all()) for t in gnn.tree_leaves(loaded)):
            raise SystemExit("chip_smoke: 13e the saved model holds non-finite weights")
        epoch_line = [ln for ln in proc.stdout.splitlines() if ln.startswith("epoch 1:")]

    # (a) 2,482 atoms at D = 2
    a = [r[0] for r in r2]
    need = {"build_band_tracedlo": 2, "mp_banded_partial": 8, "band_occupancy": 2}
    for rank, rec_ in enumerate(a):
        if rec_["plain_calls"] or any(rec_["forward_launches"].get(k) != v
                                      for k, v in need.items()):
            raise SystemExit(f"chip_smoke: 13a rank {rank}: launches "
                             f"{rec_['forward_launches']}, need {need}; plain calls "
                             f"{rec_['plain_calls']}")
        if rec_["step_plain_calls"] or any(rec_["step_launches"].get(k) != v
                                           for k, v in need.items()):
            raise SystemExit(f"chip_smoke: 13a rank {rank} step: launches "
                             f"{rec_['step_launches']}, plain calls {rec_['step_plain_calls']}")
        if rec_["loss"] != a[0]["loss"]:
            raise SystemExit("chip_smoke: 13a the ranks' losses differ")
        hist = rec_["fit"]["history"]
        if not all(np.all(np.isfinite(v)) for v in hist.values()) or len(hist["loss"]) != 2:
            raise SystemExit(f"chip_smoke: 13a fit: {hist}")
    res = {"a": {"gate": _gate_step("13a", a[0], *ref["partitioned"], lr)}}
    res["a"].update({k: [r[k] for r in a] for k in ("step_ms", "exchange_host_ms")})
    res["a"].update({k: a[0][k] for k in ("step_launches", "halo", "prepare_s", "fit")})
    res["a"]["fit"]["history"] = {k: [float(x) for x in v]
                                  for k, v in a[0]["fit"]["history"].items()}
    print(f"phase 13a: D=2 whole-structure training, {a[0]['halo']['n_padded']} rows "
          f"({a[0]['halo']['rows_per_shard']} a shard): launches a step by rank "
          f"{[r['step_launches'] for r in a]}, no plain version in the forward (the backward's "
          f"plain recomputations a step: {a[0]['step_vjp']}); vs one card: loss rel "
          f"{res['a']['gate']['loss_rel_err']:.2e}, gradients max |diff| / max |g| "
          f"{res['a']['gate']['grad_max_rel_err']:.2e} (gate 1e-3), weights after Adam within "
          f"the gate ({res['a']['gate']['unresolved']} elements whose gradient may flip sign "
          f"left to the gradient gate)")
    print(f"phase 13a: step {_ms_list(res['a']['step_ms'])} ms a rank (median of 5, CUDA "
          f"events); exchange host ms forward "
          f"{_ms_list([e['forward'] for e in res['a']['exchange_host_ms']])}, backward "
          f"{_ms_list([e['backward'] for e in res['a']['exchange_host_ms']])} (median of 10); "
          f"halo {a[0]['halo']['rows_a_layer']} rows a layer a shard, offsets "
          f"{a[0]['halo']['offsets']}; fit 2 epochs (noise and dropout on) in "
          f"{a[0]['fit']['s']:.2f} s: loss {[round(v, 4) for v in res['a']['fit']['history']['loss']]}")

    # (b) the supercell at D = 4
    b = [r[0] for r in r4]
    if not all(r["finite"] for r in b):
        raise SystemExit("chip_smoke: 13b non-finite loss or gradients")
    res["b"] = {"loss": b[0]["loss"], "step_ms": [r["step_ms"] for r in b],
                "exchange_host_ms": [r["exchange_host_ms"] for r in b], "halo": b[0]["halo"],
                "launches": b[0]["step_launches"], "prepare_s": b[0]["prepare_s"]}
    print(f"phase 13b: D=4 {b[0]['halo']['n_padded']} rows ({b[0]['halo']['rows_per_shard']} a "
          f"shard): loss {b[0]['loss']:.4f}, finite gradients; launches {b[0]['step_launches']}; "
          f"step {_ms_list(res['b']['step_ms'])} ms a rank (median of 3, CUDA events); "
          f"exchange host ms forward "
          f"{_ms_list([e['forward'] for e in res['b']['exchange_host_ms']])}, backward "
          f"{_ms_list([e['backward'] for e in res['b']['exchange_host_ms']])}; halo "
          f"{b[0]['halo']['rows_a_layer']} rows a layer a shard, offsets "
          f"{b[0]['halo']['offsets']}; prepare {b[0]['prepare_s']:.2f} s (host)")

    # (c) data parallel, banded; (d) tensor parallel, gather
    for key, i, name in (("c", 1, "dp"), ("d", 2, "tp")):
        recs = [r[i] for r in r2]
        if name == "dp":
            need = {"build_band": 1, "band_occupancy": 1, "mp_banded": 4}
            for rank, r in enumerate(recs):
                if not r["banded"] or any(r["launches"].get(k) != v for k, v in need.items()):
                    raise SystemExit(f"chip_smoke: 13c rank {rank}: launches {r['launches']}")
        res[key] = {"gate": _gate_step(f"13{key}", recs[0], *ref[name], lr),
                    "launches": recs[0]["launches"], "step_ms": [r["step_ms"] for r in recs]}
        print(f"phase 13{key}: {'data' if name == 'dp' else 'tensor'} parallel on 2 ranks "
              f"({'banded' if name == 'dp' else 'gather'}, 8 x 256, noise and dropout on): "
              f"launches by rank {[r['launches'] for r in recs]}; vs one card: loss rel "
              f"{res[key]['gate']['loss_rel_err']:.2e}, gradients max |diff| / max |g| "
              f"{res[key]['gate']['grad_max_rel_err']:.2e} (gate 1e-3); step "
              f"{_ms_list(res[key]['step_ms'])} ms a rank (median of 5, CUDA events)")
    res["e"] = {"wall_s": cli_s, "epoch": epoch_line[:1], "config": dataclasses.asdict(lcfg)
                == dataclasses.asdict(ModelConfig())}
    print(f"phase 13e: torchrun --nproc-per-node 2 train --graph-parallel 2 (1 epoch, 3 "
          f"records): {cli_s:.1f} s wall (host clock, process start included); "
          f"{epoch_line[0] if epoch_line else 'no epoch line'}; the saved model loads with "
          f"finite weights")
    res.update(out)
    return res


def _phase14(args, dev) -> dict:
    """PaiNN's message kernel at the painn-predict-44676 cell's shapes
    (module docstring, phase 14). Returns its kernel row."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.ops import painn
    from nmrgnn_tpu_torch.ops.activations import get_activation
    from portbench.drivers.predict_loop_xyz import cutoff_graph, supercell
    from portbench.harness import inputs
    from portbench.reference.structures import ANGSTROM_TO_NM, one_hot

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "portbench", "traffic", "predict-44676-r5.json")) as fh:
        t = json.load(fh)
    with open(os.path.join(root, "portbench", "configs", "painn.json")) as fh:
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        cfg = ModelConfig(**{k: v for k, v in json.load(fh).items() if k in fields})
    xyz, elements = supercell(t)
    conf = torch.as_tensor(xyz.astype(np.float32), device=dev)
    g = Graph(*inputs.graph(one_hot(elements), *cutoff_graph(conf, t["neighbors"],
                                                              t["cutoff"])))
    order = rcm_order(g.nlist, g.edges)
    g, _ = permute_graph(g, order, pin_zero=False)
    gt = _on_card(g, dev)
    pos = torch.as_tensor(xyz[order].astype(np.float32) * ANGSTROM_TO_NM, device=dev)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    N, K = g.nlist.shape
    F, L = cfg.atom_feature_size, cfg.mp_layers
    real = int((g.edges > 0).sum())
    print(f"phase 14: PaiNN N={N} K={K} F={F}, {L} blocks, {real} real slots of {N * K}")

    act = get_activation(cfg.mp_activation)
    d, unit = painn.edge_geometry(pos, gt.nlist, gt.edges, cfg.rbf_high)
    filt = painn.filters(params["filter"], d, cfg.edge_hidden_size, cfg.rbf_high)
    w = filt[..., 3 * F:6 * F]  # the second block's columns, in place
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    s = torch.randn((N, F), generator=gen, device=dev)
    v = torch.randn((N, 3, F), generator=gen, device=dev)
    p = params["mp"][1]
    ctx = painn.context(p, s, act, gnn.dense)

    def kernel():
        return painn.message(p, s, v, w, unit, gt.nlist, gt.edges, act, gnn.dense)

    def plain():
        return painn.message_sums_plain(s, v, painn.context(p, s, act, gnn.dense), w, unit,
                                        gt.nlist)

    got = kernel()
    want = painn.message_sums_plain(s, v, ctx, w, unit, gt.nlist)
    mags = painn.message_sums_plain(s.abs(), v.abs(), ctx.abs(), w.abs(), unit.abs(), gt.nlist)
    ratio = 0.0
    for a, b, m in zip(got, want, mags):
        tol = 2 * (2 * K + 2) * 2.0 ** -24 * m
        if not torch.all((a - b).abs() <= tol):
            raise SystemExit("chip_smoke: painn_message outside its bound of the plain version")
        ratio = max(ratio, float(((a - b).abs() / tol.clamp_min(1e-30)).max()))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    del got, want, mags
    ms, plain_ms = _time_ms(kernel, 10), _time_ms(plain, 3, 2)
    alone_ms = _kernel_device_ms(kernel, "painn_message_kernel")
    ctx_ms = _time_ms(lambda: painn.context(p, s, act, gnn.dense), 10)
    w_bytes = real * 3 * F * 4
    bound_ms = w_bytes / PEAK_HBM_BYTES * 1e3
    timed = lambda x: f"{x:.4f} ms" if x else "not measured"  # noqa: E731
    print(f"phase 14: painn_message [float32]: max|kernel-plain|={err:.3e} (at most "
          f"{ratio:.3f} of the bound of its sums' order), kernel {ms:.4f} ms a wrapper call "
          f"(alone {timed(alone_ms)}; the context Dense layers {ctx_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: W's real slots, "
          f"{w_bytes / 1e9:.3f} GB)")

    del filt, w, d, unit
    torch.cuda.synchronize()
    before = painn.message.launches
    peaks = gnn.apply(params, cfg, gt, positions=pos)
    torch.cuda.synchronize()
    launches = painn.message.launches - before
    if launches != L or not torch.all(torch.isfinite(peaks)):
        raise SystemExit(f"chip_smoke: a PaiNN forward launched painn_message {launches} "
                         f"times (want {L}) or gave peaks not all finite")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = _time_ms(lambda: gnn.apply(params, cfg, gt, positions=pos), 3, 2)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"phase 14: a PaiNN forward launches painn_message {launches} times (one a block); "
          f"forward {fwd_ms:.4f} ms, its memory peak {peak_gb:.2f} GB above the inputs")
    return {"name": "painn_message", "route": "cuda", "source": "nmrgnn_tpu_torch/csrc/painn.cu",
            "replaces": None, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "alone_ms": alone_ms, "context_ms": ctx_ms, "dtype": "float32", "phase": 14,
            "forward_ms": fwd_ms, "forward_peak_gb": peak_gb}


def _phase15(args, dev) -> dict:
    """The attention layer's kernel at the amp-predict-44676 cell's shapes
    (module docstring, phase 15). Returns its kernel row."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.ops import attention
    from portbench.harness import inputs
    from portbench.reference.structures import one_hot, supercell_coords

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "portbench", "traffic", "predict-44676.json")) as fh:
        t = json.load(fh)
    with open(os.path.join(root, "portbench", "configs", "nmrgnn-amp.json")) as fh:
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        cfg = ModelConfig(**{k: v for k, v in json.load(fh).items() if k in fields})
    xyz, elements = supercell_coords(t["atoms"], t["grid"],
                                     np.random.default_rng([t["structure_seed"], 1]),
                                     gap=t["gap"])
    conf = torch.as_tensor(xyz.astype(np.float32), device=dev)
    g = Graph(*inputs.graph(one_hot(elements), *inputs.knn_device(conf, t["neighbors"])))
    g, _ = permute_graph(g, rcm_order(g.nlist, g.edges), pin_zero=False)
    gt = _on_card(g, dev)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    N, K = g.nlist.shape
    F, E, L = cfg.atom_feature_size, cfg.edge_feature_size, cfg.mp_layers
    print(f"phase 15: attention N={N} K={K} F={F} E={E}, {L} layers, "
          f"{int((g.edges == 0).sum())} padding slots of {N * K}")

    with torch.no_grad():
        e = gnn.edge_features(params, cfg, gt.edges)
        nodes = torch.randn((N, F), generator=torch.Generator(device=dev).manual_seed(args.seed),
                            device=dev)
        p = params["mp"][1]
        ops = (p["wq"], p["wk"], p["wv"], nodes, gt.nlist, e, gt.inv_degree)

        def kernel():
            return attention.amp(*ops, cfg.mp_activation)

        def plain():
            return attention.amp_plain(*ops, cfg.mp_activation)

        got, want = kernel(), plain()
        truth = attention.amp_plain(*[x.double() if x.is_floating_point() else x for x in ops],
                                    cfg.mp_activation)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        err64 = {k: float((v.double() - truth).abs().max()) for k, v in
                 (("kernel", got), ("plain", want))}
        if not torch.all(torch.isfinite(got)) or err > 1e-5 * scale:
            raise SystemExit(f"chip_smoke: amp differs from its plain version by {err:.3e} "
                             f"(largest output {scale:.3e})")
        del got, want, truth
        ms, plain_ms = _time_ms(kernel, 10), _time_ms(plain, 3, 2)
        alone_ms = _kernel_device_ms(kernel, "amp_layer_kernel")
        proj_ms = _time_ms(lambda: nodes @ p["wv"], 10)
        layer_peak_gb = {}
        for name, f in (("kernel", kernel), ("plain", plain)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            f()
            torch.cuda.synchronize()
            layer_peak_gb[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    # a wrapper call's least work is the layer's (portbench/flops/attention.py);
    # the kernel's own reads nodes and P = nodes @ wv, the slots and the
    # small weights, and writes [N, F]: none of the projection's operations
    layer_bytes = 4 * (2 * N * F + N * K * (E + 1) + N + F * E + E * E + F * F)
    layer_flops = (2 * F * E + 2 * F * F) * N + (2 * E * E + 2 * E + 2 * F) * N * K
    bound_ms, bound_by = _bound(layer_flops, layer_bytes)
    alone_bytes = 4 * (3 * N * F + N * K * (E + 1) + N + F * E + E * E)
    alone_flops = 2 * F * E * N + (2 * E * E + 2 * E + 2 * F) * N * K
    alone_bound_ms, alone_bound_by = _bound(alone_flops, alone_bytes)
    timed = lambda x: f"{x:.4f} ms" if x else "not measured"  # noqa: E731
    print(f"phase 15: amp [float32]: max|kernel-plain|={err:.3e} ({err / scale:.2e} of the "
          f"largest output; from float64: kernel {err64['kernel']:.3e}, plain "
          f"{err64['plain']:.3e}), kernel {ms:.4f} ms a wrapper call, bound {bound_ms:.4f} ms "
          f"({bound_by}: {layer_flops / 1e9:.2f} GFLOP at 67 TFLOP/s, "
          f"{layer_bytes / 1e6:.1f} MB a layer); alone {timed(alone_ms)}, bound "
          f"{alone_bound_ms:.4f} ms ({alone_bound_by}: {alone_flops / 1e9:.3f} GFLOP, "
          f"{alone_bytes / 1e6:.1f} MB); the projection {proj_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; a layer's memory peak above its inputs: kernel "
          f"{layer_peak_gb['kernel']:.3f} GB, plain {layer_peak_gb['plain']:.3f} GB")

    torch.cuda.synchronize()
    _reset_counts()
    with torch.no_grad():
        peaks = gnn.apply(params, cfg, gt)
        torch.cuda.synchronize()
        launches = attention.amp.launches
        if launches != L or not torch.all(torch.isfinite(peaks)):
            raise SystemExit(f"chip_smoke: an attention forward launched amp {launches} times "
                             f"(want {L}) or gave peaks not all finite")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = _time_ms(lambda: gnn.apply(params, cfg, gt), 5, 2)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"phase 15: an attention forward (no grad) launches amp {launches} times (one a "
          f"layer); forward {fwd_ms:.4f} ms, its memory peak {peak_gb:.2f} GB above the inputs")
    return {"name": "amp", "route": "cuda", "source": "nmrgnn_tpu_torch/csrc/attention.cu",
            "replaces": None, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "alone_ms": alone_ms, "projection_ms": proj_ms, "dtype": "float32", "phase": 15,
            "forward_ms": fwd_ms, "forward_peak_gb": peak_gb,
            "layer_peak_gb": layer_peak_gb, "err_from_float64": err64}


def et_stage_bound(p, q, k, v, vec, geo, heads):
    """(Sx, Sv) elementwise bounds of ET's attention kernel against its
    plain version: twice a float32 bound of either side's error.
    ``attention`` in float64 on the operands' magnitudes with the identity
    for SiLU (|SiLU(x)| <= |x|, its slope at most 1.1) gives, summed over
    a row's slots, C L s for Sx (L the logit's sum of magnitudes, s the
    value's) and |v_state| m1 + |r^| m2 for Sv; each term's relative error
    is at most (2.31 R + 1.1 D + S + 21) 2^-24 for Sx (the filter's R + 1
    products, SiLU's slope, the logit's D terms, the weight, the slot
    sum's S terms) and (1.1 R + S + 11) 2^-24 for Sv, rounded up here to
    (3 R + 2 D + S + 32) and (2 R + S + 16)."""
    import torch

    from nmrgnn_tpu_torch.ops import et

    mag = lambda t: t.abs().to(torch.float64)  # noqa: E731
    pm = {name: {key: mag(t) for key, t in layer.items()} for name, layer in p.items()}
    gm = et.Geometry(geo.nlist, mag(geo.basis), mag(geo.cut), mag(geo.unit))
    sx, sv = et.attention(pm, mag(q), mag(k), mag(v), mag(vec), gm, heads, lambda x: x)
    R, S, D = p["dk"]["kernel"].shape[0], geo.nlist.shape[1], q.shape[1] // heads
    return (2 * 2.0 ** -24 * (3 * R + 2 * D + S + 32) * sx,
            2 * 2.0 ** -24 * (2 * R + S + 16) * sv)


def _phase16(args, dev) -> dict:
    """The ET attention stage's kernel at the et-predict-44676 cell's shapes
    (module docstring, phase 16). Returns its kernel row."""
    import torch

    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.ops import et
    from portbench.drivers.predict_loop_xyz import cutoff_graph, supercell
    from portbench.flops.et import work
    from portbench.harness import inputs
    from portbench.reference.structures import ANGSTROM_TO_NM, one_hot

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "portbench", "traffic", "predict-44676-r5-et.json")) as fh:
        t = json.load(fh)
    with open(os.path.join(root, "portbench", "configs", "torchmd-et.json")) as fh:
        conf_dict = json.load(fh)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in conf_dict.items() if k in fields})
    xyz, elements = supercell(t)
    conf = torch.as_tensor(xyz.astype(np.float32), device=dev)
    g = Graph(*inputs.graph(one_hot(elements), *cutoff_graph(conf, t["neighbors"],
                                                              t["cutoff"])))
    order = rcm_order(g.nlist, g.edges)
    g, _ = permute_graph(g, order, pin_zero=False)
    gt = _on_card(g, dev)
    pos = torch.as_tensor(xyz[order].astype(np.float32) * ANGSTROM_TO_NM, device=dev)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p = params["mp"][1]
    for name in ("dk", "dv"):  # nonzero biases
        p[name]["bias"] = (torch.rand(p[name]["bias"].shape, generator=gen, device=dev) - 0.5) \
            * 0.2
    N, K = g.nlist.shape
    F, L, R, H = cfg.atom_feature_size, cfg.mp_layers, cfg.edge_hidden_size, \
        cfg.edge_feature_size
    real = int((g.edges > 0).sum())
    silu = torch.nn.functional.silu

    with torch.no_grad():
        geo = et.geometry(pos, gt.nlist, gt.edges, R, cfg.rbf_low, cfg.rbf_high)
        live = int((geo.nlist < N).sum())
        print(f"phase 16: ET N={N} K={K} F={F} in {H} heads, R={R}, {L} layers; {real} graph "
              f"edges, {live} real slots with the self terms of {N * (K + 1)}")
        q, k = (torch.randn((N, F), generator=gen, device=dev) for _ in range(2))
        v = torch.randn((N, 3 * F), generator=gen, device=dev)
        vec = torch.randn((N, 3, F), generator=gen, device=dev)
        ops = (p, q, k, v, vec, geo, H)

        def kernel():
            return et.fused_attention(*ops, silu)

        def plain():
            return et.attention(*ops, silu)

        got, want = kernel(), plain()
        ratio, err = 0.0, 0.0
        for a, b, bound in zip(got, want, et_stage_bound(*ops)):
            gap = (a - b).abs().to(torch.float64)
            if not torch.all(torch.isfinite(a)) or not torch.all(gap <= bound):
                raise SystemExit("chip_smoke: the ET attention kernel lies outside its bound "
                                 "of the plain version")
            ratio = max(ratio, float((gap / bound.clamp_min(1e-300)).max()))
            err = max(err, float(gap.max()))
        scale = max(float(w.abs().max()) for w in want)
        pd = {name: {key: x.double() for key, x in layer.items()} for name, layer in p.items()}
        truth = et.attention(pd, *(x.double() for x in ops[1:5]),
                             et.Geometry(geo.nlist, *(x.double() for x in geo[1:])), H, silu)
        err64 = {name: max(float((x.double() - y).abs().max()) for x, y in zip(out, truth))
                 for name, out in (("kernel", got), ("plain", want))}
        del got, want, truth
        ms, plain_ms = _time_ms(kernel, 10), _time_ms(plain, 3, 2)
        alone_ms = _kernel_device_ms(kernel, "et_attention_kernel")
        layer_peak_gb = {}
        for name, f in (("kernel", kernel), ("plain", plain)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            f()
            torch.cuda.synchronize()
            layer_peak_gb[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    # a layer's least work: portbench/flops/et.py's work["attn"] over L
    attn_flops, attn_bytes = work(conf_dict, N, real)["attn"]
    bound_ms, bound_by = _bound(attn_flops / L, attn_bytes / L)
    timed = lambda x: f"{x:.4f} ms" if x else "not measured"  # noqa: E731
    print(f"phase 16: et fused_attention [float32]: max|kernel-plain|={err:.3e} ({err / scale:.2e}"
          f" of the largest output; at most {ratio:.3f} of the bound; from float64: kernel "
          f"{err64['kernel']:.3e}, plain {err64['plain']:.3e}), kernel {ms:.4f} ms a wrapper "
          f"call (alone {timed(alone_ms)}), bound {bound_ms:.4f} ms ({bound_by}: "
          f"{attn_flops / L / 1e9:.1f} GFLOP at 67 TFLOP/s, {attn_bytes / L / 1e9:.3f} GB a "
          f"layer), plain {plain_ms:.4f} ms; a layer's memory peak above its inputs: kernel "
          f"{layer_peak_gb['kernel']:.3f} GB, plain {layer_peak_gb['plain']:.3f} GB")

    torch.cuda.synchronize()
    _reset_counts()
    with torch.no_grad():
        peaks = gnn.apply(params, cfg, gt, positions=pos)
        torch.cuda.synchronize()
        launches = et.fused_attention.launches
        if launches != L or not torch.all(torch.isfinite(peaks)):
            raise SystemExit(f"chip_smoke: an ET forward launched fused_attention {launches} "
                             f"times (want {L}) or gave peaks not all finite")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = _time_ms(lambda: gnn.apply(params, cfg, gt, positions=pos), 3, 1)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"phase 16: an ET forward (no grad) launches fused_attention {launches} times (one a "
          f"layer); forward {fwd_ms:.4f} ms, its memory peak {peak_gb:.2f} GB above the inputs")
    return {"name": "et_attention", "route": "cuda", "source": "nmrgnn_tpu_torch/csrc/et.cu",
            "replaces": None, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "alone_ms": alone_ms, "dtype": "float32", "phase": 16, "forward_ms": fwd_ms,
            "forward_peak_gb": peak_gb, "layer_peak_gb": layer_peak_gb,
            "err_from_float64": err64}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time of each kernel in each forward "
                         "(torch.profiler)")
    args = ap.parse_args(argv)

    # -- phase 1: the card -------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- phase 2: build ----------------------------------------------------
    from nmrgnn_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    logs = _cuda.build(verbose=True)
    print(f"phase 2: built {', '.join(_cuda.SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)")
    t_phase = time.perf_counter()
    for name, log in logs.items():
        for line in _ptxas_summary(log):
            print(f"  ptxas {name}.cu {line}")

    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.data.parse import structure2graph
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.library import load_model, universe2graph
    from nmrgnn_tpu_torch.models import gnn
    from nmrgnn_tpu_torch.models.infer import _edge_features, apply_banded, apply_banded_classes
    from nmrgnn_tpu_torch.models.serving import CHEB_DEGREE, ServingModel
    from nmrgnn_tpu_torch.ops import banded
    from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev

    # -- the main paths' inputs ---------------------------------------------
    params, cfg = load_model(device=dev)
    n_params = gnn.count_params(params)
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "synthetic.pdb")
        write_synthetic_pdb(pdb, n_atoms=N_ATOMS, seed=args.seed, frames=N_FRAMES)
        graphs = [universe2graph(pdb)]
        struct = read_structure(pdb)
        graphs += [structure2graph(struct, frame=f) for f in range(1, N_FRAMES)]
    order = rcm_order(graphs[0].nlist, graphs[0].edges)
    g_rcm, _ = permute_graph(graphs[0], order, pin_zero=False)
    plan = banded.band_plan(g_rcm.nlist, g_rcm.edges)
    cls_plan = banded.band_plan_classes(g_rcm.nlist, g_rcm.edges)
    T, B, W = plan.num_tiles, plan.block_rows, plan.window
    N, K = g_rcm.nlist.shape
    F, E, H = cfg.atom_feature_size, cfg.edge_feature_size, cfg.edge_hidden_size
    Lh, L = cfg.edge_fc_layers - 1, len(params["mp"])
    print(f"model: {n_params} parameters, F={F} E={E} H={H} K={K}, {L} MP layers")
    print(f"graph: N={N} N_pad={plan.n_padded} T={T} B={B} RCM window W={W}; class plan "
          f"{', '.join(f'{len(c.ids)} tiles @ {c.window}' for c in cls_plan.classes)}")
    if W > 1024:
        raise SystemExit(f"chip_smoke: RCM window {W} > 1024")

    gt = _on_card(g_rcm, dev)
    plan_d = banded.plan_on_device(plan, dev)
    cls_d = banded.plan_on_device(cls_plan, dev)
    cheb = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                              rbf_count=H, activation=cfg.fc_activation, degree=CHEB_DEGREE)
    cheb_d = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    bf16, f32 = torch.bfloat16, torch.float32

    # -- phase 3: each kernel against its plain version --------------------
    kernels, checks = [], []
    fc = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation)
    real_edges = int((g_rcm.edges > 0).sum())
    m_bytes = T * E * B * W * 4

    def check(name, line, got_fn, want_fn, *, tol, flops, nbytes, peak=PEAK_F32_FLOPS,
              rtol=None, tol_of_max=0.0, source="banded.cu", dtype="float32", row=True,
              extra="", repeats=REPEATS, inner=10, phase=3, library=None, alone=None,
              exact=False, library_alone=None):
        """Compare kernel and plain version (tensors or lists of them, one
        per window class): equal bit for bit with ``exact`` (and for
        integer outputs), else within rtol (default tol) and atol = tol +
        tol_of_max * max|plain|; time both (the median of ``repeats`` runs
        of ``inner`` calls), ``library`` (one PyTorch call, a yardstick
        the port never calls) where given, and the device time of the
        kernels named ``alone`` (and ``library_alone`` in the yardstick)
        in a call (torch.profiler) where given; record the row."""
        got, want = got_fn(), want_fn()
        torch.cuda.synchronize()
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        scale = max(float(w.float().abs().max()) for w in want)
        atol = tol + tol_of_max * scale
        err = 0.0
        for g, w in zip(got, want):
            err = max(err, float((g.float() - w.float()).abs().max()))
            if (exact or not w.is_floating_point()) and not torch.equal(g, w):
                raise SystemExit(f"chip_smoke: {name} differs from its plain version (max "
                                 f"{err:.3e})")
            torch.testing.assert_close(g.float(), w.float(), rtol=tol if rtol is None else rtol,
                                       atol=atol)
        del want, w  # the plain outputs, before the timing runs allocate more
        ms, plain_ms = _time_ms(got_fn, repeats, inner), _time_ms(want_fn, repeats, inner)
        lib_ms = None if library is None else _time_ms(library, repeats, inner)
        alone_ms = None if alone is None else _kernel_device_ms(got_fn, alone)
        lib_alone = None if library_alone is None else _kernel_device_ms(library, library_alone)
        bound_ms, bound_by = _bound(flops, nbytes, peak)
        timed = lambda t: f"{t:.4f} ms" if t else "not measured"  # noqa: E731
        print(f"phase {phase}: {name} [{dtype}]: "
              + ("equal bit for bit, " if exact else f"max|kernel-plain|={err:.3e} "
                 f"(atol {atol:.3g}) ")
              + f"kernel {ms:.4f} ms"
              f"{'' if alone is None else f' (alone {timed(alone_ms)})'}"
              f", plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {_flops(flops) / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)"
              f"{'' if lib_ms is None else f', library {lib_ms:.4f} ms'}"
              f"{'' if library_alone is None else f' (alone {timed(lib_alone)})'}"
              f"{f', {len(got)} launches' if len(got) > 1 else ''}{extra}")
        rec = {
            "name": name, "route": "cuda", "source": f"nmrgnn_tpu_torch/csrc/{source}",
            "replaces": line, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "dtype": dtype, "calls_per_timing": len(got),
            "alone_ms": alone_ms, "library_alone_ms": lib_alone, "phase": phase,
        }
        checks.append(rec)
        if row:
            kernels.append(rec)
        return got if len(got) > 1 else got[0]

    # the exact path's kernels (float32)
    ew = params["edge_fc"]
    fused_flops = 2 * real_edges * H * (H * Lh + E)
    fused_bytes = (N * K * 8 + 4 * sum(t.numel() for p in ew for t in p.values())
                   + T * 4 + m_bytes)
    transc = real_edges * H * (1 + 2 * Lh)
    M = check(
        "build_band_fused", "nmrgnn_tpu/ops/banded.py:1107",
        lambda: banded.build_band_fused(gt.nlist, gt.edges, ew, plan_d, **fc),
        lambda: banded.build_band_fused_plain(gt.nlist, gt.edges, ew, plan_d, **fc),
        tol=1e-5, flops=fused_flops, nbytes=fused_bytes, alone="fused_edge_band_kernel",
        library=_edgefc_yardstick(params, cfg, gt.edges, f32),
        extra=f"; {transc / 1e6:.1f} M transcendentals; library: the {Lh} hidden EdgeFC "
              f"products alone (torch.matmul, a yardstick)",
    )
    e_feat = _edge_features(params, cfg, gt.edges)
    check(
        "build_band", "nmrgnn_tpu/ops/banded.py:484",
        lambda: banded.build_band(gt.nlist, e_feat, plan_d),
        lambda: banded.build_band_plain(gt.nlist, e_feat, plan_d),
        tol=0.0, exact=True, flops=2 * real_edges * E,
        nbytes=N * K * 4 + N * K * E * 4 + T * 4 + m_bytes, **_build_timing(
            dev, "build_band", (T, E, B, W), f32, "build_band"),
    )
    nodes = torch.nn.functional.pad(gnn.dense(params["embed"], gt.atoms),
                                    (0, 0, 0, plan.n_padded - N))
    inv_p = torch.nn.functional.pad(gt.inv_degree, (0, plan.n_padded - N))
    w0 = params["mp"][0]["w"]
    act = cfg.mp_activation
    # the band's chunk occupancy, as the forwards make it once per band
    occ_args = (gt.nlist, gt.edges, plan_d.lo, W, B, plan.n_padded)
    occ = banded.band_occupancy(*occ_args)
    _, _, row_chunks, load = _mp_load([(occ, B, W)], F)
    check(
        "band_occupancy", "nmrgnn_tpu/ops/banded.py:610",
        lambda: banded.band_occupancy(*occ_args), lambda: banded.band_occupancy_plain(*occ_args),
        tol=0.0, flops=0, nbytes=N * K * 8 + T * 4 + occ.numel() * 4, source="hbm.cu",
        dtype="int32", extra=f"; {row_chunks} occupied (row, chunk) pairs",
    )
    occ_m = check(
        "band_occupancy_from_band", "nmrgnn_tpu/ops/banded.py:610",
        lambda: banded.band_occupancy_from_band(M),
        lambda: banded.band_occupancy_from_band_plain(M),
        tol=0.0, flops=0, nbytes=M.numel() * 4 + occ.numel() * 4, source="hbm.cu",
        dtype="int32", extra=" (float32 band)",
    )
    if torch.bitwise_and(occ_m, torch.bitwise_not(occ)).any():  # exactness
        raise SystemExit("chip_smoke: a nonzero of the band lies outside the occupancy")
    print(f"phase 3: the occupancy from nlist covers every nonzero of the band; equal to the "
          f"band's own: {bool(torch.equal(occ_m, occ))}")
    nnz = int((M != 0).sum())
    mp_flops = 2 * nnz * F + 2 * T * E * B * F * F
    dense_flops = 2 * T * E * B * W * F + 2 * T * E * B * F * F

    def mp_bytes(eb):
        # the occupied chunks of each band row, the occupancy and lo; the
        # table and inv_degree read once, the weights once, the output once
        return (row_chunks * 16 * E * eb + occ.numel() * 4 + T * 4
                + plan.n_padded * F * eb * 2 + F * F * E * eb + plan.n_padded * 4)

    win_idx = plan_d.lo.long()[:, None] + torch.arange(W, device=dev)  # [T, W]

    def bmm(M_, table):
        """The yardstick: the dense band against its windows, one torch.bmm."""
        win = table[win_idx]
        return lambda: torch.bmm(M_.view(T, E * B, W), win)

    check(
        "mp_banded", "nmrgnn_tpu/ops/banded.py:555",
        lambda: banded.mp_banded(M, plan_d, nodes, w0, inv_p, act, occ),
        lambda: banded.mp_banded_plain(M, plan_d, nodes, w0, inv_p, act),
        tol=2e-4, flops=mp_flops, nbytes=mp_bytes(4), source="hbm.cu",
        library=bmm(M, nodes),
        extra=f"; band {nnz} nonzeros of {M.numel()}, dense products "
              f"{dense_flops / 1e9:.3f} GFLOP{load}",
    )

    # the fast path's kernels: the Chebyshev builds (bfloat16 on the path,
    # float32 checked too), the partial MP per class, and bfloat16 mp_banded
    deg = cheb.degree
    cheb_flops = N * K * (deg - 1) * (2 + 2 * E) + N * K * 2 * E
    cheb_in = N * K * 8 + cheb.coeffs.size * 4
    Mp, Mcls = {}, {}
    for dt, tag, eb in ((bf16, "bfloat16", 2), (f32, "float32", 4)):
        Mp[dt] = check(
            "build_band_poly", "nmrgnn_tpu/ops/banded.py:1268",
            lambda dt=dt: banded.build_band_poly(gt.nlist, gt.edges, cheb_d, plan_d, dt),
            lambda dt=dt: banded.build_band_poly_plain(gt.nlist, gt.edges, cheb_d, plan_d, dt),
            tol=0.0, exact=True, flops=cheb_flops,
            nbytes=cheb_in + T * 4 + T * E * B * W * eb, source="poly.cu", dtype=tag,
            row=dt == bf16, **_build_timing(dev, "build_band_poly", (T, E, B, W), dt,
                                            "build_band_poly" if dt == bf16 else None),
        )
        cls_bytes = sum(len(c.ids) * (8 + E * B * c.window * eb) for c in cls_plan.classes)
        Mcls[dt] = check(
            "build_band_poly_cls", "nmrgnn_tpu/ops/banded.py:1645",
            lambda dt=dt: [banded.build_band_poly_cls(gt.nlist, gt.edges, cheb_d, c, B,
                                                      plan.n_padded, dt)
                           for c in cls_d.classes],
            lambda dt=dt: [banded.build_band_poly_cls_plain(gt.nlist, gt.edges, cheb_d, c, B,
                                                            plan.n_padded, dt)
                           for c in cls_d.classes],
            tol=0.0, exact=True, flops=cheb_flops,
            nbytes=cheb_in + cls_bytes, source="poly.cu", dtype=tag, row=dt == bf16,
            **_build_timing(dev, "build_band_poly_cls", [(len(c.ids), E, B, c.window)
                                                         for c in cls_plan.classes], dt,
                            "build_band_poly_cls" if dt == bf16 else None),
        )
    occ_cls = [banded.band_occupancy(gt.nlist, gt.edges, c.lo, c.window, B, plan.n_padded,
                                     ids=c.ids) for c in cls_d.classes]
    _, _, cls_chunks, cls_load = _mp_load(
        [(o, B, c.window) for o, c in zip(occ_cls, cls_plan.classes)], F)
    for dt, tag, eb, peak in ((bf16, "bfloat16", 2, PEAK_BF16_FLOPS),
                              (f32, "float32", 4, PEAK_F32_FLOPS)):
        table = nodes.to(dt)
        part_flops = sum(2 * int((m != 0).sum()) * F + 2 * len(c.ids) * E * B * F * F
                         for m, c in zip(Mcls[dt], cls_plan.classes))
        # each class's occupied band chunks, occupancy, lo and float32
        # output rows; the table and the weights once
        part_bytes = (cls_chunks * 16 * E * eb
                      + sum(o.numel() * 4 + len(c.ids) * (4 + B * F * 4)
                            for o, c in zip(occ_cls, cls_plan.classes))
                      + plan.n_padded * F * eb + F * F * E * eb)
        check(
            "mp_banded_partial", "nmrgnn_tpu/ops/banded.py:833",
            lambda dt=dt, table=table: [banded.mp_banded_partial(m, c.lo, table, w0, o)
                                        for m, c, o in zip(Mcls[dt], cls_d.classes, occ_cls)],
            lambda dt=dt, table=table: [banded.mp_banded_partial_plain(m, c.lo, table, w0)
                                        for m, c in zip(Mcls[dt], cls_d.classes)],
            tol=2e-4, tol_of_max=BF16_STEP if dt == bf16 else 0.0, flops=part_flops,
            nbytes=part_bytes, peak=peak, source="hbm.cu", dtype=tag, row=dt == bf16,
            extra=cls_load,
        )
    nodes16 = nodes.to(bf16)
    nnz16 = int((Mp[bf16] != 0).sum())
    check(
        "mp_banded_bf16", "nmrgnn_tpu/ops/banded.py:555",
        lambda: banded.mp_banded(Mp[bf16], plan_d, nodes16, w0, inv_p, act, occ),
        lambda: banded.mp_banded_plain(Mp[bf16], plan_d, nodes16, w0, inv_p, act),
        rtol=BF16_STEP, tol=0.0, tol_of_max=2 * BF16_STEP,
        flops=2 * nnz16 * F + 2 * T * E * B * F * F, nbytes=mp_bytes(2), peak=PEAK_BF16_FLOPS,
        source="hbm.cu", dtype="bfloat16", library=bmm(Mp[bf16], nodes16),
        extra=f"; band {nnz16} nonzeros{load}",
    )
    split = {tag: _occupancy_split(
        f"phase 3: mp_banded [{tag}]",
        lambda o, M_=M_, x=x: banded.mp_banded(M_, plan_d, x, w0, inv_p, act, o), occ)
        for tag, M_, x in (("float32", M, nodes), ("bfloat16", Mp[bf16], nodes16))}

    print(f"phase 3: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    def counts():
        return {f.__name__: f.launches for f in _wrappers()}

    def expect(got, **want):
        want = {f.__name__: want.get(f.__name__, 0) for f in _wrappers()}
        if got != want:
            raise SystemExit(f"chip_smoke: launches {got} != {want}")

    # -- phase 4a: exact serving ---------------------------------------------
    _reset_counts()
    model = ServingModel(params, cfg, device=dev)
    peaks, frame_s = [], []
    for g in graphs:
        t0 = time.perf_counter()
        peaks.append(model.predict(g))
        frame_s.append(time.perf_counter() - t0)
    exact_launches = counts()
    print(f"phase 4a: exact: served {len(graphs)} frames, launches {exact_launches}, "
          f"per-frame wall ms {[round(s * 1e3, 3) for s in frame_s]}")
    expect(exact_launches, build_band_fused=len(graphs), mp_banded=len(graphs) * L,
           band_occupancy=len(graphs))
    worst = 0.0
    for f, (g, p) in enumerate(zip(graphs, peaks)):
        if p.shape != (N,) or not np.all(np.isfinite(p)):
            raise SystemExit(f"chip_smoke: frame {f}: peaks of shape {p.shape} not all finite")
        ref = gnn.apply(params, cfg, _on_card(g, dev)).cpu().numpy()
        np.testing.assert_allclose(p, ref, rtol=5e-4, atol=5e-4)
        worst = max(worst, float(np.max(np.abs(p - ref))))
    print(f"phase 4a: peaks finite, max|served - plain gather forward| = {worst:.3e} "
          f"(tol 5e-4); frame 0 peaks mean {float(np.mean(peaks[0])):.4f} ppm")
    if np.array_equal(peaks[0], peaks[1]):
        raise SystemExit("chip_smoke: jittered frames gave identical peaks")

    _reset_counts()
    unfused = apply_banded(params, cfg, gt, plan_d, fused_edge=False)
    torch.cuda.synchronize()
    unfused_launches = counts()
    expect(unfused_launches, mp_banded=L, build_band=1, band_occupancy=1)
    plain = apply_banded(params, cfg, gt, plan_d, use_kernels=False)
    torch.testing.assert_close(unfused, plain, rtol=5e-4, atol=5e-4)
    print(f"phase 4a: unfused edge branch launches {unfused_launches}, max|kernels - plain| = "
          f"{float((unfused - plain).abs().max()):.3e} (tol 5e-4)")

    # -- phase 4b: fast serving ----------------------------------------------
    _reset_counts()
    fast = ServingModel(params, cfg, device=dev, precision="fast")
    fast_peaks, fast_s, branches = [], [], []
    for g in graphs:
        t0 = time.perf_counter()
        fast_peaks.append(fast.predict(g))
        fast_s.append(time.perf_counter() - t0)
        # the class forward served this frame iff the model's class plan
        # (after this frame) covers it and has more than one class
        gp, _ = permute_graph(g, fast._order, pin_zero=False)
        cp = fast._cls_plan_vmem
        on_cls = (cp is not None and len(cp.classes) > 1
                  and banded.class_plan_covers(cp, gp.nlist, gp.edges))
        branches.append(len(cp.classes) if on_cls else 0)
    fast_launches = counts()
    n_cls = sum(branches)
    n_uni = branches.count(0)
    if not (n_cls and n_uni):
        raise SystemExit(f"chip_smoke: the fast frames took one forward only ({branches}); "
                         f"both are on the path")
    print(f"phase 4b: fast: served {len(graphs)} frames, forwards "
          f"{['classes(%d)' % b if b else 'uniform' for b in branches]} "
          f"(re-bucketing switch {'on' if fast._cls_vmem_off else 'off'}), launches "
          f"{fast_launches}, per-frame wall ms {[round(s * 1e3, 3) for s in fast_s]}")
    expect(fast_launches, build_band_poly_cls=n_cls, mp_banded_partial=n_cls * L,
           build_band_poly=n_uni, mp_banded=n_uni * L, band_occupancy=n_cls + n_uni)
    for f, p in enumerate(fast_peaks):
        if p.shape != (N,):
            raise SystemExit(f"chip_smoke: fast frame {f}: peaks of shape {p.shape}")
        print(f"phase 4b: fast frame {f} vs exact frame {f}: "
              f"{_in_fast_band(p, peaks[f], f'fast frame {f}')}")
    if np.array_equal(fast_peaks[0], fast_peaks[1]):
        raise SystemExit("chip_smoke: jittered frames gave identical fast peaks")

    # -- phase 4c: each fast forward directly ----------------------------------
    _reset_counts()
    uni = apply_banded(params, cfg16, gt, plan_d, cheb=cheb_d)
    torch.cuda.synchronize()
    uni_launches = counts()
    expect(uni_launches, build_band_poly=1, mp_banded=L, band_occupancy=1)
    uni_plain = apply_banded(params, cfg16, gt, plan_d, cheb=cheb_d, use_kernels=False)
    print(f"phase 4c: uniform fast forward launches {uni_launches}; kernels vs plain: "
          f"{_in_fast_band(uni.cpu().numpy(), uni_plain.cpu().numpy(), 'uniform', 0.05)}")
    _reset_counts()
    clsf = apply_banded_classes(params, cfg16, gt, cls_d, cheb_d)
    torch.cuda.synchronize()
    cls_launches = counts()
    nc = len(cls_plan.classes)
    expect(cls_launches, build_band_poly_cls=nc, mp_banded_partial=nc * L, band_occupancy=nc)
    cls_plain = apply_banded_classes(params, cfg16, gt, cls_d, cheb_d, use_kernels=False)
    print(f"phase 4c: class fast forward launches {cls_launches}; kernels vs plain: "
          f"{_in_fast_band(clsf.cpu().numpy(), cls_plain.cpu().numpy(), 'classes', 0.05)}")

    # launches per kernel row: the count in the serving run of its path
    for k in kernels:
        n = k["name"]
        if n in ("build_band_fused", "mp_banded", "band_occupancy"):
            k["launches"] = exact_launches[n]
        elif n == "band_occupancy_from_band":
            continue  # launched by the direct partial layers of phase 8c
        elif n == "build_band":
            k["launches"] = unfused_launches[n]
        else:
            wrapper = "mp_banded" if n == "mp_banded_bf16" else n
            k["launches"] = fast_launches[wrapper]
        if not k["launches"]:
            raise SystemExit(f"chip_smoke: {n} was never launched on its path")

    # -- timing ----------------------------------------------------------------
    fwd = {
        "exact": lambda: apply_banded(params, cfg, gt, plan_d),
        "fast_classes": lambda: apply_banded_classes(params, cfg16, gt, cls_d, cheb_d),
        "fast_uniform": lambda: apply_banded(params, cfg16, gt, plan_d, cheb=cheb_d),
    }
    plain_fwd = {
        "exact": lambda: apply_banded(params, cfg, gt, plan_d, use_kernels=False),
        "fast_classes": lambda: apply_banded_classes(params, cfg16, gt, cls_d, cheb_d,
                                                     use_kernels=False),
        "fast_uniform": lambda: apply_banded(params, cfg16, gt, plan_d, cheb=cheb_d,
                                             use_kernels=False),
    }
    fwd_ms = {k: _time_ms(f, 10) for k, f in fwd.items()}
    plain_fwd_ms = {k: _time_ms(f, 10) for k, f in plain_fwd.items()}

    predict_ms = {"exact": _wall_ms(model, graphs[-1], 10),
                  "fast_frame0": _wall_ms(fast, graphs[0], 10),
                  "fast_last_frame": _wall_ms(fast, graphs[-1], 10)}
    for k in fwd:
        print(f"phase 4: {k} forward on the card {fwd_ms[k]:.4f} ms, plain versions "
              f"{plain_fwd_ms[k]:.4f} ms (median of 10, CUDA events)")
    print(f"phase 4: predict() wall ms (median of 10, host clock, includes RCM permute, "
          f"plan checks and copies): {json.dumps({k: round(v, 3) for k, v in predict_ms.items()})}")

    breakdown = {k: _profile_forward(f, fwd_ms[k], k) for k, f in fwd.items()} \
        if args.profile else None
    print(f"phase 4: {time.perf_counter() - t_phase:.1f} s")

    # -- phases 5 and 6 -----------------------------------------------------
    t_phase = time.perf_counter()
    large, large_inputs = _phase5(args, dev, params, cfg, cheb_d, check, counts, expect)
    print(f"phase 5: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    traj = _phase6(args, dev, params, cfg, counts, expect)
    print(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    wide = _phase7(args, dev, params, cfg, graphs, peaks, check, counts, expect)
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    small = dict(graphs=graphs, order=order, peaks=peaks, g_rcm=g_rcm, gt=gt, plan=plan,
                 plan_d=plan_d, cheb=cheb_d, nodes=nodes, inv_p=inv_p)
    last = _phase8(args, dev, params, cfg, small, large_inputs, check, counts, expect)
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    training = _phase9(args, dev, counts, expect)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    attention = _phase10(args, dev, dict(graphs=graphs, coords=struct.coords[0]), large_inputs,
                         check, counts, expect)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    widths = _phase11a(args, dev, dict(graphs=graphs, struct=struct), large_inputs, counts)
    print(f"phase 11a: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    cli_runs = _phase11b(args, dev, params, cfg, dict(graphs=graphs), counts)
    print(f"phase 11b: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    partitioned = _phase12(args, dev, params, cfg, dict(graphs=graphs, peaks=peaks),
                           large_inputs)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    part_training = _phase13(args, dev, dict(graphs=graphs), large_inputs)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    kernels.append(_phase14(args, dev))
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    kernels.append(_phase15(args, dev))
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    kernels.append(_phase16(args, dev))
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    checks.append({"name": "training_step", "phase": 9,
                   "max_abs_err": training["peaks_max_abs_err"],
                   "loss_rel_err": training["loss_rel_err"],
                   "grad_max_rel_err": training["grad_max_rel_err"]})
    for k in kernels:
        if k["name"] in ("build_band", "mp_banded", "band_occupancy"):
            k["train_launches"] = training["launches"][k["name"]]
        if k["name"] in ("build_band_attn", "mp_banded_partial_attn"):
            k["launches"] = attention["launches"][k["name"][:-len("_attn")]]
        if k["name"] == "band_occupancy":
            k["attn_launches"] = attention["launches"]["band_occupancy"]
    for k in kernels:
        for phase in (large, wide, last):
            if k["name"] in phase["launches"]:
                k["launches"] = phase["launches"][k["name"]]
        if not k["launches"]:
            raise SystemExit(f"chip_smoke: {k['name']} was never launched on its path")
        # phase 11a's calls of this wrapper (both types), by configuration
        wrapper = k["name"]
        by_width = {label: rec["launches"][wrapper] for label, rec in widths.items()
                    if label != "supercell" and rec["launches"].get(wrapper)}
        if widths["supercell"]["launches"].get(wrapper):
            by_width["supercell " + widths["supercell"]["config"]] = \
                widths["supercell"]["launches"][wrapper]
        k["width_launches"] = by_width
        # phase 12a's launches a forward of rank 0, by precision (the mesh's
        # 2 ranks each launch as many)
        k["part_launches"] = {
            name: rec["launches_a_frame"][0][k["name"]]
            for name, rec in partitioned.items() if name in ("exact", "fast", "attention")
            and rec["launches_a_frame"][0].get(k["name"])}
        # phase 13's launches a training step of rank 0: partitioned (13a)
        # and data-parallel (13c)
        for key, phase in (("part_train_launches", "a"), ("dp_train_launches", "c")):
            launches = part_training[phase].get("step_launches") or \
                part_training[phase]["launches"]
            if launches.get(k["name"]):
                k[key] = launches[k["name"]]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({
                "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                "graph": {"N": N, "N_pad": plan.n_padded, "T": T, "B": B, "W": W, "K": K,
                          "classes": [[len(c.ids), c.window] for c in cls_plan.classes]},
                "kernels": kernels, "checks": checks, "mp_occupancy_split_ms": split,
                "forward_ms": fwd_ms,
                "plain_forward_ms": plain_fwd_ms, "predict_wall_ms": predict_ms,
                "frame_wall_s": {"exact": frame_s, "fast": fast_s}, "fast_branches": branches,
                "forward_breakdown": breakdown, "large": large, "trajectory": traj,
                "wide": wide, "last_kernels": last, "training": training,
                "attention": attention, "widths": widths, "cli": cli_runs,
                "partitioned": partitioned, "partitioned_training": part_training,
            }, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
