"""Block-sparse message passing (``nmrgnn_tpu/ops/blocksparse.py``) on Hopper.

A structure whose RCM band is too wide for the banded paths is served
through its block-sparse adjacency. The edge values are layer-invariant,
so the active (row block, col block) pairs of B x B blocks and their
blocks

    A[p, n, b, q] = sum_k e[rB + b, k, n] * [nlist[rB + b, k] == cB + q]

are built once per forward, and every MP layer streams each row block's
pairs, fused with the weights, inv_degree, the activation and the
residual:

    h_n    = sum over the pairs p of row block r of A[p, n] @ nodes[col block]
    out_r  = act((sum_n h_n @ W_n) * inv_degree) + nodes_r

The structure (``block_structure``, ``remap_frame``) is host-side numpy, as
in the JAX package; ``struct_on_device`` copies its pair arrays, with the
CSR offsets of each row block's pairs, to the card once.

About a fifth of the (pair, 32-row slab, 16-column chunk) pieces of A
hold a nonzero at 100,000 atoms, so the MP kernel stages only those: it
reads the block occupancy, one bit per (pair, slab, chunk)
(``block_occupancy``, made once per structure and frame by the forward
from nlist, the distances and the pairs; ``block_occupancy_from_adjacency``
for a call with the JAX package's signature, one pass over A).

Each wrapper (``_cuda.kernel``) takes the plain PyTorch version for a
tensor on the CPU and launches its CUDA kernel (``csrc/blocksparse.cu``; the MP layer is
``csrc/mp.cuh``'s kernel in its kPairs mode) for a tensor on the card; it
never falls back from the card to the plain version. Each counts its
launches in ``.launches``.

==============================  ========================================  ==============
wrapper                         replaces (TPU kernel)                     bound
==============================  ========================================  ==============
build_block_adjacency           _build_adj_kernel, blocksparse.py:215-293 bytes (A)
mp_blocksparse                  _mp_bs_kernel, blocksparse.py:301-338,    operations
                                446-504                                   (f32; bf16:
                                                                          bytes)
mp_blocksparse_grouped          _mp_bs_kernel_grouped, blocksparse.py:341 as above
block_occupancy                 none (feeds B11 / B12)                    bytes (nlist)
block_occupancy_from_adjacency  none (feeds B11 / B12)                    bytes (A)
==============================  ========================================  ==============

``mp_blocksparse`` and ``mp_blocksparse_grouped`` launch one kernel: G
pairs a grid step is how the TPU kernel amortises its steps, and on the
card it computes the same function on a structure built with ``group=G``
(the extra pairs are padding, never staged, and give the same bits).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as nnf

from ._cuda import as_long, at, bf16_flag, check, col, kernel, launch
from .activations import get_activation
from .mp import (MP_CHUNK, MP_ROWS, chain, channel_groups, mp_group_size, mp_tiles_ok,
                 occupancy_bits, operands, pack_bits)


class BlockStructure(NamedTuple):
    """Per-structure sparsity pattern (host-computed from the neighbor
    lists; shared by every MP layer of a forward and by repeated forwards
    over the same frame). ``struct_on_device`` gives a copy whose pair
    arrays and ``row_ptr`` are int32 tensors."""

    pair_rows: object  # i32[P] row-block id per active pair (sorted)
    pair_cols: object  # i32[P] col-block id per active pair
    pair_valid: object  # i32[P] 1 for real pairs, 0 for padding
    edge_pair: np.ndarray  # i32[N, K] active-pair index of each edge slot
    block_size: int
    n_padded: int
    key_sorted: Optional[np.ndarray] = None  # i64[U] sorted active-pair keys
    key_pos: Optional[np.ndarray] = None     # i64[U] pair index per key
    row_ptr: object = None  # i32[nb + 1] pairs of row block r: [row_ptr[r], row_ptr[r+1])

    @property
    def nb(self) -> int:
        return self.n_padded // self.block_size

    @property
    def n_pairs(self) -> int:
        return self.pair_rows.shape[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(x: int, buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if x <= b:
            return b
    return _round_up(x, 512)


def block_structure(
    nlist: np.ndarray,
    edges: np.ndarray,
    block_size: int = 128,
    pair_rounding: int = 0,
    group: int = 1,
) -> BlockStructure:
    """The active (row-block, col-block) pair list, on the host.

    Only real edges (distance > 0) define the pattern. Every row block
    gets a pair (r, 0), so each output block is written. With ``group`` >
    1 each row's run is padded to a multiple of ``group`` with invalid
    pairs at col 0. The pair count is rounded (``pair_rounding`` 0: the
    power buckets of ``_bucket``; m: up to a multiple of m) with invalid
    padding pairs at row nb - 1, col 0."""
    nlist = np.asarray(nlist)
    edges = np.asarray(edges)
    n, k = nlist.shape
    n_pad = _round_up(n, block_size)
    nb = n_pad // block_size
    ib = np.broadcast_to(np.arange(n)[:, None] // block_size, nlist.shape)
    jb = nlist // block_size
    real = edges > 0
    key = ib.astype(np.int64) * nb + jb.astype(np.int64)
    uniq = np.unique(key[real]) if real.any() else np.empty(0, np.int64)
    guaranteed = np.arange(nb, dtype=np.int64) * nb  # (r, 0) for every row
    uniq = np.unique(np.concatenate([uniq, guaranteed]))
    rows = (uniq // nb).astype(np.int32)
    cols = (uniq % nb).astype(np.int32)
    pos_of_uniq = np.arange(rows.shape[0], dtype=np.int64)  # keys are row-major sorted
    grouped_valid = np.ones(rows.shape[0], np.int32)
    if group > 1:
        new_rows, new_cols, valid_parts = [], [], []
        pos_of_uniq = np.empty(rows.shape[0], np.int64)
        offset = 0
        for r in np.unique(rows):
            sel = np.nonzero(rows == r)[0]
            cnt = sel.shape[0]
            pad = (-cnt) % group
            pos_of_uniq[sel] = offset + np.arange(cnt)
            offset += cnt + pad
            new_rows.append(np.full(cnt + pad, r, np.int32))
            new_cols.append(np.concatenate([cols[sel], np.zeros(pad, np.int32)]))
            valid_parts.append(np.concatenate([np.ones(cnt, np.int32), np.zeros(pad, np.int32)]))
        rows = np.concatenate(new_rows)
        cols = np.concatenate(new_cols)
        grouped_valid = np.concatenate(valid_parts)
    p = rows.shape[0]
    p_pad = _bucket(p) if pair_rounding <= 0 else _round_up(p, pair_rounding)
    p_pad = _round_up(p_pad, group)
    pair_rows = np.full(p_pad, nb - 1, np.int32)
    pair_cols = np.zeros(p_pad, np.int32)
    pair_valid = np.zeros(p_pad, np.int32)
    pair_rows[:p] = rows
    pair_cols[:p] = cols
    pair_valid[:p] = grouped_valid
    # each edge slot -> its pair index (slots of no active pair -> pair 0)
    edge_key = key.ravel()
    idx = np.clip(np.searchsorted(uniq, edge_key), 0, uniq.shape[0] - 1)
    found = uniq[idx] == edge_key
    edge_pair = np.where(found, pos_of_uniq[idx], 0).astype(np.int32).reshape(n, k)
    return BlockStructure(
        pair_rows=pair_rows, pair_cols=pair_cols, pair_valid=pair_valid, edge_pair=edge_pair,
        block_size=block_size, n_padded=n_pad, key_sorted=uniq, key_pos=pos_of_uniq,
    )


def remap_frame(
    struct: BlockStructure, nlist: np.ndarray, edges: np.ndarray
) -> Optional[BlockStructure]:
    """Reuse a frame's block pattern for a new frame of the same
    trajectory: only the edge -> pair mapping is recomputed. None when
    the new frame's real edges leave the active pair set, or its padded
    size differs (the caller rebuilds)."""
    if struct.key_sorted is None:
        return None
    nlist = np.asarray(nlist)
    edges = np.asarray(edges)
    n, k = nlist.shape
    if _round_up(n, struct.block_size) != struct.n_padded:
        return None
    nb = struct.nb
    ib = np.arange(n, dtype=np.int64)[:, None] // struct.block_size
    key = (ib * nb + nlist // struct.block_size).ravel()
    idx = np.clip(np.searchsorted(struct.key_sorted, key), 0, struct.key_sorted.shape[0] - 1)
    found = struct.key_sorted[idx] == key
    if not (found | (edges.ravel() <= 0)).all():
        return None
    edge_pair = np.where(found, struct.key_pos[idx], 0).astype(np.int32).reshape(n, k)
    return struct._replace(edge_pair=edge_pair)


_PAIR_FIELDS = ("pair_rows", "pair_cols", "pair_valid", "row_ptr")


def struct_on_device(struct: BlockStructure, device) -> BlockStructure:
    """The structure with its pair arrays and the CSR offsets ``row_ptr``
    as int32 tensors on ``device``, copied once so the kernels of a forward
    do not each copy them. Host arrays are checked first: the rows sorted,
    every row and col block in [0, nb). ``edge_pair`` and the keys stay on
    the host."""
    if all(isinstance(getattr(struct, f), torch.Tensor) for f in _PAIR_FIELDS):
        return struct._replace(**{f: getattr(struct, f).to(device=device, dtype=torch.int32)
                                  for f in _PAIR_FIELDS})
    nb = struct.nb
    rows, cols, valid = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                         for a in (struct.pair_rows, struct.pair_cols, struct.pair_valid))
    p = rows.shape[0]
    if rows.shape != (p,) or cols.shape != (p,) or valid.shape != (p,):
        raise ValueError(f"pair arrays of shapes {rows.shape}, {cols.shape}, {valid.shape}")
    if p and (rows.min() < 0 or rows.max() >= nb or cols.min() < 0 or cols.max() >= nb):
        raise ValueError(f"pair rows and cols must lie in [0, {nb})")
    if np.any(np.diff(rows) < 0):
        raise ValueError("pair_rows must be sorted")
    row_ptr = np.searchsorted(rows, np.arange(nb + 1), side="left")
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)  # noqa: E731
    return struct._replace(pair_rows=as_dev(rows), pair_cols=as_dev(cols),
                           pair_valid=as_dev(valid), row_ptr=as_dev(row_ptr))


_PLAIN_PAIR_CHUNK = 1024

# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path, and the oracle each kernel is held
# against on the card (counterparts of build_block_adjacency /
# build_block_adjacency_pallas and mp_blocksparse_xla,
# nmrgnn_tpu/ops/blocksparse.py:182-293, 548-572).


def build_block_adjacency_plain(
    nlist: torch.Tensor,       # i32[N, K]
    edge_feats: torch.Tensor,  # f32[N, K, E] (EdgeFC output; 0 on padding)
    struct: BlockStructure,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """A [P, E, B, B] in ``out_dtype``: each valid pair's block, summed in
    float32 over the K slots in slot order (duplicate neighbors add) and
    rounded once; padding pairs are zero."""
    B, nb, P = struct.block_size, struct.nb, struct.n_pairs
    n, k = nlist.shape
    e = edge_feats.shape[-1]
    dev = edge_feats.device
    pad = struct.n_padded - n
    nl = nnf.pad(nlist.to(torch.int64), (0, 0, 0, pad), value=-1).view(nb, B, k)
    ef = nnf.pad(edge_feats.float(), (0, 0, 0, 0, 0, pad)).view(nb, B, k, e)
    pairs = torch.nonzero(as_long(struct.pair_valid, dev)).squeeze(1)  # the valid pairs
    rows = as_long(struct.pair_rows, dev)[pairs]
    rel = nl[rows] - (as_long(struct.pair_cols, dev)[pairs] * B)[:, None, None]  # [Pv, B, K]
    vals = ef[rows]                                                           # [Pv, B, K, E]
    A = torch.zeros((P, e, B, B), dtype=torch.float32, device=dev)
    blocks = A.permute(0, 2, 3, 1)  # [P, b, q, E], a view of A
    for j in range(k):  # slot order; within a slot each (pair, row) has one target
        i, b = ((rel[:, :, j] >= 0) & (rel[:, :, j] < B)).nonzero(as_tuple=True)
        blocks[pairs[i], b, rel[i, b, j]] += vals[i, b, j]
    return A.to(out_dtype)


# The block occupancy: which (32-row slab, 16-column chunk) pieces of each
# pair's block hold a nonzero. The MP kernel stages and multiplies only
# those of a block's slab (``csrc/mp.cuh``, kPairs); here one bit per
# (pair, slab, chunk), int32 [P, pair_words(B)], bit s * (B / 16) + c of
# a pair's words for slab s and chunk c (one word at B = 128).

_MAX_PAIR_B = 512  # block size the MP kernel's chunk list takes (B / 16 <= 32)


def _pair_bits(block_size: int) -> int:
    """Occupancy bits of a pair: (slabs) x (chunks)."""
    return (block_size // MP_ROWS) * (block_size // MP_CHUNK)


def pair_words(block_size: int) -> int:
    """Occupancy words of a pair of ``block_size`` x ``block_size``."""
    return (_pair_bits(block_size) + 31) // 32


def block_occupancy_plain(
    nlist: torch.Tensor,   # i32[N, K], N <= n_padded
    edges: torch.Tensor,   # f32[N, K] distances, 0 on padding slots
    struct: BlockStructure,
) -> torch.Tensor:
    """int32 [P, pair_words(B)]: a slot of row rB + b with a positive
    distance and target t occupies chunk (b // 32, (t % B) // 16) of the
    first valid pair (in pair order) of row block r whose col is t // B,
    the pair into which ``build_block_adjacency`` adds it. Exact for the
    forwards' edge values, which are zero where the distance is not
    positive."""
    B, nb, P = struct.block_size, struct.nb, struct.n_pairs
    dev = edges.device
    n, k = nlist.shape
    nch = B // MP_CHUNK
    bits = torch.zeros((P, _pair_bits(B)), dtype=torch.bool, device=dev)
    vidx = torch.nonzero(as_long(struct.pair_valid, dev) != 0).squeeze(1)
    if vidx.numel():
        keys = as_long(struct.pair_rows, dev)[vidx] * nb + as_long(struct.pair_cols, dev)[vidx]
        order = torch.sort(keys, stable=True).indices
        skeys, spair = keys[order], vidx[order]
        t = nlist.to(torch.int64)
        row = torch.arange(n, device=dev)[:, None].expand(n, k)
        hit = (edges > 0) & (t >= 0) & (t < nb * B)
        key = (row // B) * nb + t.clamp(0, nb * B - 1) // B
        pos = torch.searchsorted(skeys, key.reshape(-1)).clamp(max=skeys.numel() - 1)
        ok = hit.reshape(-1) & (skeys[pos] == key.reshape(-1))
        bit = ((row % B) // MP_ROWS * nch + (t % B) // MP_CHUNK).reshape(-1)
        bits[spair[pos][ok], bit[ok]] = True
    return pack_bits(bits)


def block_occupancy_from_adjacency_plain(A: torch.Tensor) -> torch.Tensor:
    """int32 [P, pair_words(B)]: the (slab, chunk) pieces of each pair's
    block of A [P, E, B, B] that hold a nonzero (in any channel)."""
    P, E, B, _ = A.shape
    nz = (A != 0).any(1).view(P, B // MP_ROWS, MP_ROWS, B // MP_CHUNK, MP_CHUNK)
    return pack_bits(nz.any(4).any(2).reshape(P, -1))


def _occupied_blocks(A: torch.Tensor, occupancy) -> torch.Tensor:
    """A with the pieces ``occupancy`` leaves out set to zero (A itself when
    it is None): what the MP kernel reads of A."""
    if occupancy is None:
        return A
    P, E, B, _ = A.shape
    if tuple(occupancy.shape) != (P, pair_words(B)):
        raise ValueError(f"occupancy of shape {tuple(occupancy.shape)} does not match A "
                         f"{tuple(A.shape)}")
    bits = occupancy_bits(occupancy.to(A.device), _pair_bits(B) * MP_CHUNK)
    keep = bits.view(P, B // MP_ROWS, 1, B // MP_CHUNK, 1).expand(
        P, B // MP_ROWS, MP_ROWS, B // MP_CHUNK, MP_CHUNK).reshape(P, 1, B, B)
    return A * keep.to(A.dtype)


def mp_blocksparse_plain(
    A: torch.Tensor,           # [P, E, B, B], in nodes.dtype
    struct: BlockStructure,
    nodes: torch.Tensor,       # [N_pad, F], float32 or bfloat16
    w: torch.Tensor,           # [F, F, E]
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    occupancy=None,            # i32[P, pair_words(B)], or None
) -> torch.Tensor:
    """One MP layer (activation(aggregate) + residual) over the pairs, in
    ``nodes.dtype``: operands in that type, products and sums in float32,
    h kept in float32 into the product with the weights (in the table's
    type), the residual added in float32 and the sum rounded once
    (``_mp_bs_kernel``, :327-338). _PLAIN_PAIR_CHUNK pairs at a time go
    into h [nb, E, B, F] with ``index_add_``: unchunked, the [P, E, B, F]
    products of 100,000 atoms would take 8.7 GB in float32. Given an
    ``occupancy``, A is read through it, as the kernel reads it."""
    A = _occupied_blocks(A, occupancy)
    P, E, B, _ = A.shape
    nb, F = struct.nb, nodes.shape[-1]
    dev, cd = nodes.device, nodes.dtype
    rows, cols = as_long(struct.pair_rows, dev), as_long(struct.pair_cols, dev)
    blocks = nodes.view(nb, B, F)
    h = torch.zeros((nb, E, B, F), dtype=torch.float32, device=dev)
    for s in range(0, P, _PLAIN_PAIR_CHUNK):
        c = slice(s, s + _PLAIN_PAIR_CHUNK)
        hp = torch.einsum("pebq,pqf->pebf", A[c].float(), blocks[cols[c]].float())
        h.index_add_(0, rows[c], hp)
    acc = torch.einsum("iebf,efm->ibm", h, w.permute(2, 0, 1).to(cd).float())
    out = get_activation(activation_name)(acc * inv_degree.view(nb, B, 1)) + blocks.float()
    return out.to(cd).view(nb * B, F)


# ---------------------------------------------------------------------------
# Kernel wrappers.


def _device_struct(struct: BlockStructure, device) -> BlockStructure:
    s = struct_on_device(struct, device)
    P = s.n_pairs
    for name in ("pair_rows", "pair_cols", "pair_valid"):
        check(f"struct.{name}", getattr(s, name), torch.int32, (P,), device)
    check("struct.row_ptr", s.row_ptr, torch.int32, (s.nb + 1,), device)
    return s


@kernel(build_block_adjacency_plain, on="edge_feats")
def build_block_adjacency(
    nlist: torch.Tensor,       # i32[N, K]
    edge_feats: torch.Tensor,  # f32[N, K, E] (EdgeFC output; 0 on padding)
    struct: BlockStructure,    # pair arrays as numpy or int32 tensors on the card
    out_dtype=torch.float32,
) -> torch.Tensor:
    """A [P, E, B, B] in ``out_dtype`` (float32 or bfloat16): the active
    adjacency blocks, padding pairs zero.

    Replaces ``_build_adj_kernel`` (nmrgnn_tpu/ops/blocksparse.py:
    215-293). On the card one block per pair; a warp takes a row, passes
    its K slots round by shuffle, and each lane sums four columns of every
    channel in slot order. It is bound by writing A."""
    dev = edge_feats.device
    n, k = nlist.shape
    e = edge_feats.shape[-1]
    B = struct.block_size
    check("nlist", nlist, torch.int32, (n, k), dev)
    check("edge_feats", edge_feats, torch.float32, (n, k, e), dev)
    if not (k >= 1 and B % 4 == 0 and n <= struct.n_padded):
        raise NotImplementedError("build_block_adjacency kernel takes B a multiple of 4")
    out_bf16 = bf16_flag("out_dtype", out_dtype)
    s = _device_struct(struct, dev)
    pad = struct.n_padded - n
    nlist_p = nnf.pad(nlist, (0, 0, 0, pad), value=-1)
    e_p = nnf.pad(edge_feats, (0, 0, 0, 0, 0, pad))
    A = torch.empty((s.n_pairs, e, B, B), dtype=out_dtype, device=dev)
    for c0, c1 in channel_groups(e):
        launch("nmr_build_block_adjacency", dev, nlist_p.data_ptr(), at(e_p, 2, c0),
               s.pair_rows.data_ptr(), s.pair_cols.data_ptr(), s.pair_valid.data_ptr(),
               at(A, 1, c0), s.n_pairs, s.nb, B, k, c1 - c0, out_bf16, e, e)
    return A


@kernel(block_occupancy_plain, on="edges")
def block_occupancy(
    nlist: torch.Tensor,     # i32[N, K], N <= n_padded
    edges: torch.Tensor,     # f32[N, K] distances, 0 on padding slots
    struct: BlockStructure,  # pair arrays as numpy or int32 tensors on the card
) -> torch.Tensor:
    """int32 [P, pair_words(B)]: the block occupancy of the adjacency that
    ``build_block_adjacency`` makes from (nlist, the forward's edge values)
    on this structure (``block_occupancy_plain`` says which bits). The
    forward makes it once per structure and frame and hands it to every
    layer.

    A kernel of the port with no TPU counterpart: it feeds the MP kernel
    that replaces B11 and B12 (``csrc/mp.cuh``, kPairs). On the card one
    thread takes a slot, scans its row block's pairs for the target's col
    block and sets the bit with an atomic OR into zeroed words; bound by
    reading nlist and the distances."""
    dev = edges.device
    n, k = nlist.shape
    B = struct.block_size
    check("nlist", nlist, torch.int32, (n, k), dev)
    check("edges", edges, torch.float32, (n, k), dev)
    if B % MP_ROWS or B > _MAX_PAIR_B or n > struct.n_padded:
        raise NotImplementedError(f"block_occupancy kernel takes B a multiple of {MP_ROWS} "
                                  f"up to {_MAX_PAIR_B}")
    s = _device_struct(struct, dev)
    occ = torch.zeros((s.n_pairs, pair_words(B)), dtype=torch.int32, device=dev)
    launch("nmr_block_occupancy", dev, nlist.data_ptr(), edges.data_ptr(),
           s.row_ptr.data_ptr(), s.pair_cols.data_ptr(), s.pair_valid.data_ptr(),
           occ.data_ptr(), n, k, s.nb, B, s.n_pairs)
    return occ


@kernel(block_occupancy_from_adjacency_plain, on="A")
def block_occupancy_from_adjacency(A: torch.Tensor) -> torch.Tensor:
    """int32 [P, pair_words(B)]: the block occupancy of A [P, E, B, B] read
    from A itself, for an MP call given no occupancy (the JAX package's
    signature).

    A kernel of the port with no TPU counterpart, feeding the MP kernel
    (``csrc/mp.cuh``, kPairs): one block a pair, one pass over A; bound by
    reading A."""
    dev = A.device
    P, E, B, _ = A.shape
    a_bf16 = bf16_flag("A", A.dtype)
    check("A", A, A.dtype, (P, E, B, B), dev)
    if B % MP_ROWS or B > _MAX_PAIR_B or P < 1:
        raise NotImplementedError(f"block_occupancy_from_adjacency kernel takes B a multiple "
                                  f"of {MP_ROWS} up to {_MAX_PAIR_B}")
    occ = torch.empty((P, pair_words(B)), dtype=torch.int32, device=dev)
    launch("nmr_block_occupancy_from_adjacency", dev, A.data_ptr(), occ.data_ptr(), P, E, B,
           a_bf16)
    return occ


def _launch_mp(A, struct, nodes, w, inv_degree, activation_name, what,
               occupancy) -> torch.Tensor:
    """Checks and launches the block-sparse MP layer (``csrc/mp.cuh``'s
    kernel in its kPairs mode, ``csrc/blocksparse.cu``): for each output
    block of the F-split, its chain of partial sums (no inv_degree) and its
    last launch with the epilogue, all through one entry point."""
    dev = nodes.device
    P, E, B, _ = A.shape
    n_table, F = nodes.shape
    if not mp_tiles_ok(B, B) or B > _MAX_PAIR_B:  # a pair's B columns are its window
        raise NotImplementedError(
            f"{what} kernel takes B a multiple of {MP_CHUNK} and of the rows per block, up "
            f"to {_MAX_PAIR_B}")
    if B != struct.block_size or n_table != struct.n_padded or P != struct.n_pairs:
        raise ValueError(f"A of shape {tuple(A.shape)} and nodes of {tuple(nodes.shape)} do "
                         f"not match the structure")
    suffix, act, table, w_b = operands("nodes", nodes, w, E, inv_degree, activation_name)
    check("A", A, nodes.dtype, (P, E, B, B), dev)
    fp = table.shape[1]
    fb = w_b.shape[-1]
    s = _device_struct(struct, dev)
    if occupancy is None:
        occ = block_occupancy_from_adjacency(A)
    else:
        occ = occupancy
        check("occupancy", occ, torch.int32, (P, pair_words(B)), dev)

    def step(inv, dtype):
        def run(i, j, c0, c1, acc):
            out = torch.empty((n_table, fb), dtype=dtype, device=dev)
            launch("nmr_mp_blocksparse" + suffix, dev, at(A, 1, c0), occ.data_ptr(),
                   s.row_ptr.data_ptr(), s.pair_cols.data_ptr(), col(table, i * fb),
                   at(w_b[i, j], 0, c0), inv, out.data_ptr(), P, s.nb, c1 - c0, B, fb, fp, act,
                   E, None if acc is None else acc.data_ptr())
            return out
        return run

    return chain(w_b.shape[0], channel_groups(E, mp_group_size(fp)), F,
                 step(None, torch.float32), step(inv_degree.data_ptr(), nodes.dtype))


def _mp_blocksparse_cpu(A, struct, nodes, w, inv_degree, activation_name="softplus", group=1,
                        occupancy=None):
    """``mp_blocksparse_plain`` of a call of either MP wrapper: the same
    function for every ``group``."""
    return mp_blocksparse_plain(A, struct, nodes, w, inv_degree, activation_name, occupancy)


def _grouped(A, struct, nodes, w, inv_degree, activation_name="softplus", group=1,
             occupancy=None):
    """``mp_blocksparse_grouped`` for a call with ``group`` > 1 on the card,
    which takes and counts it."""
    return mp_blocksparse_grouped if group > 1 else None


@kernel(_mp_blocksparse_cpu, on="nodes", route=_grouped)
def mp_blocksparse(
    A: torch.Tensor,           # [P, E, B, B] from build_block_adjacency, in nodes.dtype
    struct: BlockStructure,
    nodes: torch.Tensor,       # [N_pad, F] (padded to struct.n_padded), f32 or bf16
    w: torch.Tensor,           # [F, F, E] (cast to nodes.dtype)
    inv_degree: torch.Tensor,  # f32[N_pad]
    activation_name: str = "softplus",
    group: int = 1,
    occupancy=None,            # i32[P, pair_words(B)] from block_occupancy, or None
) -> torch.Tensor:
    """One MP layer (activation(aggregate) + residual) over the active
    pairs, in ``nodes.dtype`` (float32, or bfloat16 with float32 sums).
    ``group`` > 1 goes through ``mp_blocksparse_grouped``, for a structure
    built with that ``group``. ``occupancy`` is A's block occupancy
    (``block_occupancy``); without it the kernel's wrapper derives it from
    A (``block_occupancy_from_adjacency``).

    Replaces ``_mp_bs_kernel`` (nmrgnn_tpu/ops/blocksparse.py:301-338,
    446-504). On the card (``csrc/mp.cuh``, kPairs) a block takes 32 rows
    of one row block, lists the (pair, 16-column chunk) pieces of A its
    rows occupy over the row block's pairs (CSR offsets), stages only those
    (node rows and A chunk, ``cp.async``, 4 stages in float32, 6 in
    bfloat16) and walks their nonzeros with ``fmaf`` in ascending order;
    h stays float32 into the product with the weights (float32: CUDA
    cores; bfloat16: h split into two bfloat16 halves on the tensor
    cores), then the epilogue. In float32 the second product bounds it; in
    bfloat16 the bytes of the occupied chunks and of W."""
    return _launch_mp(A, struct, nodes, w, inv_degree, activation_name, "mp_blocksparse",
                      occupancy)


@kernel(_mp_blocksparse_cpu, on="nodes")
def mp_blocksparse_grouped(
    A: torch.Tensor,           # [P, E, B, B], P a multiple of group
    struct: BlockStructure,    # built with block_structure(..., group=group)
    nodes: torch.Tensor,
    w: torch.Tensor,
    inv_degree: torch.Tensor,
    activation_name: str = "softplus",
    group: int = 4,
    occupancy=None,
) -> torch.Tensor:
    """``mp_blocksparse`` over a structure whose rows' pair runs are padded
    to a multiple of ``group``; the same function.

    Replaces ``_mp_bs_kernel_grouped`` (nmrgnn_tpu/ops/blocksparse.py:
    341-443), which takes G pairs of one row block a grid step to amortise
    the TPU's per-step cost. On the card it launches ``mp_blocksparse``'s
    kernel: a block already walks all of its row block's pairs, and a
    padding pair (A = 0) occupies nothing, so it is never staged and the
    result equals ``mp_blocksparse``'s on the group-1 structure bit for
    bit. Bound as ``mp_blocksparse``."""
    if group < 1 or A.shape[0] % group:
        raise ValueError(f"{A.shape[0]} pairs are not whole groups of {group}")
    return _launch_mp(A, struct, nodes, w, inv_degree, activation_name, "mp_blocksparse_grouped",
                      occupancy)
