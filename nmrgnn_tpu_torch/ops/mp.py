"""The MP kernel's launch protocol (``csrc/mp.cuh``): its widths, its
operands and its chains of launches, shared by every wrapper that launches
it (``ops/banded.py``'s ``mp_banded``, ``mp_banded_partial``,
``mp_banded_hbm``, ``mp_banded_hbm_cls`` and ``mp_banded_poly_fused``;
``ops/blocksparse.py``'s ``mp_blocksparse`` and
``mp_blocksparse_grouped``).

The kernel is instantiated for a few widths. Every other width that the
JAX package's path rule sends to it is adapted to them exactly, on the
card, by these plain functions on tensors:

* node features F: the node table and w are zero-padded to the next width
  of ``_MP_F`` (a padded input column meets a zero row of w) and the output
  is sliced back (its padded columns hold act(0) + 0); past 512, to a
  multiple of ``_MP_SPLIT``, run as column blocks (the F-split, below);
* edge channels E: a launch takes at most ``MAX_E`` channels
  (``_MP_WIDE_E`` at F = 512); more run as channel groups. The band builds
  write each group's channels of one M; an MP layer runs its groups'
  partial sums in order, each launch adding the float32 sum of the groups
  before it (acc_in), and the last launch ends in the epilogue;
* the F-split: a table wider than 512 runs in column blocks of
  ``_MP_SPLIT``. An output block j sums, through the same acc_in chain,
  the launches of every input block i (the table's columns [i fb, +fb),
  read through a row stride, against w's block (i, j)) and channel group,
  input block j last, so that its last launch reads its residual from the
  columns it writes and ends in the epilogue on the full sum. The output
  blocks are joined after their chains (``chain``).

The kernel reads a band's chunk occupancy, one bit per (row, 16-column
chunk), packed into int32 words (``pack_bits``, ``occupancy_bits``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as nnf

from ._cuda import check, dtype_suffix
from .activations import activation_code

MAX_E = 4           # edge channels a launch takes (more run as channel groups)
_MP_F = (64, 128, 256, 512)  # node widths the MP kernel is instantiated for
_MP_SPLIT = 256     # column block of a wider node table (the F-split)
_MP_WIDE_E = 2      # edge channels a launch takes at F = 512
MP_CHUNK = 16       # window columns of an occupancy bit
MP_ROWS = 32        # rows per block of the MP kernel


def channel_groups(n: int, size: int = MAX_E) -> list:
    """[(c0, c1), ...]: ``n`` channels in groups of at most ``size``, in
    order."""
    return [(c0, min(c0 + size, n)) for c0 in range(0, n, size)]


def mp_width(F: int) -> int:
    """The MP kernel's width a node table of ``F`` features is padded to:
    64, 128, 256 or 512, and past 512 the next multiple of 256, run as
    column blocks (``mp_split``).

    Any F is taken. The JAX package's budgets send F past 512 to its MP
    kernels: ``plan_fits_vmem`` at one edge channel lets F reach 1,701
    (float32) and 2,407 (bfloat16) on the smallest plan (64 rows, W = 256),
    ``hbm_plan_fits_vmem`` 1,421 and 2,147, and its block-sparse path
    applies no width budget at all."""
    if F < 1:
        raise ValueError(f"a node table needs at least one feature, not {F}")
    for f in _MP_F:
        if F <= f:
            return f
    return -(-F // _MP_SPLIT) * _MP_SPLIT


def mp_split(fp: int) -> Tuple[int, int]:
    """(block width, blocks) of a node table padded to ``fp``: one block
    up to 512, else blocks of _MP_SPLIT."""
    fb = fp if fp <= _MP_F[-1] else _MP_SPLIT
    return fb, fp // fb


def mp_group_size(F: int) -> int:
    """Edge channels one MP launch takes at padded width ``F``."""
    return _MP_WIDE_E if mp_split(F)[0] > 256 else MAX_E


def mp_split_steps(nb: int, groups) -> list:
    """[(j, [(i, (c0, c1)), ...]), ...]: for each output block j of an
    F-split in ``nb`` blocks, the launches of its chain in order, input
    block j last, each input block's channel ``groups`` in order."""
    return [(j, [(i, g) for i in [*range(j), *range(j + 1, nb), j] for g in groups])
            for j in range(nb)]


def pad_columns(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with its last axis zero-padded to ``width`` (``x`` itself
    when it is that wide)."""
    return x if x.shape[-1] == width else nnf.pad(x, (0, width - x.shape[-1]))


def pad_mp_weights(w: torch.Tensor, width: int) -> torch.Tensor:
    """MP weights [F, F, E] zero-padded to [width, width, E]."""
    f = w.shape[0]
    return w if f == width else nnf.pad(w, (0, 0, 0, width - f, 0, width - f))


def mp_tiles_ok(B: int, W: int) -> bool:
    """Whether the MP kernel takes these tiles: B a multiple of the rows
    per block, W of the chunk (any F and E, through the width helpers)."""
    return B % MP_ROWS == 0 and W % MP_CHUNK == 0


def occupancy_words(window: int) -> int:
    """Occupancy words of a band row of ``window`` columns."""
    return (window // MP_CHUNK + 31) // 32


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [R, nw] -> int32 [R, ceil(nw / 32)], bit b of word j = bits[:, 32 j + b]."""
    r, nw = bits.shape
    nwords = (nw + 31) // 32
    b = nnf.pad(bits.to(torch.int64), (0, nwords * 32 - nw)).view(r, nwords, 32)
    words = (b << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def occupancy_bits(occ: torch.Tensor, window: int) -> torch.Tensor:
    """int32 [R, NW] -> bool [R, W / 16]: the chunks each row occupies."""
    nw = window // MP_CHUNK
    w = occ.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> torch.arange(32, device=occ.device)) & 1
    return bits.view(occ.shape[0], -1)[:, :nw].bool()


def _mp_weights(w, dtype, E: int, fp: int, device) -> torch.Tensor:
    """w [fp, fp, E] (padded) in the MP kernel's layout and ``dtype``, as
    blocks [nb, nb, E, fb, fb] of the F-split (``mp_split``; one block up
    to 512): block (i, j) holds the rows of input block i and the columns
    of output block j, float32 [E, F_in, F_out] (rows of W_n streamed
    through shared memory) or bfloat16 [E, F_out, F_in] (the tensor
    cores' B fragments, k contiguous)."""
    fb, nb = mp_split(fp)
    wb = w.reshape(nb, fb, nb, fb, E)  # (in block, in, out block, out, E)
    wb = wb.permute(0, 2, 4, 1, 3) if dtype == torch.float32 else wb.permute(0, 2, 4, 3, 1)
    wb = wb.to(dtype).contiguous()
    check("w", wb, dtype, (nb, nb, E, fb, fb), device)
    return wb


def operands(name: str, table: torch.Tensor, w: torch.Tensor, E: int, inv_degree=None,
             activation_name=None):
    """(entry-point suffix, activation code, ``table`` padded to the
    kernel's width, ``w`` in the kernel's layout at that width) of an MP
    call on the card, its operands checked: the node table [Nt, F] float32
    or bfloat16 (``name`` in errors), w [F, F, E] (cast to its type), and
    for a call that ends in the epilogue ``inv_degree`` f32[Nt] and the
    activation (a partial call passes neither and gets no code)."""
    dev = table.device
    n_table, F = table.shape
    suffix = dtype_suffix(name, table.dtype)
    check(name, table, table.dtype, (n_table, F), dev)
    act = None
    if inv_degree is not None:
        check("inv_degree", inv_degree, torch.float32, (n_table,), dev)
        act = activation_code(activation_name)
    fp = mp_width(F)
    return (suffix, act, pad_columns(table, fp),
            _mp_weights(pad_mp_weights(w, fp), table.dtype, E, fp, dev))


def chain(nb: int, groups, F: int, partial, final=None) -> torch.Tensor:
    """An MP call's launches in the order the kernel relies on
    (``mp_split_steps``): for each of the ``nb`` output blocks j of the
    F-split, ``partial(i, j, c0, c1, acc)`` for each launch of its chain
    but the last, each returning its float32 sum and ``acc`` the sum of
    the launches before it (None on the chain's first), then
    ``final(j, j, c0, c1, acc)``, which ends in the epilogue (``partial``
    again for a call with none). Returns the output blocks joined, cut to
    ``F`` columns."""
    outs = []
    for j, steps in mp_split_steps(nb, groups):
        acc = None
        for n, (i, (c0, c1)) in enumerate(steps):
            step = final if final is not None and n == len(steps) - 1 else partial
            acc = step(i, j, c0, c1, acc)
        outs.append(acc)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out if out.shape[1] == F else out[:, :F].contiguous()
