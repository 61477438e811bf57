"""The block occupancy of the block-sparse adjacency (``ops/blocksparse.py``:
``block_occupancy``), the map of (pair, 32-row slab, 16-column chunk)
pieces of A that the MP kernel (``csrc/mp.cuh``, kPairs) stages and
multiplies, on the CPU through the plain versions.

The occupancy the forward makes from nlist, the distances and the pairs
must be exact: every nonzero of A, as ``build_block_adjacency`` makes it
from edge values that are zero on padding slots, lies in a marked piece.
On these graphs (no entry of A that sums to zero) it equals the occupancy
read from A itself, word for word, padding pairs empty, on group-1 and
group-4 structures, at other block sizes and on a ``remap_frame`` frame.
An MP layer given the occupancy equals the layer without it bit for bit,
and the JAX package's layer.

Graphs are made with numpy from a seed: random neighbors (many pairs a row
block) and banded ones (nlist = i + randint(-40, 40), as
``tests/test_banded.py:187-192``), with padding slots (distance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.graph import inv_degree_from_nlist as jinv_degree
from nmrgnn_tpu.ops import blocksparse as jbs
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import blocksparse as tbs

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value


def graph(kind, n=600, k=12, seed=0, e=3):
    """(nlist, dists, efeat) with padding slots, efeat zero on them."""
    rng = np.random.default_rng(seed)
    if kind == "banded":
        nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    else:
        nlist = rng.integers(0, n, (n, k))
    nlist = nlist.astype(np.int32)
    nlist[:, 0] = nlist[:, 1]  # duplicate neighbors
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    dists[rng.uniform(size=(n, k)) < 0.15] = 0.0  # padding slots, index kept
    dists[5, :] = 0.0
    efeat = rng.normal(size=(n, k, e)).astype(np.float32) * (dists > 0)[..., None]
    return nlist, dists, efeat


def tens(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def covers(occ, A):
    """Whether every nonzero of A [P, E, B, B] lies in a piece of occ, and
    A has one."""
    got = tbs.block_occupancy_from_adjacency_plain(A)
    return bool((got != 0).any()) and not bool((got & ~occ).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("kind", ["random", "banded"])
def test_occupancy_from_nlist_is_exact(kind, group, dtype):
    """Covers every nonzero of the plain adjacency, equals the occupancy
    read from it word for word (one word a pair at B = 128), padding pairs
    empty; the wrappers on CPU tensors launch nothing."""
    nlist, dists, efeat = graph(kind, seed=group)
    s = tbs.block_structure(nlist, dists, 128, pair_rounding=32, group=group)
    nl, d, ef = tens(nlist, dists, efeat)
    A = tbs.build_block_adjacency_plain(nl, ef, s, out_dtype=dtype)
    _cuda.reset_launch_counts()
    occ = tbs.block_occupancy(nl, d, s)
    from_a = tbs.block_occupancy_from_adjacency(A)
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
    assert occ.dtype == torch.int32 and tuple(occ.shape) == (s.n_pairs, 1)
    assert covers(occ, A)
    assert torch.equal(occ, from_a)
    assert torch.equal(occ, tbs.block_occupancy_plain(nl, d, s))
    invalid = torch.from_numpy(s.pair_valid == 0)
    assert invalid.any() and not occ[invalid].any()
    # every real slot marks one piece: no more than the real slots
    assert int(sum(bin(int(v) & 0xFFFFFFFF).count("1") for v in occ.flatten())) <= int(
        (dists > 0).sum())


@pytest.mark.parametrize("block_size,words", [(32, 1), (64, 1), (256, 4)])
def test_occupancy_at_other_block_sizes(block_size, words):
    """pair_words(B) words a pair, slab s of chunk c at bit s * (B / 16) +
    c; exact and equal to A's own at B = 32, 64 and 256."""
    nlist, dists, efeat = graph("banded", n=520, k=9, seed=block_size)
    s = tbs.block_structure(nlist, dists, block_size, group=2)
    nl, d, ef = tens(nlist, dists, efeat)
    A = tbs.build_block_adjacency_plain(nl, ef, s)
    occ = tbs.block_occupancy_plain(nl, d, s)
    assert tbs.pair_words(block_size) == words and tuple(occ.shape) == (s.n_pairs, words)
    assert covers(occ, A)
    assert torch.equal(occ, tbs.block_occupancy_from_adjacency_plain(A))


def test_occupancy_bit_layout():
    """One real slot: row 70 (slab 2 of row block 0) to atom 200 (col block
    1, chunk 4) sets bit 2 * 8 + 4 of pair (0, 1) and nothing else; the
    same slot as padding (distance 0), or given to the -1 of a padded row,
    sets nothing."""
    n, k = 256, 2
    nlist = np.full((n, k), 3, np.int32)
    dists = np.zeros((n, k), np.float32)
    nlist[70, 1], dists[70, 1] = 200, 0.1
    s = tbs.block_structure(nlist, dists, 128)
    pair = int(np.nonzero((s.pair_rows == 0) & (s.pair_cols == 1) & (s.pair_valid == 1))[0][0])
    nl, d = tens(nlist, dists)
    occ = tbs.block_occupancy_plain(nl, d, s)
    want = torch.zeros_like(occ)
    want[pair, 0] = 1 << (2 * 8 + 4)
    assert torch.equal(occ, want)
    d[70, 1] = 0.0
    assert not tbs.block_occupancy_plain(nl, d, s).any()
    d[70, 1] = 0.1
    nl[70, 1] = -1
    assert not tbs.block_occupancy_plain(nl, d, s).any()


def test_occupancy_of_a_remapped_frame():
    """A later frame served on the first frame's pairs (``remap_frame``)
    gets its own occupancy: exact for its adjacency, equal to A's own, and
    not the first frame's."""
    nlist, dists, efeat = graph("banded", seed=3)
    s0 = tbs.block_structure(nlist, dists, 128, pair_rounding=32, group=4)
    rng = np.random.default_rng(4)
    moved = np.clip(nlist + rng.integers(-3, 4, nlist.shape), 0, nlist.shape[0] - 1)
    moved = moved.astype(np.int32)
    moved_d = np.where(rng.uniform(size=dists.shape) < 0.1, 0.0, dists).astype(np.float32)
    s1 = tbs.remap_frame(s0, moved, moved_d)
    assert s1 is not None and s1.pair_rows is s0.pair_rows
    ef1 = efeat * (moved_d > 0)[..., None]
    nl, d, ef = tens(moved, moved_d, ef1)
    A1 = tbs.build_block_adjacency_plain(nl, ef, s1)
    occ1 = tbs.block_occupancy_plain(nl, d, s1)
    assert covers(occ1, A1)
    assert torch.equal(occ1, tbs.block_occupancy_from_adjacency_plain(A1))
    assert not torch.equal(occ1, tbs.block_occupancy_plain(*tens(nlist, dists), s0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 4])
def test_mp_given_the_occupancy_matches_jax(group, dtype):
    """The plain MP layer reading A through the occupancy equals the one
    reading all of A bit for bit (every nonzero lies in a marked piece),
    and the JAX package's layer: float32 within 2e-4, bfloat16 within one
    bfloat16 step of the output's scale."""
    n = 520
    nlist, dists, efeat = graph("random", n=n, k=11, seed=8)
    rng = np.random.default_rng(9)
    f = 128
    nodes = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, 3)) / np.sqrt(f)).astype(np.float32)
    inv = np.asarray(jinv_degree(jnp.asarray(nlist)))
    js = jbs.block_structure(nlist, dists, 128, group=group)
    ts = tbs.block_structure(nlist, dists, 128, group=group)
    A = jbs.build_block_adjacency_pallas(jnp.asarray(nlist), jnp.asarray(efeat), js,
                                         interpret=True)
    pad = ts.n_padded - n
    nodes_p, inv_p = np.pad(nodes, ((0, pad), (0, 0))), np.pad(inv, (0, pad))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jbs.mp_blocksparse(A.astype(jd), js, jnp.asarray(nodes_p).astype(jd),
                              jnp.asarray(w).astype(jd), jnp.asarray(inv_p), interpret=True,
                              group=group)
    tA = torch.from_numpy(np.array(A)).to(td)
    x, wt, iv = torch.from_numpy(nodes_p).to(td), torch.from_numpy(w), torch.from_numpy(inv_p)
    occ = tbs.block_occupancy(*tens(nlist, dists), ts)
    assert occ.any() and not bool((occ == -1).all())
    _cuda.reset_launch_counts()
    got = tbs.mp_blocksparse(tA, ts, x, wt, iv, group=group, occupancy=occ)
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
    assert torch.equal(got, tbs.mp_blocksparse_plain(tA, ts, x, wt, iv))
    want = np.asarray(want.astype(jnp.float32))
    tol = 2e-4 if dtype == "float32" else BF16_STEP * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-4, atol=tol)
    with pytest.raises(ValueError):  # an occupancy of another structure
        tbs.mp_blocksparse_plain(tA, ts, x, wt, iv, occupancy=occ[:-1])
