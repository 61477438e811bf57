"""The band builds' plain versions, the oracle the CUDA builds (B2, B4, B7,
B8: ``csrc/banded.cu``, ``csrc/poly.cu``) are held against bit for bit on
the card, against the JAX package's builds on the CPU (the Pallas kernels
in interpret mode, as tests/test_torch_tracedlo.py runs them) at the
shapes a block's row group meets: tiles of 8 and 6 rows (a block takes 4
and 2 of them), windows whose width is not a multiple of the 16-byte
vector, K of 1 and 128. Then the slot-order sum itself against a numpy
loop, and the rows-per-block rule. Inputs are made with numpy from a
seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops.edgefn import EdgeCheb as JEdgeCheb
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops.edgefn import EdgeCheb

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value


def _case(rows, k, e, seed, degree=24):
    """``rows`` rows of a banded graph, indices shifted by -40 so some are
    negative: duplicate indices, one row of a single index K times,
    padding slots, distances past the Chebyshev domain; edge values and
    Chebyshev coefficients."""
    rng = np.random.default_rng(seed)
    nlist = (np.arange(rows)[:, None] + rng.integers(-30, 30, (rows, k)) - 40).astype(np.int32)
    if k > 1:
        nlist[:, 0] = nlist[:, 1]
    nlist[3, :] = 5
    dists = rng.uniform(0.01, 0.45, (rows, k)).astype(np.float32)
    dists[rng.uniform(size=(rows, k)) < 0.2] = 0.0
    efeat = rng.normal(size=(rows, k, e)).astype(np.float32) * (dists > 0)[..., None]
    coeffs = (rng.normal(size=(degree + 1, e)) * 0.8 ** np.arange(degree + 1)[:, None])
    return nlist, dists, efeat, coeffs.astype(np.float32)


# (block rows, K, E, W): the row groups' edge shapes
SHAPES = [(8, 3, 3, 89), (6, 1, 2, 100), (8, 128, 1, 96), (64, 16, 4, 132)]


@pytest.mark.parametrize("build", ["band", "poly"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%d-K%d-E%d-W%d" % s)
def test_plain_builds_match_jax_at_row_group_edges(build, shape):
    """Within 1e-5 in float32 (the Chebyshev values are rounded at other
    steps by XLA) and one bfloat16 step in bfloat16 (both round the same
    float32 sum once)."""
    block_rows, k, e, window = shape
    rows = 2 * block_rows
    nlist, dists, efeat, coeffs = _case(rows, k, e, seed=block_rows + k)
    lo = np.array([-40, block_rows - 60], np.int32)
    for dtype in ("float32", "bfloat16"):
        if build == "band":
            want = jb.build_band_tracedlo(jnp.asarray(nlist), jnp.asarray(efeat), jnp.asarray(lo),
                                          window, block_rows, out_dtype=jnp.dtype(dtype),
                                          interpret=True)
            got = tb.build_band_tracedlo(torch.from_numpy(nlist), torch.from_numpy(efeat), lo,
                                         window, block_rows, out_dtype=getattr(torch, dtype))
        else:
            jcheb = JEdgeCheb(coeffs=coeffs, d_lo=0.0, d_hi=0.35)
            want = jb.build_band_poly_tracedlo(jnp.asarray(nlist), jnp.asarray(dists), jcheb,
                                               jnp.asarray(lo), window, block_rows,
                                               out_dtype=jnp.dtype(dtype), interpret=True)
            got = tb.build_band_poly_tracedlo(torch.from_numpy(nlist), torch.from_numpy(dists),
                                              EdgeCheb(coeffs=coeffs, d_lo=0.0, d_hi=0.35), lo,
                                              window, block_rows, out_dtype=getattr(torch, dtype))
        assert tuple(got.shape) == (2, e, block_rows, window) and got.dtype == getattr(torch, dtype)
        assert float(got.float().abs().sum()) > 0
        rtol = 1e-5 if dtype == "float32" else BF16_STEP
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_band_sums_in_slot_order(dtype):
    """The plain band equals a numpy loop that adds each slot's values in
    slot order from 0 in float32 (duplicate indices add, indices outside
    the window match nothing), rounded once: the sum the CUDA builds
    take, so they equal it bit for bit."""
    nlist, _, efeat, _ = _case(16, 40, 3, seed=2)
    nlist[5, :] = 7          # one column hit 40 times
    efeat[5] *= (10.0 ** (np.arange(40) % 7 - 3))[:, None].astype(np.float32)  # mixed sizes
    lo = np.array([-45, -30], np.int32)
    window = 37
    want = np.zeros((2, 3, 8, window), np.float32)
    for r in range(16):
        t, b = divmod(r, 8)
        for j in range(40):
            w = nlist[r, j] - lo[t]
            if 0 <= w < window:
                want[t, :, b, w] = want[t, :, b, w] + efeat[r, j]
    got = tb.build_band_tracedlo_plain(torch.from_numpy(nlist), torch.from_numpy(efeat), lo,
                                       window, 8, out_dtype=dtype)
    assert torch.equal(got, torch.from_numpy(want).to(dtype))


@pytest.mark.parametrize("block_rows,rows", [
    (128, 4), (64, 4), (8, 4), (4, 4), (6, 2), (2, 2), (5, 1), (1, 1),
])
def test_build_rows_divides_the_tile(block_rows, rows):
    """A block of the band builds takes 4 rows of a tile, or the largest
    power of two below 4 that divides the tile's rows."""
    assert tb.build_rows(block_rows) == rows
    assert block_rows % rows == 0
