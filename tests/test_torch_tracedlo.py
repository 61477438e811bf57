"""The band builds with a caller-given window start per tile
(``build_band_tracedlo``, ``build_band_poly_tracedlo``: B7) against the JAX
package's on the CPU, the Pallas kernels in interpret mode: with the plan's
window starts, with indices and window starts shifted by -m (negative),
and with the halo band's inputs (out-of-window and negative indices). Then
the composition the partitioned forward makes of them
(nmrgnn_tpu/parallel/halo.py:609-645): for the rows of a 2-way split at m,
the interior band through ``mp_banded_partial`` on table[:m] plus the halo
band through it on table[m:] equals one ``mp_banded_partial`` over the
full band. Inputs are made with numpy from a seed."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops.edgefn import EdgeCheb as JEdgeCheb
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops.edgefn import EdgeCheb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import split_windows  # noqa: E402

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value
N, K, E, F, DEGREE = 768, 16, 3, 128, 24


@pytest.fixture(scope="module")
def case():
    """A banded graph with duplicate neighbors, an all-index-0 row, padding
    slots and distances past the Chebyshev domain; its edge features and
    Chebyshev coefficients; the plan; the split point m (half the rows,
    rounded to whole tiles) and the split's window starts."""
    rng = np.random.default_rng(5)
    nlist = np.clip(np.arange(N)[:, None] + rng.integers(-40, 40, (N, K)), 0, N - 1)
    nlist = nlist.astype(np.int32)
    nlist[:, 0] = nlist[:, 1]  # duplicate neighbors
    nlist[7, :] = 0            # index-0 neighbors
    dists = rng.uniform(0.01, 0.45, (N, K)).astype(np.float32)  # d_hi is 0.35
    dists[rng.uniform(size=(N, K)) < 0.2] = 0.0  # padding slots
    efeat = rng.normal(size=(N, K, E)).astype(np.float32) * (dists > 0)[..., None]
    coeffs = (rng.normal(size=(DEGREE + 1, E)) * 0.8 ** np.arange(DEGREE + 1)[:, None])
    coeffs = coeffs.astype(np.float32)
    plan = tb.band_plan(nlist, dists)
    assert plan.n_padded == N
    B, W = plan.block_rows, plan.window
    m = (N // 2 + B - 1) // B * B
    lo_int, lo_halo = split_windows(plan.lo[: m // B], m, W, N)
    return dict(nlist=nlist, dists=dists, efeat=efeat, plan=plan, m=m, lo_int=lo_int,
                lo_halo=lo_halo, jcheb=JEdgeCheb(coeffs=coeffs, d_lo=0.0, d_hi=0.35),
                tcheb=EdgeCheb(coeffs=coeffs, d_lo=0.0, d_hi=0.35))


def _inputs(case, which):
    """(nlist, lo, window) of the plan's band, the same shifted by -m, or
    the halo band of the rows [0, m) (indices shifted by -m)."""
    nl, lo, m, W = case["nlist"], case["plan"].lo, case["m"], case["plan"].window
    return {"plan": (nl, lo, W), "shifted": (nl - m, lo - m, W),
            "halo": (nl[:m] - m, case["lo_halo"], W)}[which]


def _build(pkg, build, case, nl, lo, window, dtype):
    rows = nl.shape[0]
    B = case["plan"].block_rows
    if pkg == "jax":
        jdt = jnp.dtype(dtype)
        if build == "band":
            M = jb.build_band_tracedlo(jnp.asarray(nl), jnp.asarray(case["efeat"][:rows]),
                                       jnp.asarray(lo), window, B, out_dtype=jdt,
                                       interpret=True)
        else:
            M = jb.build_band_poly_tracedlo(jnp.asarray(nl), jnp.asarray(case["dists"][:rows]),
                                            case["jcheb"], jnp.asarray(lo), window, B,
                                            out_dtype=jdt, interpret=True)
        return np.asarray(M.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    if build == "band":
        M = tb.build_band_tracedlo(torch.from_numpy(nl), torch.from_numpy(case["efeat"][:rows]),
                                   lo, window, B, out_dtype=tdt)
    else:
        M = tb.build_band_poly_tracedlo(torch.from_numpy(nl),
                                        torch.from_numpy(case["dists"][:rows]), case["tcheb"],
                                        lo, window, B, out_dtype=tdt)
    assert M.dtype == tdt
    return M.float().numpy()


@pytest.mark.parametrize("which", ["plan", "shifted", "halo"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("build", ["band", "poly"])
def test_tracedlo_builds_match_jax(case, build, dtype, which):
    """Within 1e-5 (float32) or one bfloat16 step (both round the same
    float32 sum once). Shifting indices and window starts by -m changes
    no band entry."""
    nl, lo, W = _inputs(case, which)
    _cuda.reset_launch_counts()
    got = _build("torch", build, case, nl, lo, W, dtype)
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)  # the plain versions on the CPU
    want = _build("jax", build, case, nl, lo, W, dtype)
    rtol = 1e-5 if dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)
    if which == "shifted":
        np.testing.assert_array_equal(got, _build("torch", build, case, *_inputs(case, "plan"),
                                                  dtype))
    if which == "halo":
        assert np.abs(got).max() > 0  # the split leaves some neighbors in the halo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("build", ["band", "poly"])
def test_interior_plus_halo_equals_the_full_band(case, build, dtype):
    """The interior band (windows clipped into [0, m), indices >= m
    excluded) through mp_banded_partial on table[:m], plus the halo band
    (indices - m, interior ones negative) through it on table[m:], equals
    one mp_banded_partial over the full band: within 2e-4 in float32; in
    bfloat16 h is rounded per band, so within one step relative to the
    output's scale."""
    rng = np.random.default_rng(1)
    tdt = getattr(torch, dtype)
    table = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)).to(tdt)
    w = torch.from_numpy((rng.normal(size=(F, F, E)) / np.sqrt(F)).astype(np.float32))
    plan, m = case["plan"], case["m"]
    T_m = m // plan.block_rows
    full = torch.from_numpy(_build("torch", build, case, *_inputs(case, "plan"), dtype)).to(tdt)
    interior = _build("torch", build, case, case["nlist"][:m], case["lo_int"], plan.window,
                      dtype)
    halo = _build("torch", build, case, *_inputs(case, "halo"), dtype)
    got = (tb.mp_banded_partial(torch.from_numpy(interior).to(tdt), case["lo_int"], table[:m], w)
           + tb.mp_banded_partial(torch.from_numpy(halo).to(tdt), case["lo_halo"], table[m:], w))
    want = tb.mp_banded_partial(full[:T_m], plan.lo[:T_m], table, w)
    atol = 2e-4 if dtype == "float32" else BF16_STEP * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=atol)


def test_tracedlo_builds_take_whole_tiles(case):
    """M must be a multiple of block_rows, as the JAX package asserts
    (banded.py:803, :1386); the wrappers do not pad."""
    nl = torch.from_numpy(case["nlist"][:200])
    with pytest.raises(ValueError, match="whole"):
        tb.build_band_tracedlo(nl, torch.from_numpy(case["efeat"][:200]), np.zeros(2, np.int32),
                               256)
    with pytest.raises(ValueError, match="whole"):
        tb.build_band_poly_tracedlo(nl, torch.from_numpy(case["dists"][:200]), case["tcheb"],
                                    np.zeros(2, np.int32), 256)
