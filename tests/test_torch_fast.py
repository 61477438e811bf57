"""The port's "fast" precision pieces against the JAX package's, on the CPU:
the compute-dtype repair of the gather forward, the Chebyshev fit of the
edge stage, the class-bucketed band plans, and the plain version of each
new kernel (Chebyshev band builds, partial MP, bfloat16 MP) against the
Pallas kernel in interpret mode. Inputs are made with numpy from a seed
and fed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.models import gnn as jgnn
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops import edgefn as jedgefn
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import load_model
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops import edgefn as tedgefn

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7  # bfloat16 keeps 7 fraction bits: one step is at most 2^-7 of a value


@pytest.fixture(scope="module")
def bundled():
    jparams, jcfg = jload_model()
    params, cfg = load_model(device="cpu")
    return jparams, jcfg, params, cfg


def fit(params, cfg, module):
    return module.fit_edge_chebyshev(
        params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
        rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation, degree=64,
    )


@pytest.fixture(scope="module")
def chebs(bundled):
    jparams, jcfg, params, cfg = bundled
    return fit(jparams, jcfg, jedgefn), fit(params, cfg, tedgefn)


def skewed_case(n=520, k=12, seed=7, spread_hi=180):
    """A banded graph with a skewed window distribution: every fourth atom
    reaches ``spread_hi`` rows away (the tests/test_banded.py generator),
    so band_plan_classes makes more than one class."""
    rng = np.random.default_rng(seed)
    spread = np.where(np.arange(n) % 4 == 0, spread_hi, 30)
    nlist = np.clip(
        np.arange(n)[:, None] + rng.integers(-1, 2, (n, k)) * spread[:, None]
        + rng.integers(-20, 20, (n, k)), 0, n - 1,
    ).astype(np.int32)
    dists = rng.uniform(0.01, 0.19, (n, k)).astype(np.float32)
    dists[:, -2:] = 0.0
    return nlist, dists


def adversarial_case(n=300, k=9, seed=0, banded=True):
    """Duplicate neighbors, padding slots, index-0 neighbors and distances
    on both sides of the Chebyshev domain."""
    rng = np.random.default_rng(seed)
    if banded:
        nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    else:
        nlist = rng.integers(0, n, (n, k))
    nlist = nlist.astype(np.int32)
    nlist[:, 0] = nlist[:, 1]  # duplicate neighbors
    nlist[7, :] = 0            # index-0 neighbors
    dists = rng.uniform(0.01, 0.45, (n, k)).astype(np.float32)  # d_hi is ~0.35
    dists[rng.uniform(size=(n, k)) < 0.2] = 0.0  # padding slots
    dists[5, :] = 0.0
    return nlist, dists


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the compute_dtype repair --------------------------------------------------


def test_gather_forward_bf16_matches_jax(bundled):
    """gnn.apply at compute_dtype="bfloat16" casts the products' operands
    as the JAX package does (edge stage, MP layers, FC block; the head
    stays float32). Before the repair the port computed in float32 and
    differed from JAX by a mean 0.084 ppm here (max 1.53 ppm). The two
    frameworks sum the products in other orders, and a float32 sum that
    lands near a bfloat16 rounding boundary rounds the other way, so the
    repaired port still differs by such flips: measured mean 0.0026 ppm,
    max 0.27 ppm. Tolerance: mean 0.02 ppm and max 1.0 ppm (the JAX
    package's own exact-vs-fast atol)."""
    jparams, jcfg, params, cfg = bundled
    rng = np.random.default_rng(11)
    n, k = 200, 16
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5, 6], n)]
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-30, 30, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    edges = rng.uniform(0.09, 0.3, (n, k)).astype(np.float32)
    edges[rng.uniform(size=(n, k)) < 0.05] = 0.0
    g = (atoms, nlist, edges, inv_degree_from_nlist(nlist))
    want = np.asarray(jgnn.apply(jparams, jcfg.replace(compute_dtype="bfloat16"),
                                 JGraph(*map(jnp.asarray, g))))
    with torch.no_grad():
        got = gnn.apply(params, cfg.replace(compute_dtype="bfloat16"),
                        Graph(*map(torch.from_numpy, g))).numpy()
    diff = np.abs(got - want)
    assert diff.mean() < 0.02, diff.mean()
    assert diff.max() < 1.0, diff.max()


def test_dense_emulates_bf16_operands_with_f32_sums():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    p = {"kernel": rng.normal(size=(96, 32)).astype(np.float32),
         "bias": rng.normal(size=(32,)).astype(np.float32)}
    from nmrgnn_tpu.models.gnn import _dense as jdense

    want = np.asarray(jdense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             compute_dtype=jnp.bfloat16))
    got = gnn.dense({k: _t(v) for k, v in p.items()}, _t(x),
                    compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # float32 sums
    f32 = gnn.dense({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    assert np.abs(f32 - want).max() > 1e-2  # the cast is not a no-op


# -- the Chebyshev edge stage ------------------------------------------------


def test_chebyshev_fit_is_bitwise_equal(bundled, chebs):
    jcheb, tcheb = chebs
    assert tcheb.degree == jcheb.degree == 64
    assert tcheb.coeffs.dtype == np.float32
    np.testing.assert_array_equal(tcheb.coeffs, jcheb.coeffs)
    assert (tcheb.d_lo, tcheb.d_hi) == (jcheb.d_lo, jcheb.d_hi)
    d = np.random.default_rng(3).uniform(0.0, 0.45, 500)
    np.testing.assert_array_equal(tedgefn.eval_edge_chebyshev(tcheb, d),
                                  jedgefn.eval_edge_chebyshev(jcheb, d))
    # the fit reproduces the exact edge stage (float64 on the host)
    jparams, jcfg, *_ = bundled
    exact = tedgefn.exact_edge_fn(d, jax.tree_util.tree_map(np.asarray, jparams["edge_fc"]),
                                  rbf_low=jcfg.rbf_low, rbf_high=jcfg.rbf_high,
                                  rbf_count=jcfg.edge_hidden_size, activation=jcfg.fc_activation)
    np.testing.assert_allclose(tedgefn.eval_edge_chebyshev(tcheb, d), exact, atol=1e-5)


def test_chebyshev_device_evaluation_matches_jax(chebs):
    jcheb, tcheb = chebs
    d = np.random.default_rng(4).uniform(0.0, 0.45, (40, 16)).astype(np.float32)
    want = np.asarray(jedgefn.eval_edge_chebyshev_device(jcheb, jnp.asarray(d)))
    got = tedgefn.eval_edge_chebyshev_device(tcheb, _t(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the band builds' forward recurrence computes the same function
    rec = tb.poly_edge_values(tcheb, _t(d)).numpy()
    np.testing.assert_allclose(rec, want, rtol=1e-5, atol=1e-5)


# -- class-bucketed plans ----------------------------------------------------


@pytest.mark.parametrize("case", ["skewed", "skewed_wide", "banded", "random", "tiny"])
def test_band_plan_classes_matches_jax(case):
    nlist, dists = {
        "skewed": lambda: skewed_case(),
        "skewed_wide": lambda: skewed_case(n=1100, k=8, seed=3, spread_hi=400),
        "banded": lambda: adversarial_case(n=517, seed=1),
        "random": lambda: adversarial_case(n=300, seed=2, banded=False),
        "tiny": lambda: adversarial_case(n=90, k=4, seed=3),
    }[case]()
    want = jb.band_plan_classes(nlist, dists)
    got = tb.band_plan_classes(nlist, dists)
    assert (got.block_rows, got.n_padded, got.num_tiles) == (
        want.block_rows, want.n_padded, want.num_tiles)
    assert len(got.classes) == len(want.classes)
    for g, w in zip(got.classes, want.classes):
        assert g.window == w.window
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.lo, w.lo)
        assert g.ids.dtype == g.lo.dtype == np.int32
    if case.startswith("skewed"):
        assert len(got.classes) > 1
    # verify-and-reuse agrees on this frame and on a moved one
    moved = nlist.copy()
    moved[3, 0] = nlist.shape[0] - 1
    for nl in (nlist, moved):
        assert tb.class_plan_covers(got, nl, dists) == jb.class_plan_covers(want, nl, dists)
    assert tb.class_plan_covers(got, nlist, dists)
    twice = (np.concatenate([nlist, nlist]), np.concatenate([dists, dists]))
    assert not tb.class_plan_covers(got, *twice)  # another padded size


def test_class_plan_on_device_checks_and_copies_once():
    nlist, dists = skewed_case()
    plan = tb.band_plan_classes(nlist, dists)
    dev = tb.plan_on_device(plan, "cpu")
    for c, h in zip(dev.classes, plan.classes):
        assert c.ids.dtype == c.lo.dtype == torch.int32
        np.testing.assert_array_equal(c.ids.numpy(), h.ids)
        np.testing.assert_array_equal(c.lo.numpy(), h.lo)
    assert tb.plan_on_device(dev, "cpu").classes[0].ids is dev.classes[0].ids
    c0 = plan.classes[0]
    with pytest.raises(ValueError, match="partition"):
        tb.plan_on_device(plan._replace(classes=plan.classes[1:]), "cpu")
    with pytest.raises(ValueError, match="inside"):
        bad = c0._replace(lo=c0.lo + plan.n_padded)
        tb.plan_on_device(plan._replace(classes=(bad,) + plan.classes[1:]), "cpu")


# -- plain versions against the Pallas kernels (interpret mode) --------------


@pytest.mark.parametrize("seed,banded,out", [
    (0, True, "float32"), (1, False, "float32"), (2, True, "bfloat16"),
])
def test_build_band_poly_plain_matches_pallas(chebs, seed, banded, out):
    """Within 1e-5 in float32 (the edge values are rounded at other steps
    by XLA; measured at most 2.4e-6). In bfloat16 both round the same
    float32 sums once, so they differ by at most one bfloat16 step
    (measured: one value of 442,368 differs, by 1.2e-7)."""
    jcheb, tcheb = chebs
    nlist, dists = adversarial_case(n=300, seed=seed, banded=banded)
    plan = jb.band_plan(nlist, dists)
    want = np.asarray(jb.build_band_poly(jnp.asarray(nlist), jnp.asarray(dists), jcheb, plan,
                                         out_dtype=jnp.dtype(out), interpret=True))
    got = tb.build_band_poly_plain(_t(nlist), _t(dists), tcheb, tb.band_plan(nlist, dists),
                                   out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.is_contiguous()
    rtol = 1e-5 if out == "float32" else BF16_ULP
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=rtol, atol=1e-5)
    before = tb.build_band_poly.launches
    wrapped = tb.build_band_poly(_t(nlist), _t(dists), tcheb, tb.band_plan(nlist, dists),
                                 out_dtype=getattr(torch, out))
    assert tb.build_band_poly.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_build_band_poly_cls_plain_matches_pallas(chebs, out):
    """Every class in float32, the widest in bfloat16; tolerances as for
    build_band_poly (measured: at most 5.7e-6 in float32; equal in
    bfloat16)."""
    jcheb, tcheb = chebs
    nlist, dists = skewed_case()
    nlist[:, 0] = nlist[:, 1]   # duplicate neighbors
    nlist[9, :3] = 0            # index-0 neighbors
    jplan = jb.band_plan_classes(nlist, dists)
    tplan = tb.band_plan_classes(nlist, dists)
    assert len(tplan.classes) > 1
    dev_plan = tb.plan_on_device(tplan, "cpu")
    pick = slice(None) if out == "float32" else slice(-1, None)
    for jc, tc, dc in list(zip(jplan.classes, tplan.classes, dev_plan.classes))[pick]:
        want = np.asarray(jb.build_band_poly_cls(
            jnp.asarray(nlist), jnp.asarray(dists), jcheb, jc, jplan.block_rows,
            jplan.n_padded, out_dtype=jnp.dtype(out), interpret=True))
        got = tb.build_band_poly_cls_plain(_t(nlist), _t(dists), tcheb, tc, tplan.block_rows,
                                           tplan.n_padded, out_dtype=getattr(torch, out))
        assert tuple(got.shape) == (len(tc.ids), 3, tplan.block_rows, tc.window)
        rtol = 1e-5 if out == "float32" else BF16_ULP
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   rtol=rtol, atol=1e-5)
        # ids and lo as tensors give the same band
        again = tb.build_band_poly_cls(_t(nlist), _t(dists), tcheb, dc, tplan.block_rows,
                                       tplan.n_padded, out_dtype=getattr(torch, out))
        torch.testing.assert_close(again, got, rtol=0, atol=0)


def _partial_case(f=128, e=3, seed=5, extra_rows=200):
    nlist, dists = adversarial_case(n=300, seed=seed)
    rng = np.random.default_rng(seed)
    efeat = rng.normal(size=nlist.shape + (e,)).astype(np.float32) * (dists > 0)[..., None]
    plan = jb.band_plan(nlist, dists)
    M = np.asarray(jb.build_band_xla(jnp.asarray(nlist), jnp.asarray(efeat), plan))
    lo = plan.lo + extra_rows // 2  # windows in the middle of a longer table
    table = rng.normal(size=(plan.n_padded + extra_rows, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    return M, lo, table, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mp_banded_partial_plain_matches_pallas(dtype):
    """float32: within rtol/atol 2e-5 (sums in another order; measured
    1.9e-5 on outputs of up to 23). bfloat16: h is rounded to bfloat16
    between the products; a sum that lands near a rounding boundary in one
    framework and not the other moves h by one bfloat16 step, so the
    tolerance is that step relative to the output's scale (measured
    9.5e-6: no such flip here)."""
    M, lo, table, w = _partial_case()
    jd = jnp.dtype(dtype)
    want = np.asarray(jb.mp_banded_partial(jnp.asarray(M).astype(jd), jnp.asarray(lo),
                                           jnp.asarray(table).astype(jd), jnp.asarray(w).astype(jd),
                                           interpret=True))
    td = getattr(torch, dtype)
    args = (_t(M).to(td), lo, _t(table).to(td), _t(w))
    got = tb.mp_banded_partial_plain(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=BF16_ULP * np.abs(want).max())
    if dtype == "float32":  # and the XLA oracle, which runs in float32
        xla = np.asarray(jb.mp_banded_partial_xla(jnp.asarray(M), jnp.asarray(lo),
                                                  jnp.asarray(table), jnp.asarray(w)))
        np.testing.assert_allclose(got.numpy(), xla, rtol=2e-5, atol=2e-5)
    before = tb.mp_banded_partial.launches
    torch.testing.assert_close(tb.mp_banded_partial(*args), got, rtol=0, atol=0)
    assert tb.mp_banded_partial.launches == before


def test_mp_banded_plain_bf16_matches_pallas():
    """bfloat16 MP layer: bfloat16 operands and output, float32 sums, h
    rounded to bfloat16, the residual added in float32 before the one
    rounding of the output. Tolerance: one bfloat16 step of h carried
    through the second product, relative to the output's scale, plus one
    rounding of the output (measured: 0.01% of the values differ, by at
    most 4.9e-4, on outputs of up to 16.6)."""
    n = 300
    nlist, dists = adversarial_case(n=n, seed=8)
    rng = np.random.default_rng(8)
    f, e = 128, 3
    efeat = rng.normal(size=nlist.shape + (e,)).astype(np.float32) * (dists > 0)[..., None]
    plan = jb.band_plan(nlist, dists)
    pad = plan.n_padded - n
    nodes = np.pad(rng.normal(size=(n, f)).astype(np.float32), ((0, pad), (0, 0)))
    inv = np.pad(inv_degree_from_nlist(nlist), (0, pad))
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    M = jb.build_band_xla(jnp.asarray(nlist), jnp.asarray(efeat), plan).astype(jnp.bfloat16)
    want = np.asarray(jb.mp_banded(M, plan, jnp.asarray(nodes).astype(jnp.bfloat16),
                                   jnp.asarray(w), jnp.asarray(inv), interpret=True))
    assert want.dtype == jnp.bfloat16
    args = (_t(np.asarray(M.astype(jnp.float32))).bfloat16(), tb.band_plan(nlist, dists),
            _t(nodes).bfloat16(), _t(w), _t(inv))
    got = tb.mp_banded_plain(*args)
    assert got.dtype == torch.bfloat16
    want = want.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                               atol=2 * BF16_ULP * np.abs(want).max())
    # float32 in, float32 out
    f32 = tb.mp_banded_plain(_t(np.asarray(M.astype(jnp.float32))), args[1], _t(nodes), _t(w),
                             _t(inv))
    assert f32.dtype == torch.float32
