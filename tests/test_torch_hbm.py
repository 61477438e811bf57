"""The port's large-structure ("banded_hbm") path against the JAX package's,
on the CPU: the MP layers with the node table in device memory
(``mp_banded_hbm``, ``mp_banded_hbm_cls``) against the Pallas kernels in
interpret mode, the forwards ``apply_banded(hbm_table=True)`` and
``apply_banded_hbm_classes``, the path rule (``plan_fits_vmem`` and the
other budgets, ``ServingModel._resolve_mode``) and the "banded_hbm" serving
dispatch with its re-bucketing switch. Inputs are made with numpy from a
seed; the models are small (F = 128, 2 MP layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu import ModelConfig as JModelConfig
from nmrgnn_tpu import init_params as jinit_params
from nmrgnn_tpu.data.embeddings import load_standards
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.graph import inv_degree_from_nlist as jinv_degree
from nmrgnn_tpu.models.infer import apply_banded as japply_banded
from nmrgnn_tpu.models.infer import apply_banded_hbm_classes as japply_banded_hbm_classes
from nmrgnn_tpu.models.serving import ServingModel as JServingModel
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops import edgefn as jedgefn
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.library import load_model, params_from_numpy
from nmrgnn_tpu_torch.models.infer import apply_banded, apply_banded_hbm_classes
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops import edgefn as tedgefn

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value
# The JAX package's exact-vs-fast band (tests/test_banded.py:457-458).
FAST_RTOL, FAST_ATOL, FAST_MIN_R = 0.05, 1.0, 0.9999
SMALL = dict(atom_feature_size=128, edge_hidden_size=32, mp_layers=2, fc_layers=2,
             edge_fc_layers=2, dropout=False, noise=0.0)


@pytest.fixture(scope="module")
def small():
    """A small model with the per-element shift statistics, in both
    packages, and its degree-64 Chebyshev fit."""
    jcfg, cfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, load_standards())
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, rbf_count=cfg.edge_hidden_size,
              activation=cfg.fc_activation, degree=64)
    jcheb = jedgefn.fit_edge_chebyshev(jparams["edge_fc"], **kw)
    tcheb = tedgefn.fit_edge_chebyshev(params["edge_fc"], **kw)
    return jparams, jcfg, jcheb, params, cfg, tcheb


def skewed_graph(n=520, k=12, seed=7, spread_hi=180, rng=None):
    """A banded graph whose window distribution is skewed (every fourth
    atom reaches ``spread_hi`` rows away), so the class plan has more than
    one class; the tests/test_banded.py generator."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    spread = np.where(np.arange(n) % 4 == 0, spread_hi, 30)
    nlist = np.clip(
        np.arange(n)[:, None] + rng.integers(-1, 2, (n, k)) * spread[:, None]
        + rng.integers(-20, 20, (n, k)), 0, n - 1,
    ).astype(np.int32)
    dists = rng.uniform(0.01, 0.19, (n, k)).astype(np.float32)
    dists[:, -2:] = 0.0
    atoms = np.eye(10, dtype=np.float32)[np.random.default_rng(seed).integers(2, 5, n)]
    return Graph(atoms, nlist, dists, np.asarray(jinv_degree(jnp.asarray(nlist))))


def banded_graph(n, k, spread, seed=0):
    """nlist = i + randint(-spread, spread), as tests/test_serving.py:122-144."""
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread, (n, k)),
                    0, n - 1).astype(np.int32)
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    return Graph(np.zeros((n, 10), np.float32), nlist, dists,
                 np.asarray(jinv_degree(jnp.asarray(nlist))))


@pytest.fixture(scope="module")
def graph():
    g = skewed_graph()
    assert len(jb.band_plan_classes(g.nlist, g.edges).classes) > 1
    return g


def in_fast_band(got, want, mean_atol=None):
    assert np.all(np.isfinite(got))
    assert np.corrcoef(got, want)[0, 1] > FAST_MIN_R
    np.testing.assert_allclose(got, want, rtol=FAST_RTOL, atol=FAST_ATOL)
    if mean_atol is not None:
        assert np.abs(got - want).mean() < mean_atol


def mp_inputs(graph, f=128, e=3, seed=0):
    """A sparse random band for the graph's plan (about 2% nonzero), a
    node table padded to the plan, [F, F, E] weights and inv_degree."""
    rng = np.random.default_rng(seed)
    plan = jb.band_plan(graph.nlist, graph.edges)
    shape = (plan.num_tiles, e, plan.block_rows, plan.window)
    M = (rng.normal(size=shape) * (rng.uniform(size=shape) < 0.02)).astype(np.float32)
    nodes = rng.normal(size=(plan.n_padded, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    inv = np.pad(graph.inv_degree, (0, plan.n_padded - graph.nlist.shape[0]))
    return plan, M, nodes, w, inv


def close_in(got: torch.Tensor, want, dtype):
    """float32: rtol/atol 2e-4. bfloat16: both round to bfloat16 (h
    between the products, then the output), after float32 sums taken in
    another order; within one bfloat16 step of the output's scale."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = 2e-4 if dtype == "float32" else BF16_STEP * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-4, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mp_banded_hbm_matches_jax(graph, dtype):
    plan, M, nodes, w, inv = mp_inputs(graph)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jb.mp_banded_hbm(jnp.asarray(M).astype(jd), plan, jnp.asarray(nodes).astype(jd),
                            jnp.asarray(w).astype(jd), jnp.asarray(inv), interpret=True)
    assert want.dtype == jd
    _cuda.reset_launch_counts()
    got = tb.mp_banded_hbm(torch.from_numpy(M).to(td), tb.band_plan(graph.nlist, graph.edges),
                           torch.from_numpy(nodes).to(td), torch.from_numpy(w),
                           torch.from_numpy(inv))
    assert tb.mp_banded_hbm.launches == 0  # the plain version on the CPU
    close_in(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mp_banded_hbm_cls_matches_jax(graph, dtype):
    """Per class: class-contiguous rows in the table's type, row block i
    the update of tile ids[i]; the classes together give mp_banded_hbm's
    rows."""
    rng = np.random.default_rng(1)
    plan, _, nodes, w, inv = mp_inputs(graph)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    cls_plan = jb.band_plan_classes(graph.nlist, graph.edges)
    jnodes, tnodes = jnp.asarray(nodes).astype(jd), torch.from_numpy(nodes).to(td)
    for c in cls_plan.classes:
        shape = (len(c.ids), 3, cls_plan.block_rows, c.window)
        M = (rng.normal(size=shape) * (rng.uniform(size=shape) < 0.02)).astype(np.float32)
        want = jb.mp_banded_hbm_cls(jnp.asarray(M).astype(jd), c, cls_plan.block_rows, jnodes,
                                    jnp.asarray(w).astype(jd), jnp.asarray(inv),
                                    interpret=True)
        got = tb.mp_banded_hbm_cls(torch.from_numpy(M).to(td), tb.BandClass(*c),
                                   cls_plan.block_rows, tnodes, torch.from_numpy(w),
                                   torch.from_numpy(inv))
        assert got.shape == (len(c.ids) * cls_plan.block_rows, nodes.shape[1])
        close_in(got, want, dtype)


@pytest.mark.parametrize("forward,dtype", [
    ("exact", "float32"), ("cheb", "float32"), ("cheb", "bfloat16"),
    ("classes", "float32"), ("classes", "bfloat16"),
])
def test_hbm_forwards_match_jax(small, graph, forward, dtype):
    """float32: within rtol/atol 2e-4, the algorithm. bfloat16: within the
    JAX package's exact-vs-fast band, with a mean difference under 0.05
    ppm (sums near a bfloat16 rounding boundary round the other way in the
    other framework, and the flip travels through the layers)."""
    jparams, jcfg, jcheb, params, cfg, tcheb = small
    jcfg, cfg = jcfg.replace(compute_dtype=dtype), cfg.replace(compute_dtype=dtype)
    gj = JGraph(*map(jnp.asarray, graph))
    gt = Graph(*[torch.from_numpy(np.array(a)) for a in graph])
    with torch.no_grad():
        if forward == "classes":
            want = japply_banded_hbm_classes(jparams, jcfg, gj, jb.band_plan_classes(
                graph.nlist, graph.edges), jcheb, interpret=True)
            got = apply_banded_hbm_classes(params, cfg, gt, tb.band_plan_classes(
                graph.nlist, graph.edges), tcheb)
        else:
            jc, tc = (jcheb, tcheb) if forward == "cheb" else (None, None)
            want = japply_banded(jparams, jcfg, gj, jb.band_plan(graph.nlist, graph.edges),
                                 cheb=jc, hbm_table=True, interpret=True)
            got = apply_banded(params, cfg, gt, tb.band_plan(graph.nlist, graph.edges),
                               cheb=tc, hbm_table=True)
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        in_fast_band(got, want, mean_atol=0.05)


def test_hbm_class_forward_reads_the_old_table(small, graph):
    """The class forward in float32 equals the uniform HBM forward with the
    same Chebyshev edge stage: every class of a layer reads the layer's
    input table, not rows that an earlier class already replaced."""
    *_, params, cfg, tcheb = small
    gt = Graph(*[torch.from_numpy(np.array(a)) for a in graph])
    with torch.no_grad():
        cls = apply_banded_hbm_classes(params, cfg, gt, tb.band_plan_classes(
            graph.nlist, graph.edges), tcheb)
        uni = apply_banded(params, cfg, gt, tb.band_plan(graph.nlist, graph.edges),
                           cheb=tcheb, hbm_table=True)
    torch.testing.assert_close(cls, uni, rtol=2e-5, atol=2e-5)


def test_path_budgets_match_jax():
    """plan_fits_vmem, hbm_plan_fits_vmem, fused_build_fits and
    fused_build_ok give the JAX package's answers (fused_build_ok as the
    JAX package decides off a TPU) over a sweep of plans."""
    seen = set()
    for n_pad in (2560, 12288, 16384, 44800):
        for b in (64, 128):
            for w in (256, 640, 896, 1280, 2048, 3072, 4096):
                jplan = jb.BandPlan(lo=np.zeros(n_pad // b, np.int32), window=w,
                                    block_rows=b, n_padded=n_pad)
                tplan = tb.BandPlan(*jplan)
                for f in (128, 256, 512):
                    for db in (2, 4):
                        got = (tb.plan_fits_vmem(tplan, f, 3, dtype_bytes=db),
                               tb.hbm_plan_fits_vmem(tplan, f, 3, dtype_bytes=db))
                        assert got == (jb.plan_fits_vmem(jplan, f, 3, dtype_bytes=db),
                                       jb.hbm_plan_fits_vmem(jplan, f, 3, dtype_bytes=db))
                        seen.add(got)
                for h, k in ((128, 16), (32, 12)):
                    for ob in (2, 4):
                        got = (tb.fused_build_fits(tplan, h, 3, k, out_bytes=ob),
                               tb.fused_build_ok(tplan, h, 3, k, out_bytes=ob))
                        assert got == (jb.fused_build_fits(jplan, h, 3, k, out_bytes=ob),
                                       jb.fused_build_ok(jplan, h, 3, k, out_bytes=ob))
                        seen.add(("fused",) + got)
    assert {(True, True), (False, True), (False, False)} <= seen
    assert {("fused", True, True), ("fused", False, False)} <= seen


@pytest.fixture(scope="module")
def bundled():
    from nmrgnn_tpu.library import load_model as jload_model

    jparams, jcfg = jload_model()
    params, cfg = load_model(device="cpu")
    return jparams, jcfg, params, cfg


@pytest.mark.parametrize("case", [
    "small", "hbm_16k", "hbm_16k_half_tiles", "precision_12k", "past_both_budgets",
])
def test_resolve_mode_matches_jax(bundled, case):
    """Host arithmetic only, at the baseline width (F = 256): a small
    graph resolves to "banded"; the 16,384-atom graph of
    tests/test_serving.py:122-144 to "banded_hbm" in float32 (with a wider
    band, on half-height tiles) and to "banded" in bfloat16, whose table
    is half as large, as is a 12,288-atom structure's; a band past both
    budgets to "blocksparse", with the JAX package's block structure."""
    jparams, jcfg, params, cfg = bundled
    g = {
        "small": lambda: skewed_graph(),
        "hbm_16k": lambda: banded_graph(16384, 8, 100),
        "hbm_16k_half_tiles": lambda: banded_graph(16384, 8, 1200),
        "precision_12k": lambda: banded_graph(12288, 8, 100),
        "past_both_budgets": lambda: banded_graph(16384, 8, 5000),
    }[case]()
    for precision in ("exact", "fast"):
        jsm = JServingModel(jparams, jcfg, use_pallas=True, reorder=False, precision=precision)
        sm = ServingModel(params, cfg, device="cpu", reorder=False, precision=precision)
        want, got = jsm._resolve_mode(JGraph(*g)), sm._resolve_mode(g)
        assert got == want, (case, precision)
        if want == "blocksparse":
            assert case == "past_both_budgets"
            got_s, want_s = sm._block_struct(g), jsm._block_struct(JGraph(*g))
            for f in ("pair_rows", "pair_cols", "pair_valid", "edge_pair", "key_sorted",
                      "key_pos"):
                np.testing.assert_array_equal(getattr(got_s, f), getattr(want_s, f))
            assert (got_s.block_size, got_s.n_padded) == (want_s.block_size, want_s.n_padded)
            continue
        assert (sm._plan.window, sm._plan.block_rows) == (jsm._plan.window,
                                                          jsm._plan.block_rows)
        np.testing.assert_array_equal(sm._plan.lo, jsm._plan.lo)
        if case == "past_both_budgets":
            continue
        expect = {"small": ("banded", "banded"), "hbm_16k": ("banded_hbm", "banded"),
                  "hbm_16k_half_tiles": ("banded_hbm", "banded"),
                  "precision_12k": ("banded_hbm", "banded")}[case]
        assert got == expect[precision == "fast"]
        if case == "hbm_16k_half_tiles" and precision == "exact":
            assert sm._plan.block_rows == 64


def test_escaping_hbm_frame_re_resolves_as_jax(bundled, monkeypatch):
    """A "banded_hbm" structure whose later frame's band escapes the HBM
    budget re-resolves that frame from scratch, to "blocksparse", as the
    JAX model does (serving.py:253-264, 720-725); a following narrow frame
    keeps the block-sparse path, its structure remapped. The forwards are
    stubbed: only the host rule and the dispatch run."""
    jparams, jcfg, params, cfg = bundled
    from nmrgnn_tpu_torch.models import serving

    jsm = JServingModel(jparams, jcfg, use_pallas=True, reorder=False)
    sm = ServingModel(params, cfg, device="cpu", reorder=False)
    zeros = lambda *a, **k: torch.zeros(16384)  # noqa: E731
    monkeypatch.setattr(serving, "apply_banded", zeros)
    monkeypatch.setattr(serving, "apply_blocksparse", zeros)
    jzeros = lambda *a, **k: (lambda *b: jnp.zeros(16384))  # noqa: E731
    monkeypatch.setattr(jsm, "_banded_fwd", jzeros)
    monkeypatch.setattr(jsm, "_blocksparse_fwd", jzeros)
    narrow, wide = banded_graph(16384, 8, 100), banded_graph(16384, 8, 5000, seed=1)
    paths = []
    for g in (narrow, wide, narrow):
        jsm.predict(JGraph(*g))
        sm.predict(g)
        assert sm._resolved == jsm._resolved
        paths.append(sm._resolved)
        if sm._resolved == "blocksparse":
            for f in ("pair_rows", "pair_cols", "pair_valid", "edge_pair"):
                np.testing.assert_array_equal(getattr(sm._struct, f), getattr(jsm._struct, f))
    assert paths == ["banded_hbm", "blocksparse", "blocksparse"]


def test_hbm_rebucketing_switch_matches_jax(bundled):
    """The class plan of the "banded_hbm" fast path on the JAX test's
    frames (tests/test_serving.py:575-612): a frame whose classes re-bucket
    switches new class plans off for good (``_cls_hbm_off``), and frames
    the cached plan still covers keep it."""
    jparams, jcfg, params, cfg = bundled
    jsm = JServingModel(jparams, jcfg, use_pallas=True, reorder=False, precision="fast")
    sm = ServingModel(params, cfg, device="cpu", precision="fast", reorder=False)
    rng = np.random.default_rng(5)
    g1 = skewed_graph(n=2048, k=8, spread_hi=150, rng=rng)
    g2 = skewed_graph(n=2048, k=8, spread_hi=400, rng=rng)
    steps = []
    for g in (g1, g2, g1, g2):
        want, got = jsm._banded_cls_plan(JGraph(*g)), sm._banded_cls_plan(g)
        assert (got is None) == (want is None)
        if got is not None:
            assert [(c.window, tuple(c.ids), tuple(c.lo)) for c in got.classes] == [
                (c.window, tuple(c.ids), tuple(c.lo)) for c in want.classes]
        assert sm._cls_hbm_off == jsm._cls_hbm_off
        steps.append(got is not None)
    assert steps == [True, False, True, False]
    assert not sm._cls_vmem_off  # the "banded" path's switch is its own


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_serving_hbm_dispatch_matches_jax(small, graph, precision, monkeypatch):
    """Frames served through "banded_hbm" (set on both models: the graph
    is small) without reordering: exact through apply_banded(hbm_table=
    True); fast through the class forward while the class plan covers the
    frame, and through the uniform HBM forward after a re-bucketing frame
    turns new class plans off. Peaks equal the JAX package's serving of
    the same frames (float32 within 2e-4; fast within the fast band)."""
    jparams, jcfg, _, params, cfg, _ = small
    jsm = JServingModel(jparams, jcfg, use_pallas=True, interpret=True, precision=precision,
                        reorder=False)

    def jax_uniform_fwd(plan, hbm=False):
        # the JAX package's _banded_fwd (serving.py:501-519) with the
        # interpret flag it does not pass on, so it runs on a CPU backend
        cheb = jsm._edge_cheb() if precision == "fast" else None
        return lambda p, gj, lo: japply_banded(p, jsm.config, gj, plan._replace(lo=lo),
                                               cheb=cheb, hbm_table=hbm, interpret=True)

    monkeypatch.setattr(jsm, "_banded_fwd", jax_uniform_fwd)
    sm = ServingModel(params, cfg, device="cpu", precision=precision, reorder=False)
    jsm._resolved = sm._resolved = "banded_hbm"
    rng = np.random.default_rng(1)
    jitter = graph._replace(edges=np.where(
        graph.edges > 0, graph.edges * (1 + 0.01 * rng.normal(size=graph.edges.shape)), 0.0
    ).astype(np.float32))
    rebucketed = skewed_graph(spread_hi=400, seed=7, rng=np.random.default_rng(9))
    frames = (graph, jitter, rebucketed, graph) if precision == "fast" else (graph, jitter)
    _cuda.reset_launch_counts()
    forwards = []
    for g in frames:
        want = jsm.predict(JGraph(*g))
        got = sm.predict(g)
        assert sm._resolved == jsm._resolved == "banded_hbm"
        if precision == "exact":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
            continue
        in_fast_band(got, want, mean_atol=0.05)
        cp = sm._cls_plan
        forwards.append(tb.class_plan_covers(cp, g.nlist, g.edges) and len(cp.classes) > 1)
        assert sm._cls_hbm_off == jsm._cls_hbm_off
    if precision == "fast":
        assert forwards == [True, True, False, True]
        assert sm._cls_hbm_off and sm._cls_plan_vmem is None
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
