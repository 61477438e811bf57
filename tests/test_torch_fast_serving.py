"""The port's "fast" forwards and serving against the JAX package's, on the
CPU: ``apply_banded(cheb=...)`` and ``apply_banded_classes`` at float32
(where the algorithm is checked) and at bfloat16 (within the JAX package's
own exact-vs-fast band), and ``ServingModel(precision="fast")`` frame by
frame against the JAX ``ServingModel(use_pallas=True, interpret=True)``,
re-bucketing switch included. Inputs are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.graph import inv_degree_from_nlist as jinv_degree
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.models.infer import apply_banded as japply_banded
from nmrgnn_tpu.models.infer import apply_banded_classes as japply_banded_classes
from nmrgnn_tpu.models.serving import ServingModel as JServingModel
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops import edgefn as jedgefn
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.library import load_model
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.infer import apply_banded, apply_banded_classes
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops import edgefn as tedgefn

torch.set_num_threads(2)

# The JAX package's exact-vs-fast band (tests/test_banded.py:457-458).
FAST_RTOL, FAST_ATOL, FAST_MIN_R = 0.05, 1.0, 0.9999


@pytest.fixture(scope="module")
def bundled():
    jparams, jcfg = jload_model()
    params, cfg = load_model(device="cpu")
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, rbf_count=cfg.edge_hidden_size,
              activation=cfg.fc_activation, degree=64)
    jcheb = jedgefn.fit_edge_chebyshev(jparams["edge_fc"], **kw)
    tcheb = tedgefn.fit_edge_chebyshev(params["edge_fc"], **kw)
    return jparams, jcfg, jcheb, params, cfg, tcheb


def skewed_graph(n=520, k=12, seed=7, spread_hi=180, rng=None):
    """A protein-sized banded graph whose window distribution is skewed
    (every fourth atom reaches ``spread_hi`` rows away), so the class plan
    has more than one class; the tests/test_banded.py generator."""
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


@pytest.fixture(scope="module")
def graph():
    g = skewed_graph()
    assert len(jb.band_plan_classes(g.nlist, g.edges).classes) > 1
    return g


def in_fast_band(got, want, mean_atol=None):
    """Within the fast band; with ``mean_atol``, also a mean |difference|
    under it (a bound on how many atoms a rounding flip moves)."""
    assert np.all(np.isfinite(got))
    assert np.corrcoef(got, want)[0, 1] > FAST_MIN_R
    np.testing.assert_allclose(got, want, rtol=FAST_RTOL, atol=FAST_ATOL)
    if mean_atol is not None:
        assert np.abs(got - want).mean() < mean_atol


@pytest.mark.parametrize("forward", ["classes", "uniform"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_forwards_match_jax(bundled, graph, forward, dtype):
    """float32: within rtol/atol 2e-4, the algorithm. bfloat16: within the
    JAX package's exact-vs-fast band, and a mean difference under 0.05 ppm.
    The two frameworks sum in other orders, so a float32 sum near a
    bfloat16 rounding boundary rounds the other way and the flip travels
    through the layers. Measured (peaks of -117 to 127 ppm): classes max
    2.11 ppm, mean 0.020 ppm, r 0.9999968; uniform max 1.57 ppm, mean
    0.0037 ppm, r 0.9999992. For scale, bfloat16 itself moves these peaks
    by a mean 0.54 ppm from the float32 forward, in either framework."""
    jparams, jcfg, jcheb, params, cfg, tcheb = bundled
    jcfg, cfg = jcfg.replace(compute_dtype=dtype), cfg.replace(compute_dtype=dtype)
    gj = JGraph(*map(jnp.asarray, graph))
    gt = Graph(*map(torch.from_numpy, graph))
    with torch.no_grad():
        if forward == "classes":
            want = japply_banded_classes(jparams, jcfg, gj, jb.band_plan_classes(
                graph.nlist, graph.edges), jcheb, interpret=True)
            got = apply_banded_classes(params, cfg, gt, tb.band_plan_classes(
                graph.nlist, graph.edges), tcheb)
        else:
            want = japply_banded(jparams, jcfg, gj, jb.band_plan(graph.nlist, graph.edges),
                                 cheb=jcheb, interpret=True)
            got = apply_banded(params, cfg, gt, tb.band_plan(graph.nlist, graph.edges),
                               cheb=tcheb)
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        in_fast_band(got, want, mean_atol=0.05)


def test_fast_forwards_use_their_kernels_and_plain_versions_agree(bundled, graph):
    """The kernel wrappers of both fast forwards take their plain versions
    on the CPU (no launch is counted), and use_kernels=False gives the
    same peaks. In float32 the Chebyshev edge stage alone stays within
    rtol/atol 2e-4 of the exact gather forward, as in the JAX package."""
    *_, params, cfg, tcheb = bundled
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    gt = Graph(*map(torch.from_numpy, graph))
    cls_plan = tb.band_plan_classes(graph.nlist, graph.edges)
    plan = tb.band_plan(graph.nlist, graph.edges)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        a = apply_banded_classes(params, cfg16, gt, cls_plan, tcheb)
        b = apply_banded_classes(params, cfg16, gt, cls_plan, tcheb, use_kernels=False)
        c = apply_banded(params, cfg16, gt, plan, cheb=tcheb)
        d = apply_banded(params, cfg16, gt, plan, cheb=tcheb, use_kernels=False)
        exact = gnn.apply(params, cfg, gt)
        f32 = apply_banded_classes(params, cfg, gt, cls_plan, tcheb)
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    torch.testing.assert_close(f32, exact, rtol=2e-4, atol=2e-4)


def test_serving_fast_matches_jax_frame_by_frame(bundled, graph, monkeypatch):
    """Four frames served without reordering: a skewed frame (class
    forward), the same topology with jittered distances (the class plan is
    reused), a frame whose classes re-bucket (the switch turns new class
    plans off: uniform forward), and the first frame again (the cached
    class plan still covers it: class forward). Each frame's peaks are
    within the fast band of the JAX package's fast serving, and both take
    the same forward on every frame."""
    jparams, jcfg, _, params, cfg, _ = bundled
    jsm = JServingModel(jparams, jcfg, use_pallas=True, interpret=True, precision="fast",
                        reorder=False, mode="banded")

    def jax_uniform_fwd(plan, hbm=False):
        # the JAX package's _banded_fwd (serving.py:501-519) with the
        # interpret flag it does not pass on, so it runs on a CPU backend
        return lambda p, gj, lo: japply_banded(p, jsm.config, gj, plan._replace(lo=lo),
                                               cheb=jsm._edge_cheb(), interpret=True)

    monkeypatch.setattr(jsm, "_banded_fwd", jax_uniform_fwd)
    sm = ServingModel(params, cfg, device="cpu", precision="fast", reorder=False)
    assert sm.config.compute_dtype == "bfloat16" == jsm.config.compute_dtype
    rng = np.random.default_rng(1)
    jitter = graph._replace(edges=np.where(
        graph.edges > 0, graph.edges * (1 + 0.01 * rng.normal(size=graph.edges.shape)), 0.0
    ).astype(np.float32))
    rebucketed = skewed_graph(spread_hi=400, seed=7, rng=np.random.default_rng(9))
    forwards = []
    for f, g in enumerate((graph, jitter, rebucketed, graph)):
        want = jsm.predict(JGraph(*g))
        got = sm.predict(g)
        in_fast_band(got, want, mean_atol=0.05)
        cp, jcp = sm._cls_plan_vmem, jsm._cls_plan_vmem
        on_cls = tb.class_plan_covers(cp, g.nlist, g.edges) and len(cp.classes) > 1
        assert on_cls == (jb.class_plan_covers(jcp, g.nlist, g.edges)
                          and len(jcp.classes) > 1)
        assert sm._cls_vmem_off == jsm._cls_vmem_off
        forwards.append(on_cls)
    assert forwards == [True, True, False, True]
    assert sm._cls_vmem_off


def test_serving_fast_rebucketing_switch_matches_jax(bundled):
    """The plan choice alone, on the JAX test's larger frames
    (tests/test_serving.py:575-612): a frame whose classes re-bucket
    switches new class plans off for good, and frames the cached plan
    still covers keep it."""
    jparams, jcfg, _, params, cfg, _ = bundled
    jsm = JServingModel(jparams, jcfg, use_pallas=True, reorder=False, precision="fast")
    sm = ServingModel(params, cfg, device="cpu", precision="fast", reorder=False)
    rng = np.random.default_rng(5)
    g1 = skewed_graph(n=2048, k=8, spread_hi=150, rng=rng)
    g2 = skewed_graph(n=2048, k=8, spread_hi=400, rng=rng)
    steps = []
    for g in (g1, g2, g1, g2):
        want, got = jsm._banded_cls_plan_vmem(JGraph(*g)), sm._banded_cls_plan_vmem(g)
        assert (got is None) == (want is None)
        if got is not None:
            assert [(c.window, tuple(c.ids)) for c in got.classes] == [
                (c.window, tuple(c.ids)) for c in want.classes]
        assert sm._cls_vmem_off == jsm._cls_vmem_off
        steps.append(got is not None)
    assert steps == [True, False, True, False]
    assert sm._banded_cls_plan_vmem(g1) is sm._cls_plan_vmem  # the cached plan


def test_serving_fast_with_reorder_is_within_the_fast_band(bundled, graph):
    """With the RCM reorder (the default) fast serving returns peaks in the
    graph's own atom order: within the fast band of the same model served
    without the reorder (the same bfloat16 arithmetic over another atom
    order)."""
    *_, params, cfg, _ = bundled
    as_given = ServingModel(params, cfg, device="cpu", precision="fast", reorder=False)
    fast = ServingModel(params, cfg, device="cpu", precision="fast")
    in_fast_band(fast.predict(graph), as_given.predict(graph))
    assert fast._inverse is not None
    assert fast._cheb.degree == 64 and isinstance(fast._cheb.coeffs, torch.Tensor)
