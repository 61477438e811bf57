"""The fused Chebyshev band build + MP layer 1 (``mp_banded_poly_fused``,
B13) and ``apply_banded(fused_first=True)`` against the JAX package on the
CPU, the Pallas kernel in interpret mode, at the JAX test's size
(tests/test_banded.py:375-418: n=384, K=16, F=128, Chebyshev degree 48).
Inputs are made with numpy from a seed and fed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu import ModelConfig as JModelConfig
from nmrgnn_tpu import init_params as jinit_params
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.models.infer import apply_banded as japply_banded
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops import edgefn as jedgefn
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.models.gnn import tree_map
from nmrgnn_tpu_torch.models.infer import apply_banded
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops import edgefn as tedgefn

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value
F = 128


@pytest.fixture(scope="module")
def case():
    """The JAX test's graph, weights (init_params at F=128, 2 MP layers),
    node table, inv_degree and degree-48 fit, in both packages."""
    jcfg = JModelConfig().replace(atom_feature_size=F, mp_layers=2)
    rng = np.random.default_rng(11)
    n, k = 384, 16
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.01, 0.3, (n, k)).astype(np.float32)
    dists[:, -2:] = 0.0
    jparams = jinit_params(jax.random.PRNGKey(3), jcfg)
    params = tree_map(lambda a: torch.from_numpy(np.array(a)), jparams)
    kw = dict(rbf_low=jcfg.rbf_low, rbf_high=jcfg.rbf_high, rbf_count=jcfg.edge_hidden_size,
              activation=jcfg.fc_activation, degree=48)
    jcheb = jedgefn.fit_edge_chebyshev(jparams["edge_fc"], **kw)
    tcheb = tedgefn.fit_edge_chebyshev(params["edge_fc"], **kw)
    np.testing.assert_array_equal(tcheb.coeffs, jcheb.coeffs)
    n_pad = tb.band_plan(nlist, dists).n_padded
    nodes = rng.normal(size=(n_pad, F)).astype(np.float32)
    inv = rng.uniform(0, 1, n_pad).astype(np.float32)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5, 6], n)]
    graph = (atoms, nlist, dists, inv_degree_from_nlist(nlist))
    cfg = ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})
    return dict(nlist=nlist, dists=dists, nodes=nodes, inv=inv, graph=graph, jcfg=jcfg,
                cfg=cfg, jparams=jparams, params=params, jcheb=jcheb, tcheb=tcheb)


@pytest.mark.parametrize("nodes_dtype,out_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
])
def test_mp_banded_poly_fused_matches_jax(case, nodes_dtype, out_dtype):
    """M within 1e-5 (float32) or one bfloat16 step (both round the same
    float32 sum once); nodes_1 within 1e-4 (float32) or, in bfloat16, one
    step relative to the output's scale (h is rounded to bfloat16 between
    the products after float32 sums taken in another order). With
    out_dtype != nodes.dtype layer 1 still takes the band in nodes.dtype."""
    plan = jb.band_plan(case["nlist"], case["dists"])
    w = np.array(case["jparams"]["mp"][0]["w"])
    jdt, tdt = jnp.dtype(nodes_dtype), getattr(torch, nodes_dtype)
    M_want, want = jb.mp_banded_poly_fused(
        jnp.asarray(case["nlist"]), jnp.asarray(case["dists"]), case["jcheb"], plan,
        jnp.asarray(case["nodes"]).astype(jdt), jnp.asarray(w), jnp.asarray(case["inv"]),
        out_dtype=jnp.dtype(out_dtype), interpret=True)
    _cuda.reset_launch_counts()
    M, got = tb.mp_banded_poly_fused(
        torch.from_numpy(case["nlist"]), torch.from_numpy(case["dists"]), case["tcheb"],
        tb.band_plan(case["nlist"], case["dists"]), torch.from_numpy(case["nodes"]).to(tdt),
        torch.from_numpy(w), torch.from_numpy(case["inv"]), out_dtype=getattr(torch, out_dtype))
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)  # the plain version on the CPU
    assert M.dtype == getattr(torch, out_dtype) and got.dtype == tdt
    M_want = np.asarray(M_want.astype(jnp.float32))
    want = np.asarray(want.astype(jnp.float32))
    m_rtol = 1e-5 if out_dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(M.float().numpy(), M_want, rtol=m_rtol, atol=1e-5)
    if nodes_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP,
                                   atol=2 * BF16_STEP * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_banded_fused_first_matches_jax(case, dtype):
    """The fused-first forward (B13, then mp_banded for layer 2) against
    the JAX package's: float32 within rtol/atol 2e-4 (the algorithm);
    bfloat16 within the JAX package's exact-vs-fast band and a mean
    difference under 0.05 ppm (rounding flips of sums taken in another
    order, as tests/test_torch_fast_serving.py measures)."""
    jcfg = case["jcfg"].replace(compute_dtype=dtype)
    cfg = case["cfg"].replace(compute_dtype=dtype)
    g = case["graph"]
    want = np.asarray(japply_banded(case["jparams"], jcfg, JGraph(*map(jnp.asarray, g)),
                                    jb.band_plan(g[1], g[2]), cheb=case["jcheb"],
                                    fused_first=True, interpret=True))
    gt = Graph(*map(torch.from_numpy, g))
    plan = tb.band_plan(g[1], g[2])
    with torch.no_grad():
        got = apply_banded(case["params"], cfg, gt, plan, cheb=case["tcheb"], fused_first=True)
        serial = apply_banded(case["params"], cfg, gt, plan, cheb=case["tcheb"])
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, serial.numpy())  # the serial path's function
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert np.corrcoef(got, want)[0, 1] > 0.9999
        np.testing.assert_allclose(got, want, rtol=0.05, atol=1.0)
        assert np.abs(got - want).mean() < 0.05


@pytest.mark.parametrize("how", ["hbm_table", "no_cheb", "no_kernels", "no_mp_layer"])
def test_fused_first_is_ignored_where_jax_ignores_it(case, how, monkeypatch):
    """Outside the JAX package's condition (infer.py:215-216: kernels on,
    cheb given, hbm_table off, an MP layer) fused_first changes nothing:
    the forward equals the serial one bit for bit and never reaches
    mp_banded_poly_fused."""
    cheb = case["tcheb"]
    kw = {"hbm_table": dict(cheb=cheb, hbm_table=True), "no_cheb": {},
          "no_kernels": dict(cheb=cheb, use_kernels=False), "no_mp_layer": dict(cheb=cheb)}[how]
    params = dict(case["params"], mp=[]) if how == "no_mp_layer" else case["params"]
    g = case["graph"]
    gt = Graph(*map(torch.from_numpy, g))
    plan = tb.band_plan(g[1], g[2])
    calls = []
    orig = tb.mp_banded_poly_fused_plain
    monkeypatch.setattr(tb, "mp_banded_poly_fused_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        got = apply_banded(params, case["cfg"], gt, plan, fused_first=True, **kw)
        want = apply_banded(params, case["cfg"], gt, plan, **kw)
    assert torch.equal(got, want)
    assert calls == []
