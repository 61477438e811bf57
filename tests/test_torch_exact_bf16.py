"""Exact serving of a ``compute_dtype="bfloat16"`` config against the JAX
package on the CPU (the Pallas kernels in interpret mode): the fused exact
edge stage with bfloat16 operands and output (``build_band_fused_plain``
against ``build_band_fused(compute_dtype=bf16, out_dtype=bf16)``),
``apply_banded`` on the exact path, and ``ServingModel(precision="exact")``.
The JAX package serves such a config at "exact" in bfloat16
(``nmrgnn_tpu/models/serving.py:110-112``, ``infer.py:247-254``). Inputs are
made with numpy from a seed; the weights are the bundled ones."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.models.infer import apply_banded as japply_banded
from nmrgnn_tpu.models.serving import ServingModel as JServingModel
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import load_model
from nmrgnn_tpu_torch.models.infer import apply_banded
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded as tb

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value
# The JAX package's exact-vs-fast band (tests/test_banded.py:457-458).
FAST_RTOL, FAST_ATOL, FAST_MIN_R = 0.05, 1.0, 0.9999


@pytest.fixture(scope="module")
def bundled():
    jparams, jcfg = jload_model()
    params, cfg = load_model(device="cpu")
    bf16 = dict(compute_dtype="bfloat16")
    return jparams, jcfg.replace(**bf16), params, cfg.replace(**bf16)


@pytest.fixture(scope="module")
def graph():
    """384 atoms, 16 neighbors within 40 rows (the JAX tests' banded
    generator), a few padding slots."""
    rng = np.random.default_rng(3)
    n, k = 384, 16
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.09, 0.3, (n, k)).astype(np.float32)
    dists[rng.uniform(size=(n, k)) < 0.05] = 0.0
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5, 6], n)]
    return Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))


def in_fast_band(got, want, mean_atol=0.05):
    """Within the JAX package's exact-vs-fast band and a mean |difference|
    under ``mean_atol``: the two frameworks sum in other orders, so a
    float32 sum near a bfloat16 rounding boundary rounds the other way and
    the flip travels through the layers."""
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    assert np.corrcoef(got, want)[0, 1] > FAST_MIN_R
    np.testing.assert_allclose(got, want, rtol=FAST_RTOL, atol=FAST_ATOL)
    assert np.abs(got - want).mean() < mean_atol


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_build_band_fused_bf16_matches_jax(bundled, graph, out_dtype):
    """The plain version of the fused exact edge stage with bfloat16 EdgeFC
    operands against the Pallas kernel: within one bfloat16 step relative
    to M's scale. Both round the same operands, but the EdgeFC sums are
    taken in another order, so an activation near a bfloat16 rounding
    boundary rounds the other way as the next product's operand and moves
    its band entries by about a step."""
    jparams, jcfg, params, cfg = bundled
    plan = jb.band_plan(graph.nlist, graph.edges)
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation)
    want = jb.build_band_fused(jnp.asarray(graph.nlist), jnp.asarray(graph.edges),
                               jparams["edge_fc"], plan, out_dtype=jnp.dtype(out_dtype),
                               compute_dtype=jnp.bfloat16, interpret=True, **kw)
    want = np.asarray(want.astype(jnp.float32))
    _cuda.reset_launch_counts()
    got = tb.build_band_fused(torch.from_numpy(graph.nlist), torch.from_numpy(graph.edges),
                              params["edge_fc"], tb.band_plan(graph.nlist, graph.edges),
                              out_dtype=getattr(torch, out_dtype),
                              compute_dtype=torch.bfloat16, **kw)
    assert tb.build_band_fused.launches == 0  # the plain version on the CPU
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP,
                               atol=BF16_STEP * float(np.abs(want).max()))
    f32 = tb.build_band_fused_plain(torch.from_numpy(graph.nlist),
                                    torch.from_numpy(graph.edges), params["edge_fc"],
                                    tb.band_plan(graph.nlist, graph.edges), **kw)
    assert float((got.float() - f32).abs().max()) > 0  # the operands were rounded


def test_apply_banded_exact_bf16_matches_jax(bundled, graph):
    """The exact banded forward of a bfloat16 config (fused exact edge
    stage, bfloat16 MP layers and readout) against the JAX package's."""
    jparams, jcfg, params, cfg = bundled
    want = np.asarray(japply_banded(jparams, jcfg, JGraph(*map(jnp.asarray, graph)),
                                    jb.band_plan(graph.nlist, graph.edges), interpret=True))
    with torch.no_grad():
        got = apply_banded(params, cfg, Graph(*map(torch.from_numpy, graph)),
                           tb.band_plan(graph.nlist, graph.edges)).numpy()
    assert got.dtype == np.float32
    in_fast_band(got, want)


@pytest.mark.parametrize("path", ["banded", "banded_hbm"])
def test_serving_exact_bf16_matches_jax(bundled, graph, monkeypatch, path):
    """ServingModel(precision="exact") keeps the config's bfloat16, as the
    JAX package does, and serves two frames (the second with jittered
    distances, reusing the plan) within the fast band of the JAX
    package's, with a mean difference under 0.05 ppm, on the node-table
    path and on "banded_hbm" (set on both models: a graph that resolves
    there is too large for a CPU test)."""
    jparams, jcfg, params, cfg = bundled
    jsm = JServingModel(jparams, jcfg, use_pallas=True, interpret=True, precision="exact",
                        reorder=False)

    def jax_banded_fwd(plan, hbm=False):
        # the JAX package's _banded_fwd (serving.py:501-519) with the
        # interpret flag it does not pass on, so it runs on a CPU backend
        return lambda p, gj, lo: japply_banded(p, jsm.config, gj, plan._replace(lo=lo),
                                               hbm_table=hbm, interpret=True)

    monkeypatch.setattr(jsm, "_banded_fwd", jax_banded_fwd)
    sm = ServingModel(params, cfg, device="cpu", precision="exact", reorder=False)
    assert sm.config.compute_dtype == "bfloat16" == jsm.config.compute_dtype
    if path == "banded_hbm":
        jsm._resolved = sm._resolved = "banded_hbm"
    rng = np.random.default_rng(4)
    jitter = graph._replace(edges=np.where(
        graph.edges > 0, graph.edges * (1 + 0.01 * rng.normal(size=graph.edges.shape)), 0.0
    ).astype(np.float32))
    for g in (graph, jitter):
        in_fast_band(sm.predict(g), np.asarray(jsm.predict(JGraph(*g))))
        assert sm._resolved == jsm._resolved == path


def test_exact_bf16_frames_and_blocksparse_serve(bundled, graph):
    """The other serving entries take the bfloat16 config as well:
    predict_frames (one forward for the batch) equals per-frame predict,
    and mode="blocksparse" equals "fast" block-sparse serving bit for bit:
    that path keeps its edge stage float32 at both precisions
    (nmrgnn_tpu/models/infer.py:80-86), so a bfloat16 config serves there
    as "fast" does (held against the JAX package in
    tests/test_torch_blocksparse.py)."""
    *_, params, cfg = bundled
    rng = np.random.default_rng(8)
    frames = [graph._replace(edges=np.where(
        graph.edges > 0, graph.edges * (1 + 0.01 * rng.normal(size=graph.edges.shape)), 0.0
    ).astype(np.float32)) for _ in range(3)]
    sm = ServingModel(params, cfg, device="cpu", reorder=False)
    want = np.stack([sm.predict(g) for g in frames])
    batched = ServingModel(params, cfg, device="cpu", reorder=False).predict_frames(frames)
    np.testing.assert_array_equal(batched, want)
    bs = ServingModel(params, cfg, device="cpu", reorder=False, mode="blocksparse")
    fast = ServingModel(params, cfg.replace(compute_dtype="float32"), device="cpu",
                        reorder=False, mode="blocksparse", precision="fast")
    for g in frames:
        np.testing.assert_array_equal(bs.predict(g), fast.predict(g))
    assert bs.config.compute_dtype == fast.config.compute_dtype == "bfloat16"
