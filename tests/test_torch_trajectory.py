"""The port's trajectory serving against the JAX package's, on the CPU: the
union band plan (``band_plan_frames``), the batched-frames forward
(``apply_banded_frames``) against the JAX package's vmapped
``apply_banded`` over the same plan, ``ServingModel.predict_frames``
against per-frame ``predict`` (its union plan kept apart from the
single-frame plan), and ``predict_trajectory``'s order, overlap and
failure. Inputs are made with numpy from a seed; the model is small (F =
128, 2 MP layers)."""
import os
import sys

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
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops import edgefn as jedgefn
import nmrgnn_tpu_torch.data.parse as parse_mod
import nmrgnn_tpu_torch.models.serving as serving_mod
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.data.pdb import read_structure
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.library import params_from_numpy
from nmrgnn_tpu_torch.models.infer import apply_banded, apply_banded_frames
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops import edgefn as tedgefn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import write_synthetic_pdb  # noqa: E402

# The JAX package's exact-vs-fast band (tests/test_banded.py:457-458).
FAST_RTOL, FAST_ATOL, FAST_MIN_R = 0.05, 1.0, 0.9999
SMALL = dict(atom_feature_size=128, edge_hidden_size=32, mp_layers=2, fc_layers=2,
             edge_fc_layers=2, dropout=False, noise=0.0)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, load_standards())
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, rbf_count=cfg.edge_hidden_size,
              activation=cfg.fc_activation, degree=64)
    jcheb = jedgefn.fit_edge_chebyshev(jparams["edge_fc"], **kw)
    tcheb = tedgefn.fit_edge_chebyshev(params["edge_fc"], **kw)
    return jparams, jcfg, jcheb, params, cfg, tcheb


def frames(n=384, k=12, count=3, spread=40, seed=3):
    """Frames of one structure: the same atoms, per-frame banded neighbor
    lists (nlist = i + randint(-spread, spread), tests/test_banded.py:
    187-192) and distances, a few padding slots."""
    rng = np.random.default_rng(seed)
    atoms = np.eye(10, dtype=np.float32)[rng.integers(2, 5, n)]
    out = []
    for _ in range(count):
        nlist = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread, (n, k)),
                        0, n - 1).astype(np.int32)
        dists = rng.uniform(0.09, 0.19, (n, k)).astype(np.float32)
        dists[:, -1] = 0.0
        out.append(Graph(atoms, nlist, dists, np.asarray(jinv_degree(jnp.asarray(nlist)))))
    return out


def stacked(gs):
    return Graph(*[np.stack([getattr(g, f) for g in gs]) for f in Graph._fields])


def in_fast_band(got, want, mean_atol=None):
    assert np.all(np.isfinite(got))
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > FAST_MIN_R
    np.testing.assert_allclose(got, want, rtol=FAST_RTOL, atol=FAST_ATOL)
    if mean_atol is not None:
        assert np.abs(got - want).mean() < mean_atol


@pytest.mark.parametrize("block_rows", [128, 64])
def test_band_plan_frames_equals_jax(block_rows):
    """Bitwise the JAX union plan, wider than each frame's own plan where a
    frame reaches further, and band_plan of one frame is its own union."""
    gs = frames(n=520, count=3, spread=60)
    gs.append(frames(n=520, count=1, spread=200, seed=4)[0])
    st = stacked(gs)
    got = tb.band_plan_frames(st.nlist, st.edges, block_rows=block_rows)
    want = jb.band_plan_frames(st.nlist, st.edges, block_rows=block_rows)
    assert (got.window, got.block_rows, got.n_padded) == (want.window, want.block_rows,
                                                          want.n_padded)
    assert got.lo.dtype == want.lo.dtype
    np.testing.assert_array_equal(got.lo, want.lo)
    assert got.window > tb.band_plan(gs[0].nlist, gs[0].edges, block_rows=block_rows).window
    assert all(tb.plan_covers(got, g.nlist, g.edges) for g in gs)
    one = tb.band_plan(gs[0].nlist, gs[0].edges, block_rows=block_rows)
    ref = jb.band_plan(gs[0].nlist, gs[0].edges, block_rows=block_rows)
    assert one.window == ref.window
    np.testing.assert_array_equal(one.lo, ref.lo)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_batched_frames_forward_matches_jax_vmap(small, precision):
    """apply_banded_frames against jax.vmap(apply_banded) over the same
    union plan (tests/test_serving.py:222-247): exact within rtol/atol
    2e-4; fast (bfloat16, Chebyshev edge stage) in the fast band with a
    mean under 0.05 ppm. Frame by frame it equals the port's own
    apply_banded within 1e-5 (the node tables are the same; the readout's
    products run at another batch size)."""
    jparams, jcfg, jcheb, params, cfg, tcheb = small
    if precision == "fast":
        jcfg, cfg = jcfg.replace(compute_dtype="bfloat16"), cfg.replace(compute_dtype="bfloat16")
    jc, tc = (jcheb, tcheb) if precision == "fast" else (None, None)
    gs = frames(n=400)  # not a multiple of the tile: padded rows in every frame
    st = stacked(gs)
    plan = jb.band_plan_frames(st.nlist, st.edges)
    want = np.asarray(jax.vmap(lambda g: japply_banded(
        jparams, jcfg, g, plan, cheb=jc, interpret=True))(JGraph(*map(jnp.asarray, st))))
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = apply_banded_frames(params, cfg, Graph(*map(torch.from_numpy, st)),
                                  tb.band_plan_frames(st.nlist, st.edges), cheb=tc).numpy()
        each = np.stack([apply_banded(params, cfg, Graph(*map(torch.from_numpy, g)),
                                      tb.band_plan_frames(st.nlist, st.edges), cheb=tc).numpy()
                         for g in gs])
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
    assert got.shape == want.shape == (3, 400)
    if precision == "exact":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        in_fast_band(got, want, mean_atol=0.05)
    np.testing.assert_allclose(got, each, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_predict_frames_matches_per_frame_predict(small, precision):
    """With the RCM reorder: predict_frames equals per-frame predict within
    1e-4 (exact), or (fast) per-frame predict on the uniform forward, the
    one a batch takes, within the fast band with a mean under 0.05 ppm. A
    single fast frame of this skewed structure takes the class forward,
    whose node table stays float32 between layers: that stays within the
    fast band (measured mean 0.12 ppm, max 1.03 ppm on these peaks of 8 to
    139 ppm). A second call whose frames the plans cover makes no new
    union plan."""
    *_, params, cfg, _ = small
    gs = frames(n=400, count=4)
    sm = ServingModel(params, cfg, device="cpu", precision=precision)
    got = sm.predict_frames(gs)
    assert sm._resolved == "banded"

    def per_frame(uniform):
        out = []
        for g in gs:
            m = ServingModel(params, cfg, device="cpu", precision=precision)
            m._cls_vmem_off = uniform  # no class plan: the uniform forward
            out.append(m.predict(g))
        return np.stack(out)

    if precision == "exact":
        np.testing.assert_allclose(got, per_frame(False), rtol=1e-4, atol=1e-4)
    else:
        in_fast_band(got, per_frame(True), mean_atol=0.05)
        in_fast_band(got, per_frame(False))
    union = sm._frames_plan
    again = sm.predict_frames(gs[:2])
    assert sm._frames_plan is union
    np.testing.assert_allclose(again, got[:2], rtol=1e-5, atol=1e-5)


def test_predict_frames_union_plan_does_not_replace_the_frame_plan(small, monkeypatch):
    """A batch whose union window is wider than the current frame's plan
    keeps the union in its own slot: later single-frame calls keep the
    narrow window (the JAX test at tests/test_serving.py:169-210)."""
    *_, params, cfg, _ = small
    g_narrow = frames(n=512, k=8, count=1, spread=20)[0]
    g_wide = frames(n=512, k=8, count=1, spread=200, seed=4)[0]
    g_wide = g_wide._replace(atoms=g_narrow.atoms)
    sm = ServingModel(params, cfg, device="cpu", reorder=False)
    assert sm._resolve_mode(g_narrow) == "banded"
    narrow_plan = sm._banded_plan(g_narrow)
    calls = {}

    def stub(params, config, graphs, plan, cheb=None):
        calls["plan"] = plan
        return torch.zeros(graphs.atoms.shape[:2])

    monkeypatch.setattr(serving_mod, "apply_banded_frames", stub)
    sm.predict_frames([g_narrow, g_wide])
    assert calls["plan"].window > narrow_plan.window
    assert sm._frames_plan.window == calls["plan"].window
    assert sm._plan is narrow_plan
    assert sm._banded_plan(g_narrow).window == narrow_plan.window


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("traj") / "synthetic.pdb")
    write_synthetic_pdb(path, n_atoms=300, seed=2, frames=5)
    return read_structure(path)


def test_predict_trajectory_in_order_equal_to_predict(small, trajectory):
    """Every frame, in order, equal to per-frame predict on the port's own
    graph build; with stride 2, frames 0, 2, 4."""
    *_, params, cfg, _ = small
    sm = ServingModel(params, cfg, device="cpu")
    out = list(sm.predict_trajectory(trajectory, build_workers=2, prefetch=1))
    assert [i for i, _ in out] == [0, 1, 2, 3, 4]
    ref = ServingModel(params, cfg, device="cpu")
    for i, p in out:
        want = ref.predict(parse_mod.structure2graph(trajectory, frame=i))
        np.testing.assert_allclose(p, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(out[0][1], out[1][1])
    assert [i for i, _ in sm.predict_trajectory(trajectory, stride=2)] == [0, 2, 4]


def test_predict_trajectory_propagates_build_failure(small, trajectory, monkeypatch):
    """A graph build that fails mid-stream raises in the consumer, as soon
    as the failure reaches it (tests/test_serving.py:60-82): frame 0 has
    come out, frame 1's readback was still deferred."""
    *_, params, cfg, _ = small
    sm = ServingModel(params, cfg, device="cpu")
    real = parse_mod.structure2graph

    def failing(s, k=16, frame=0):
        if frame >= 2:
            raise OSError("synthetic build failure")
        return real(s, k, frame=frame)

    monkeypatch.setattr(parse_mod, "structure2graph", failing)
    seen = []
    with pytest.raises(RuntimeError, match="build failed mid-stream"):
        for i, _ in sm.predict_trajectory(trajectory, build_workers=1, prefetch=1):
            seen.append(i)
    assert seen == [0]
