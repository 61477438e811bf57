"""The port's block-sparse path against the JAX package's, on the CPU: the
host structure (``block_structure``, ``remap_frame``) array for array, the
plain versions of the adjacency build and the MP layer against the Pallas
kernels in interpret mode, ``apply_blocksparse`` with the bundled weights
and ``ServingModel(mode="blocksparse")`` over jittered frames at both
precisions. Inputs are made with numpy from a seed."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.graph import inv_degree_from_nlist as jinv_degree
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.models.infer import apply_blocksparse as japply_blocksparse
from nmrgnn_tpu.models.serving import ServingModel as JServingModel
from nmrgnn_tpu.ops import blocksparse as jbs
from nmrgnn_tpu_torch.data.parse import structure2graph
from nmrgnn_tpu_torch.data.pdb import read_structure
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.library import load_model
from nmrgnn_tpu_torch.models.infer import apply_blocksparse, precompute_structure
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import blocksparse as tbs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import write_synthetic_pdb  # noqa: E402

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value
# The JAX package's exact-vs-fast band (tests/test_banded.py:457-458).
FAST_RTOL, FAST_ATOL, FAST_MIN_R = 0.05, 1.0, 0.9999
STRUCT_FIELDS = ("pair_rows", "pair_cols", "pair_valid", "edge_pair", "key_sorted", "key_pos")


def make_case(n=300, k=7, f=128, e=3, seed=0):
    """tests/test_blocksparse.py:29-39 (random neighbors, so duplicates and
    index-0 neighbors occur, and padding slots), with one duplicated slot
    per row and an all-index-0 row forced."""
    rng = np.random.default_rng(seed)
    nlist = rng.integers(0, n, (n, k)).astype(np.int32)
    nlist[:, 0] = nlist[:, 1]
    nlist[7, :] = 0
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    dists[rng.uniform(size=(n, k)) < 0.2] = 0.0  # padding slots
    efeat = rng.normal(size=(n, k, e)).astype(np.float32) * (dists > 0)[..., None]
    nodes = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    inv = np.asarray(jinv_degree(jnp.asarray(nlist)))
    return nlist, dists, efeat, nodes, w, inv


def banded_case(n=600, k=16, seed=0):
    """nlist = i + randint(-40, 40), as tests/test_banded.py builds a band."""
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    dists[rng.uniform(size=(n, k)) < 0.1] = 0.0
    return nlist.astype(np.int32), dists


def same_structure(got, want):
    for f in STRUCT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.block_size, got.n_padded, got.nb, got.n_pairs) == (
        want.block_size, want.n_padded, want.nb, want.n_pairs)


@pytest.mark.parametrize("graph", ["random", "banded"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("pair_rounding", [0, 1, 32])
def test_block_structure_matches_jax(graph, group, pair_rounding):
    nlist, dists = make_case(n=520, k=11, seed=8)[:2] if graph == "random" else banded_case()
    got = tbs.block_structure(nlist, dists, 128, pair_rounding=pair_rounding, group=group)
    same_structure(got, jbs.block_structure(nlist, dists, 128, pair_rounding=pair_rounding,
                                            group=group))
    assert got.n_pairs % group == 0
    rows = got.pair_rows.reshape(-1, group)
    assert np.all(rows == rows[:, :1])  # runs never span two row blocks


def test_structure_pair_bucketing():
    """tests/test_blocksparse.py:184-193, array for array."""
    nlist = np.zeros((10, 2), np.int32)
    edges = np.ones((10, 2), np.float32)
    s = tbs.block_structure(nlist, edges, block_size=8)
    same_structure(s, jbs.block_structure(nlist, edges, block_size=8))
    assert s.nb == 2 and s.n_pairs == 8
    assert sorted(set(s.pair_rows.tolist())) == [0, 1]
    assert np.all(np.diff(s.pair_rows) >= 0)


def test_remap_frame_matches_jax():
    """A frame whose real edges stay in the active pairs is remapped (only
    edge_pair changes); one with a real edge to an inactive col block, or of
    another padded size, is not (None), in both packages."""
    nlist, dists = banded_case(seed=3)
    rng = np.random.default_rng(4)
    ts = tbs.block_structure(nlist, dists, 128, pair_rounding=32, group=4)
    js = jbs.block_structure(nlist, dists, 128, pair_rounding=32, group=4)
    moved = np.clip(nlist + rng.integers(-3, 4, nlist.shape), 0, nlist.shape[0] - 1)
    moved = moved.astype(np.int32)
    moved_d = np.where(rng.uniform(size=dists.shape) < 0.1, 0.0, dists).astype(np.float32)
    got, want = tbs.remap_frame(ts, moved, moved_d), jbs.remap_frame(js, moved, moved_d)
    assert got is not None and want is not None
    same_structure(got, want)
    assert got.pair_rows is ts.pair_rows and not np.array_equal(got.edge_pair, ts.edge_pair)
    far = moved.copy()
    far[0, 0] = nlist.shape[0] - 1  # row block 0 -> the last col block: no such pair
    real_d = moved_d.copy()
    real_d[0, 0] = 0.1
    assert tbs.remap_frame(ts, far, real_d) is None and jbs.remap_frame(js, far, real_d) is None
    far_d = moved_d.copy()
    far_d[0, 0] = 0.0  # the same slot as padding: no real edge leaves
    same_structure(tbs.remap_frame(ts, far, far_d), jbs.remap_frame(js, far, far_d))
    short = (nlist[:-128], dists[:-128])
    assert tbs.remap_frame(ts, *short) is None and jbs.remap_frame(js, *short) is None
    assert tbs.remap_frame(ts._replace(key_sorted=None), moved, moved_d) is None


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_block_adjacency_matches_jax(group, dtype):
    """float32 within 1e-5; bfloat16 within one bfloat16 step (both round
    the same float32 sum once); padding pairs exactly zero, even where one
    duplicates a real pair."""
    nlist, dists, efeat, *_ = make_case(n=400, k=9, seed=5)
    js = jbs.block_structure(nlist, dists, 128, pair_rounding=32, group=group)
    ts = tbs.block_structure(nlist, dists, 128, pair_rounding=32, group=group)
    want = jbs.build_block_adjacency_pallas(jnp.asarray(nlist), jnp.asarray(efeat), js,
                                            out_dtype=jnp.dtype(dtype), interpret=True)
    _cuda.reset_launch_counts()
    got = tbs.build_block_adjacency(torch.from_numpy(nlist), torch.from_numpy(efeat), ts,
                                    out_dtype=getattr(torch, dtype))
    assert tbs.build_block_adjacency.launches == 0  # the plain version on the CPU
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP, atol=1e-6)
    invalid = ts.pair_valid == 0
    assert invalid.any() and float(got[torch.from_numpy(invalid)].abs().max()) == 0.0


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mp_blocksparse_matches_jax(group, dtype):
    """float32 within 2e-4; bfloat16 operands within one bfloat16 step of
    the output's scale (h stays float32: the output is rounded once, after
    float32 sums taken in another order). Padding rows: softplus(0) + 0 =
    log 2."""
    n = 520
    nlist, dists, efeat, nodes, w, inv = make_case(n=n, k=11, seed=8)
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
    assert want.dtype == jd
    _cuda.reset_launch_counts()
    got = tbs.mp_blocksparse(torch.from_numpy(np.array(A)).to(td), ts,
                             torch.from_numpy(nodes_p).to(td), torch.from_numpy(w),
                             torch.from_numpy(inv_p), group=group)
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
    assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    tol = 2e-4 if dtype == "float32" else BF16_STEP * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-4, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(got[n:].numpy(), np.log(2.0), rtol=1e-6)


@pytest.fixture(scope="module")
def bundled():
    jparams, jcfg = jload_model()
    params, cfg = load_model(device="cpu")
    return jparams, jcfg, params, cfg


def in_fast_band(got, want, mean_atol=None):
    assert np.all(np.isfinite(got))
    assert np.corrcoef(got, want)[0, 1] > FAST_MIN_R
    np.testing.assert_allclose(got, want, rtol=FAST_RTOL, atol=FAST_ATOL)
    if mean_atol is not None:
        assert np.abs(got - want).mean() < mean_atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_blocksparse_matches_jax(bundled, dtype):
    """The bundled weights (F = 256) on a banded graph, the structure
    built as the JAX package serves it (pair_rounding 32, group 4): float32
    within 2e-4; bfloat16 within the fast band with a mean difference under
    0.05 ppm. The plain versions give the wrappers' result on the CPU."""
    jparams, jcfg, params, cfg = bundled
    jcfg, cfg = jcfg.replace(compute_dtype=dtype), cfg.replace(compute_dtype=dtype)
    nlist, dists = banded_case(n=500, seed=11)
    rng = np.random.default_rng(11)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], nlist.shape[0])]
    g = Graph(atoms, nlist, dists, np.asarray(jinv_degree(jnp.asarray(nlist))))
    js = jbs.block_structure(nlist, dists, 128, pair_rounding=32, group=4)
    want = np.asarray(japply_blocksparse(jparams, jcfg, JGraph(*map(jnp.asarray, g)), js,
                                         interpret=True, group=4))
    gt = Graph(*map(torch.from_numpy, g))
    ts = precompute_structure(gt, pair_rounding=32, group=4)
    with torch.no_grad():
        got = apply_blocksparse(params, cfg, gt, ts, group=4).numpy()
        plain = apply_blocksparse(params, cfg, gt, ts, use_kernels=False).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, plain)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        in_fast_band(got, want, mean_atol=0.05)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pdb") / "globule.pdb")
    write_synthetic_pdb(path, n_atoms=500, seed=2, frames=3)
    s = read_structure(path)
    return [structure2graph(s, frame=f) for f in range(3)]


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_serving_blocksparse_matches_jax(bundled, frames, precision, monkeypatch):
    """ServingModel(mode="blocksparse") over 3 jittered frames, RCM order
    and all, against the JAX ServingModel(mode="blocksparse") given a
    forward that passes its interpret flag on (its _blocksparse_fwd does
    not, so it fails on a CPU backend): the same structures frame by frame
    (remapped or rebuilt alike), exact peaks within 2e-4, fast peaks within
    the fast band with a mean difference under 0.05 ppm."""
    jparams, jcfg, params, cfg = bundled
    jsm = JServingModel(jparams, jcfg, use_pallas=True, interpret=True, mode="blocksparse",
                        precision=precision)

    def jax_block_fwd(struct):
        def fn(p, gj, rows, cols, valid, edge_pair):
            s = struct._replace(pair_rows=rows, pair_cols=cols, pair_valid=valid,
                                edge_pair=edge_pair)
            return japply_blocksparse(p, jsm.config, gj, s, interpret=True, group=jsm.group)
        return fn

    monkeypatch.setattr(jsm, "_blocksparse_fwd", jax_block_fwd)
    sm = ServingModel(params, cfg, device="cpu", mode="blocksparse", precision=precision)
    assert (sm.pair_rounding, sm.group) == (jsm.pair_rounding, jsm.group) == (32, 4)
    for f, g in enumerate(frames):
        want = jsm.predict(JGraph(*g))
        got = sm.predict(g)
        assert sm._resolved == jsm._resolved == "blocksparse"
        same_structure(sm._struct, jsm._struct)
        if precision == "exact":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=f"frame {f}")
        else:
            in_fast_band(got, want, mean_atol=0.05)
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
    assert not np.array_equal(sm.predict(frames[0]), sm.predict(frames[1]))
