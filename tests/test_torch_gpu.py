"""The port's CUDA kernels against their plain PyTorch versions on the card,
on inputs the main path does not give them: adversarial graphs (duplicate
neighbors, padding slots, index-0 neighbors, distances past the Chebyshev
domain, tile ids out of range, indices shifted negative), other widths,
edge channels, neighbor counts, activations and both element types
(float32, bfloat16).

These tests need a CUDA device and skip without one. On the card:

    python -m pytest tests/test_torch_gpu.py -q -p no:cacheprovider

They import nothing of JAX.
"""
import os
import sys

import numpy as np
import pytest
import torch

from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.infer import apply_banded, precompute_band
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded
from nmrgnn_tpu_torch.ops.edgefn import EdgeCheb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import et_stage_bound, split_windows  # noqa: E402

pytestmark = pytest.mark.gpu

BF16_STEP = 2.0 ** -7  # one bfloat16 step is at most 2^-7 of a value


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_case(n, k, f, e, seed, banded_nlist=False):
    rng = np.random.default_rng(seed)
    if banded_nlist:
        nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    else:
        nlist = rng.integers(0, n, (n, k))
    nlist = nlist.astype(np.int32)
    nlist[:, 0] = nlist[:, 1]  # duplicate neighbors
    nlist[7, :] = 0            # index-0 neighbors
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    dists[rng.uniform(size=(n, k)) < 0.2] = 0.0  # padding slots
    dists[5, :] = 0.0
    efeat = rng.normal(size=(n, k, e)).astype(np.float32) * (dists > 0)[..., None]
    nodes = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    return nlist, dists, efeat, nodes, w, inv_degree_from_nlist(nlist)


def _on(dev, *arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("n,k,e,seed", [
    (300, 7, 3, 0), (513, 16, 1, 1), (128, 3, 4, 2), (700, 16, 2, 3),
])
def test_build_band_kernel_matches_plain(dev, n, k, e, seed):
    nlist, dists, efeat, *_ = make_case(n, k, 8, e, seed)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, ef = _on(dev, nlist, efeat)
    before = banded.build_band.launches
    got = banded.build_band(nl, ef, plan)
    torch.cuda.synchronize()
    assert banded.build_band.launches == before + 1
    assert torch.equal(got, banded.build_band_plain(nl, ef, plan))  # the same slot-order sums


@pytest.mark.parametrize("f,e,act", [
    (256, 3, "softplus"), (128, 1, "relu"), (64, 4, "tanh"), (256, 2, "linear"),
])
def test_mp_banded_kernel_matches_plain(dev, f, e, act):
    n = 300
    nlist, dists, efeat, nodes, w, inv = make_case(n, 7, f, e, seed=f + e)
    plan = banded.band_plan(nlist, dists)
    pad = plan.n_padded - n
    nodes_p, inv_p = np.pad(nodes, ((0, pad), (0, 0))), np.pad(inv, (0, pad))
    plan = banded.plan_on_device(plan, dev)
    nl, ef, x, wt, iv = _on(dev, nlist, efeat, nodes_p, w, inv_p)
    M = banded.build_band_plain(nl, ef, plan)
    got = banded.mp_banded(M, plan, x, wt, iv, act)
    torch.testing.assert_close(got, banded.mp_banded_plain(M, plan, x, wt, iv, act),
                               rtol=2e-4, atol=2e-4)
    if act == "softplus":  # padding rows: softplus(0) + 0 = log(2)
        torch.testing.assert_close(got[n:], torch.full_like(got[n:], np.log(2.0)))


@pytest.mark.parametrize("k,e,edge_fc_layers", [(16, 3, 4), (8, 1, 1), (32, 4, 2)])
def test_fused_kernel_matches_plain(dev, k, e, edge_fc_layers):
    nlist, dists, *_ = make_case(400, k, 8, e, seed=k, banded_nlist=True)
    cfg = ModelConfig(edge_feature_size=e, edge_fc_layers=edge_fc_layers)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(k), device=dev)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, d = _on(dev, nlist, dists)
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation)
    got = banded.build_band_fused(nl, d, params["edge_fc"], plan, **kw)
    want = banded.build_band_fused_plain(nl, d, params["edge_fc"], plan, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """F = 96 (padded to 128) and H = 64 (padded to 128) run through the
    kernels and match their plain versions; a wrong index type or device
    still raises."""
    nlist, dists, efeat, nodes, w, inv = make_case(256, 7, 96, 3, seed=9)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, ef, x, wt, iv = _on(dev, nlist, efeat, nodes, w, inv)
    M = banded.build_band(nl, ef, plan)
    before = banded.mp_banded.launches
    got = banded.mp_banded(M, plan, x, wt, iv)  # F = 96
    assert banded.mp_banded.launches == before + 1 and got.shape == x.shape
    torch.testing.assert_close(got, banded.mp_banded_plain(M, plan, x, wt, iv),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(TypeError):
        banded.build_band(nl.long(), ef, plan)
    with pytest.raises(ValueError):
        banded.build_band(nl.cpu(), ef, plan)
    cfg = ModelConfig(edge_hidden_size=64)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high)
    d = _on(dev, dists)[0]
    got = banded.build_band_fused(nl, d, params["edge_fc"], plan, **kw)  # H = 64
    torch.testing.assert_close(
        got, banded.build_band_fused_plain(nl, d, params["edge_fc"], plan, **kw),
        rtol=1e-5, atol=1e-5)


def test_apply_banded_and_serving_on_the_card(dev):
    cfg = ModelConfig()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(1), device=dev)
    n = 600
    rng = np.random.default_rng(4)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-50, 50, (n, 16)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
    g = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    gt = Graph(*_on(dev, *g))
    ref = gnn.apply(params, cfg, gt)
    for kw in ({}, {"fused_edge": False}):
        torch.testing.assert_close(apply_banded(params, cfg, gt, precompute_band(g), **kw),
                                   ref, rtol=5e-4, atol=5e-4)
    peaks = ServingModel(params, cfg).predict(g)
    np.testing.assert_allclose(peaks, ref.cpu().numpy(), rtol=5e-4, atol=5e-4)


def make_cheb(e, degree=64, seed=0):
    """Chebyshev coefficients of E smooth channels (decaying with the
    degree, as a fit of the edge stage's are)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(degree + 1, e)) * 0.8 ** np.arange(degree + 1)[:, None]
    return EdgeCheb(coeffs=c.astype(np.float32), d_lo=0.0, d_hi=0.35)


def skewed_nlist(n, k, seed, spread_hi=180):
    rng = np.random.default_rng(seed)
    spread = np.where(np.arange(n) % 4 == 0, spread_hi, 30)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-1, 2, (n, k)) * spread[:, None]
                    + rng.integers(-20, 20, (n, k)), 0, n - 1).astype(np.int32)
    nlist[:, 0] = nlist[:, 1]  # duplicate neighbors
    nlist[7, :] = 0            # index-0 neighbors
    dists = rng.uniform(0.01, 0.45, (n, k)).astype(np.float32)  # past d_hi too
    dists[rng.uniform(size=(n, k)) < 0.2] = 0.0
    return nlist, dists


def _close(got, want, dtype):
    """float32: 1e-5; bfloat16: one step of the output (both round the
    same float32 sum once, summed in another order)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP, atol=1e-5)


@pytest.mark.parametrize("e,k,dtype", [
    (3, 16, torch.bfloat16), (3, 16, torch.float32), (1, 7, torch.bfloat16),
    (4, 3, torch.float32), (2, 32, torch.bfloat16),
])
def test_build_band_poly_kernel_matches_plain(dev, e, k, dtype):
    nlist, dists = skewed_nlist(520, k, seed=e + k)
    cheb = make_cheb(e, seed=k)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, d = _on(dev, nlist, dists)
    dev_cheb = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    before = banded.build_band_poly.launches
    got = banded.build_band_poly(nl, d, dev_cheb, plan, out_dtype=dtype)
    torch.cuda.synchronize()
    assert banded.build_band_poly.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, banded.build_band_poly_plain(nl, d, cheb, plan, out_dtype=dtype))


@pytest.mark.parametrize("e,dtype", [(3, torch.bfloat16), (1, torch.float32),
                                     (4, torch.bfloat16)])
def test_build_band_poly_cls_kernel_matches_plain(dev, e, dtype):
    nlist, dists = skewed_nlist(700, 12, seed=e)
    cls_plan = banded.band_plan_classes(nlist, dists)
    assert len(cls_plan.classes) > 1
    dplan = banded.plan_on_device(cls_plan, dev)
    cheb = make_cheb(e, seed=e)
    nl, d = _on(dev, nlist, dists)
    for c in dplan.classes:
        got = banded.build_band_poly_cls(nl, d, cheb, c, cls_plan.block_rows,
                                         cls_plan.n_padded, out_dtype=dtype)
        want = banded.build_band_poly_cls_plain(nl, d, cheb, c, cls_plan.block_rows,
                                                cls_plan.n_padded, out_dtype=dtype)
        assert torch.equal(got, want)
    # a tile id out of range reads nothing: that tile's band is zero
    c = cls_plan.classes[0]
    bad = c._replace(ids=np.array([cls_plan.num_tiles] + list(c.ids[1:]), np.int32))
    got = banded.build_band_poly_cls(nl, d, cheb, bad, cls_plan.block_rows,
                                     cls_plan.n_padded, out_dtype=dtype)
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(got[1:], banded.build_band_poly_cls_plain(
        nl, d, cheb, c, cls_plan.block_rows, cls_plan.n_padded, out_dtype=dtype)[1:])


@pytest.mark.parametrize("f,e,dtype", [
    (256, 3, torch.bfloat16), (256, 3, torch.float32), (128, 1, torch.bfloat16),
    (64, 4, torch.float32), (128, 2, torch.float32), (64, 4, torch.bfloat16),
])
def test_mp_banded_partial_kernel_matches_plain(dev, f, e, dtype):
    """float32: 2e-4, as the MP layer. bfloat16: h is rounded to bfloat16
    between the products, so a sum near a rounding boundary may move one h
    by a step; tolerance one step relative to the output's scale."""
    n = 300
    nlist, dists, efeat, nodes, w, _ = make_case(n, 7, f, e, seed=f + e, banded_nlist=True)
    plan = banded.band_plan(nlist, dists)
    extra = 256  # a table longer than T * B, windows in its middle
    rng = np.random.default_rng(f)
    table = rng.normal(size=(plan.n_padded + extra, f)).astype(np.float32)
    lo = plan.lo + extra // 2
    nl, ef, tab, wt = _on(dev, nlist, efeat, table, w)
    M = banded.build_band_plain(nl, ef, plan).to(dtype)
    before = banded.mp_banded_partial.launches
    got = banded.mp_banded_partial(M, lo, tab.to(dtype), wt)
    torch.cuda.synchronize()
    assert banded.mp_banded_partial.launches == before + 1 and got.dtype == torch.float32
    want = banded.mp_banded_partial_plain(M, lo, tab.to(dtype), wt)
    tol = 2e-4 if dtype == torch.float32 else BF16_STEP * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=tol)
    # lo as an int32 tensor on the card gives the same sums
    lo_dev = torch.as_tensor(lo, dtype=torch.int32, device=dev)
    torch.testing.assert_close(banded.mp_banded_partial(M, lo_dev, tab.to(dtype), wt), got,
                               rtol=0, atol=0)
    with pytest.raises(ValueError):  # a window past the table's end
        banded.mp_banded_partial(M, lo + extra, tab.to(dtype), wt)


@pytest.mark.parametrize("f,e,act", [
    (256, 3, "softplus"), (128, 1, "relu"), (64, 4, "tanh"),
])
def test_mp_banded_bf16_kernel_matches_plain(dev, f, e, act):
    """bfloat16 in and out, float32 sums; tolerance one step of h carried
    through the second product (relative to the output's scale) plus one
    rounding of the output."""
    n = 300
    nlist, dists, efeat, nodes, w, inv = make_case(n, 7, f, e, seed=f + e + 1)
    plan = banded.band_plan(nlist, dists)
    pad = plan.n_padded - n
    nodes_p, inv_p = np.pad(nodes, ((0, pad), (0, 0))), np.pad(inv, (0, pad))
    plan = banded.plan_on_device(plan, dev)
    nl, ef, x, wt, iv = _on(dev, nlist, efeat, nodes_p, w, inv_p)
    M = banded.build_band_plain(nl, ef, plan).bfloat16()
    got = banded.mp_banded(M, plan, x.bfloat16(), wt, iv, act)
    assert got.dtype == torch.bfloat16
    want = banded.mp_banded_plain(M, plan, x.bfloat16(), wt, iv, act).float()
    torch.testing.assert_close(got.float(), want, rtol=BF16_STEP,
                               atol=2 * BF16_STEP * float(want.abs().max()))


def test_fast_serving_on_the_card(dev):
    """Fast serving on a skewed graph takes the class forward through the
    kernels (one build per class, one partial MP per class and layer) and
    agrees with the same model's fast serving on the CPU (plain versions)
    within the fast band; the uniform forward runs one Chebyshev build and
    one bfloat16 MP layer per layer."""
    cfg = ModelConfig()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    n = 600
    rng = np.random.default_rng(6)
    nlist, dists = skewed_nlist(n, 16, seed=6)
    dists = np.where(dists > 0, np.clip(dists, 0.09, 0.3), 0.0).astype(np.float32)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    g = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    sm = ServingModel(params, cfg, reorder=False, precision="fast")
    _cuda.reset_launch_counts()
    got = sm.predict(g)
    classes = len(sm._cls_plan_vmem.classes)
    assert classes > 1
    assert banded.build_band_poly_cls.launches == classes
    assert banded.mp_banded_partial.launches == classes * cfg.mp_layers
    assert banded.mp_banded.launches == banded.build_band_poly.launches == 0
    want = ServingModel(params, cfg, device="cpu", reorder=False, precision="fast").predict(g)
    assert np.corrcoef(got, want)[0, 1] > 0.9999
    np.testing.assert_allclose(got, want, rtol=0.05, atol=1.0)
    _cuda.reset_launch_counts()
    gt = Graph(*_on(dev, *g))
    plan = banded.band_plan(nlist, dists)
    uni = apply_banded(sm.params, sm.config, gt, plan, cheb=sm._edge_cheb())
    assert banded.build_band_poly.launches == 1
    assert banded.mp_banded.launches == cfg.mp_layers
    plain = apply_banded(sm.params, sm.config, gt, plan, cheb=sm._edge_cheb(),
                         use_kernels=False)
    np.testing.assert_allclose(uni.cpu().numpy(), plain.cpu().numpy(), rtol=0.05, atol=1.0)


def _mp_case(dev, f, e, dtype, n=700, seed=0):
    """A band from a skewed graph (several window classes), a node table
    padded to the plan, weights and inv_degree, on the card."""
    nlist, dists = skewed_nlist(n, 12, seed=seed)
    rng = np.random.default_rng(seed)
    efeat = rng.normal(size=(n, 12, e)).astype(np.float32) * (dists > 0)[..., None]
    plan = banded.band_plan(nlist, dists)
    pad = plan.n_padded - n
    nodes = np.pad(rng.normal(size=(n, f)).astype(np.float32), ((0, pad), (0, 0)))
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    inv = np.pad(inv_degree_from_nlist(nlist), (0, pad))
    nl, ef, x, wt, iv = _on(dev, nlist, efeat, nodes, w, inv)
    dplan = banded.plan_on_device(plan, dev)
    M = banded.build_band_plain(nl, ef, dplan).to(dtype)
    return nlist, dists, nl, ef, dplan, M, x.to(dtype), wt, iv


def _mp_close(got, want, dtype):
    """float32: 2e-4, as the MP layer. bfloat16: one step of h (rounded
    between the products) relative to the output's scale, plus one
    rounding of the output."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                   atol=2 * BF16_STEP * float(want.float().abs().max()))


@pytest.mark.parametrize("f,e,dtype,act", [
    (256, 3, torch.float32, "softplus"), (256, 3, torch.bfloat16, "softplus"),
    (128, 1, torch.float32, "relu"), (64, 4, torch.bfloat16, "tanh"),
    (128, 2, torch.bfloat16, "linear"),
])
def test_mp_banded_hbm_kernel_matches_plain_and_mp_banded(dev, f, e, dtype, act):
    """B5 against its plain version, and equal to B1 bit for bit: one
    kernel behind two wrappers, each counting only its own launches."""
    *_, plan, M, x, wt, iv = _mp_case(dev, f, e, dtype, seed=f + e)
    before = banded.mp_banded_hbm.launches, banded.mp_banded.launches
    got = banded.mp_banded_hbm(M, plan, x, wt, iv, act)
    torch.cuda.synchronize()
    assert (banded.mp_banded_hbm.launches, banded.mp_banded.launches) == (before[0] + 1,
                                                                          before[1])
    assert got.dtype == dtype
    _mp_close(got, banded.mp_banded_hbm_plain(M, plan, x, wt, iv, act), dtype)
    torch.testing.assert_close(got, banded.mp_banded(M, plan, x, wt, iv, act), rtol=0, atol=0)
    assert (banded.mp_banded_hbm.launches, banded.mp_banded.launches) == (before[0] + 1,
                                                                          before[1] + 1)


@pytest.mark.parametrize("f,e,dtype", [
    (256, 3, torch.float32), (256, 3, torch.bfloat16), (128, 2, torch.bfloat16),
    (64, 4, torch.float32),
])
def test_mp_banded_hbm_cls_kernel_matches_plain(dev, f, e, dtype):
    """B9 per class against its plain version; its rows equal B5's rows of
    the class's tiles when the class band is the uniform band's columns;
    a reversed (non-contiguous) ids order moves the row blocks with it; an
    id out of range given on the card gives zero rows, one given as numpy
    raises."""
    nlist, dists, nl, ef, plan, _, x, wt, iv = _mp_case(dev, f, e, dtype, seed=f + 7 * e)
    cls_plan = banded.band_plan_classes(nlist, dists)
    assert len(cls_plan.classes) > 1
    B = cls_plan.block_rows
    for c in banded.plan_on_device(cls_plan, dev).classes:
        rows = c.ids.long()  # the class's band: its tiles of a build at its windows
        full = banded.build_band_plain(nl, ef, banded.BandPlan(
            lo=torch.zeros(plan.num_tiles, dtype=torch.int32, device=dev).index_put(
                (rows,), c.lo), window=c.window, block_rows=B, n_padded=plan.n_padded))
        Mc = full[rows].to(dtype).contiguous()
        before = banded.mp_banded_hbm_cls.launches
        got = banded.mp_banded_hbm_cls(Mc, c, B, x, wt, iv)
        torch.cuda.synchronize()
        assert banded.mp_banded_hbm_cls.launches == before + 1 and got.dtype == dtype
        _mp_close(got, banded.mp_banded_hbm_cls_plain(Mc, c, B, x, wt, iv), dtype)
        rev = c._replace(ids=c.ids.flip(0).contiguous(), lo=c.lo.flip(0).contiguous())
        got_rev = banded.mp_banded_hbm_cls(Mc.flip(0).contiguous(), rev, B, x, wt, iv)
        torch.testing.assert_close(got_rev.view(-1, B, f), got.view(-1, B, f).flip(0),
                                   rtol=0, atol=0)
    c = cls_plan.classes[0]
    bad_ids = np.array([cls_plan.num_tiles] + list(c.ids[1:]), np.int32)
    Mc = torch.zeros((len(c.ids), e, B, c.window), dtype=dtype, device=dev)
    with pytest.raises(ValueError):
        banded.mp_banded_hbm_cls(Mc, c._replace(ids=bad_ids), B, x, wt, iv)
    got = banded.mp_banded_hbm_cls(
        Mc, c._replace(ids=torch.as_tensor(bad_ids, device=dev)), B, x, wt, iv)
    assert float(got[:B].float().abs().max()) == 0.0
    ok = banded.mp_banded_hbm_cls(Mc, c, B, x, wt, iv)
    torch.testing.assert_close(got[B:], ok[B:], rtol=0, atol=0)


def test_hbm_class_forward_and_batched_frames_on_the_card(dev):
    """apply_banded_hbm_classes through the kernels against its plain
    versions (fast band), launching per class one build and one MP layer
    per layer; apply_banded_frames launches each kernel once for the
    batch and equals a per-frame loop of apply_banded within 2e-4."""
    from nmrgnn_tpu_torch.models.infer import apply_banded_frames, apply_banded_hbm_classes

    cfg = ModelConfig()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(3), device=dev)
    n = 600
    rng = np.random.default_rng(8)
    nlist, dists = skewed_nlist(n, 16, seed=8)
    dists = np.where(dists > 0, np.clip(dists, 0.09, 0.3), 0.0).astype(np.float32)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    g = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    gt = Graph(*_on(dev, *g))
    sm = ServingModel(params, cfg, reorder=False, precision="fast")
    cls_plan = banded.band_plan_classes(nlist, dists)
    nc = len(cls_plan.classes)
    assert nc > 1
    _cuda.reset_launch_counts()
    got = apply_banded_hbm_classes(sm.params, sm.config, gt, cls_plan, sm._edge_cheb())
    torch.cuda.synchronize()
    assert banded.build_band_poly_cls.launches == nc
    assert banded.mp_banded_hbm_cls.launches == nc * cfg.mp_layers
    want = apply_banded_hbm_classes(sm.params, sm.config, gt, cls_plan, sm._edge_cheb(),
                                    use_kernels=False)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.corrcoef(got, want)[0, 1] > 0.9999
    np.testing.assert_allclose(got, want, rtol=0.05, atol=1.0)

    frames = [g] + [g._replace(edges=np.where(
        dists > 0, dists * (1 + 0.01 * rng.normal(size=dists.shape)), 0.0).astype(np.float32))
        for _ in range(3)]
    stack = Graph(*_on(dev, *[np.stack([getattr(f, k) for f in frames]) for k in Graph._fields]))
    plan = banded.band_plan_frames(np.stack([f.nlist for f in frames]),
                                   np.stack([f.edges for f in frames]))
    _cuda.reset_launch_counts()
    batch = apply_banded_frames(params, cfg, stack, plan)
    torch.cuda.synchronize()
    assert banded.build_band_fused.launches == 1
    assert banded.mp_banded.launches == cfg.mp_layers
    loop = torch.stack([apply_banded(params, cfg, Graph(*_on(dev, *f)), plan) for f in frames])
    torch.testing.assert_close(batch, loop, rtol=2e-4, atol=2e-4)


def _block_case(dev, n, k, f, e, seed, banded_nlist, group):
    """make_case's adversarial graph, its block structure (pair_rounding
    32), the padded node table and inv_degree on the card."""
    from nmrgnn_tpu_torch.ops import blocksparse

    nlist, dists, efeat, nodes, w, inv = make_case(n, k, f, e, seed, banded_nlist)
    s = blocksparse.block_structure(nlist, dists, 128, pair_rounding=32, group=group)
    pad = s.n_padded - n
    nl, ef, x, wt, iv = _on(dev, nlist, efeat, np.pad(nodes, ((0, pad), (0, 0))), w,
                            np.pad(inv, (0, pad)))
    return s, blocksparse.struct_on_device(s, dev), nl, ef, x, wt, iv


@pytest.mark.parametrize("n,k,e,banded_nlist,group,dtype", [
    (400, 9, 3, False, 1, torch.float32), (400, 9, 3, False, 4, torch.bfloat16),
    (700, 16, 3, True, 4, torch.float32), (513, 16, 1, True, 1, torch.bfloat16),
    (300, 40, 4, False, 2, torch.float32), (128, 3, 2, False, 1, torch.float32),
])
def test_build_block_adjacency_kernel_matches_plain(dev, n, k, e, banded_nlist, group, dtype):
    """B10 against its plain version (float32 1e-5, bfloat16 one step: both
    sum in float32 in slot order and round once); padding pairs exactly
    zero, also where one duplicates a real pair; K past one warp's 32
    lanes; a structure given as numpy equals one on the card."""
    from nmrgnn_tpu_torch.ops import blocksparse

    s, sd, nl, ef, *_ = _block_case(dev, n, k, 8, e, n + k, banded_nlist, group)
    before = blocksparse.build_block_adjacency.launches
    got = blocksparse.build_block_adjacency(nl, ef, sd, out_dtype=dtype)
    torch.cuda.synchronize()
    assert blocksparse.build_block_adjacency.launches == before + 1 and got.dtype == dtype
    _close(got, blocksparse.build_block_adjacency_plain(nl, ef, sd, out_dtype=dtype), dtype)
    invalid = torch.as_tensor(s.pair_valid == 0, device=dev)
    if invalid.any():
        assert float(got[invalid].float().abs().max()) == 0.0
    torch.testing.assert_close(blocksparse.build_block_adjacency(nl, ef, s, out_dtype=dtype),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("f,e,dtype,act", [
    (256, 3, torch.float32, "softplus"), (256, 3, torch.bfloat16, "softplus"),
    (128, 1, torch.float32, "relu"), (64, 4, torch.bfloat16, "tanh"),
    (128, 2, torch.bfloat16, "linear"),
])
def test_mp_blocksparse_kernels_match_plain(dev, f, e, dtype, act):
    """B11 on the group-1 structure and B12 on the group-4 structure of the
    same graph against their plain version (float32 2e-4; bfloat16 one
    step of the output: h stays float32, the output is rounded once), and
    B12 equal to B11: the extra pairs add zeros. Each wrapper counts only
    its own launches. Padding rows: softplus(0) + 0 = log 2."""
    from nmrgnn_tpu_torch.ops import blocksparse

    n = 700
    s1, sd1, nl, ef, x, wt, iv = _block_case(dev, n, 16, f, e, f + e, True, 1)
    s4, sd4, *_ = _block_case(dev, n, 16, f, e, f + e, True, 4)
    assert not np.array_equal(s4.pair_rows, s1.pair_rows)  # the runs are padded
    A1 = blocksparse.build_block_adjacency(nl, ef, sd1, out_dtype=dtype)
    A4 = blocksparse.build_block_adjacency(nl, ef, sd4, out_dtype=dtype)
    x = x.to(dtype)
    before = blocksparse.mp_blocksparse.launches, blocksparse.mp_blocksparse_grouped.launches
    got1 = blocksparse.mp_blocksparse(A1, sd1, x, wt, iv, act)
    torch.cuda.synchronize()
    got4 = blocksparse.mp_blocksparse(A4, sd4, x, wt, iv, act, group=4)
    torch.cuda.synchronize()
    assert (blocksparse.mp_blocksparse.launches,
            blocksparse.mp_blocksparse_grouped.launches) == (before[0] + 1, before[1] + 1)
    assert got1.dtype == got4.dtype == dtype
    for got, A, s in ((got1, A1, sd1), (got4, A4, sd4)):
        want = blocksparse.mp_blocksparse_plain(A, s, x, wt, iv, act)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                       atol=BF16_STEP * float(want.float().abs().max()))
    torch.testing.assert_close(got4, got1, rtol=0, atol=0)
    if act == "softplus" and dtype == torch.float32:
        torch.testing.assert_close(got1[n:], torch.full_like(got1[n:], np.log(2.0)))


def test_blocksparse_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from nmrgnn_tpu_torch.ops import blocksparse

    s, sd, nl, ef, x, wt, iv = _block_case(dev, 300, 7, 96, 3, 5, False, 4)
    with pytest.raises(TypeError):  # int64 neighbor lists
        blocksparse.build_block_adjacency(nl.long(), ef, sd)
    with pytest.raises(TypeError):  # float16 output
        blocksparse.build_block_adjacency(nl, ef, sd, out_dtype=torch.float16)
    with pytest.raises(ValueError):  # neighbor lists on the CPU
        blocksparse.build_block_adjacency(nl.cpu(), ef, sd)
    A = blocksparse.build_block_adjacency(nl, ef, sd)
    got = blocksparse.mp_blocksparse(A, sd, x, wt, iv)  # F = 96, padded to 128
    torch.testing.assert_close(got, blocksparse.mp_blocksparse_plain(A, sd, x, wt, iv),
                               rtol=2e-4, atol=2e-4)
    x2, wt2 = x[:, :64].contiguous(), wt[:64, :64].contiguous()
    with pytest.raises(TypeError):  # A in float32, the table in bfloat16
        blocksparse.mp_blocksparse(A, sd, x2.bfloat16(), wt2, iv)
    with pytest.raises(ValueError):  # a table of another size than the structure's
        blocksparse.mp_blocksparse(A, sd, x2[:128].contiguous(), wt2, iv[:128].contiguous())
    with pytest.raises(ValueError):  # 3 does not divide the pair count (a multiple of 32)
        blocksparse.mp_blocksparse(A, sd, x2, wt2, iv, group=3)
    with pytest.raises(ValueError):  # a pair col past the last block
        blocksparse.build_block_adjacency(nl, ef, s._replace(pair_cols=s.pair_cols + s.nb))
    ok = blocksparse.mp_blocksparse(A, sd, x2, wt2, iv, group=4)  # the F = 64 kernel takes it
    # given on the card, a pair col out of range reads zeros (here a padding
    # pair's, whose A is zero) and offsets past the pair count are clamped
    bad = sd._replace(pair_cols=sd.pair_cols.clone(), row_ptr=sd.row_ptr.clone())
    bad.pair_cols[int(np.nonzero(s.pair_valid == 0)[0][-1])] = 10 ** 6
    bad.row_ptr[-1] = 10 ** 6
    got = blocksparse.mp_blocksparse(A, bad, x2, wt2, iv, group=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ok, rtol=0, atol=0)


def test_blocksparse_forward_and_serving_on_the_card(dev):
    """apply_blocksparse(group=1) launches 1 B10 and one B11 per layer and
    equals its plain versions within 2e-4; ServingModel(mode="blocksparse")
    launches per frame 1 B10 and one B12 per layer and equals the gather
    forward within 5e-4; fast serving lies in the fast band of it."""
    from nmrgnn_tpu_torch.models.infer import apply_blocksparse
    from nmrgnn_tpu_torch.ops import blocksparse

    cfg = ModelConfig()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(5), device=dev)
    n = 600
    rng = np.random.default_rng(9)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    nlist = rng.integers(0, n, (n, 16)).astype(np.int32)  # no band: many pairs
    dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
    g = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    gt = Graph(*_on(dev, *g))
    s = blocksparse.block_structure(nlist, dists, 128, pair_rounding=32)
    _cuda.reset_launch_counts()
    got = apply_blocksparse(params, cfg, gt, s)
    torch.cuda.synchronize()
    assert blocksparse.build_block_adjacency.launches == 1
    assert blocksparse.mp_blocksparse.launches == cfg.mp_layers
    assert blocksparse.mp_blocksparse_grouped.launches == 0
    torch.testing.assert_close(got, apply_blocksparse(params, cfg, gt, s, use_kernels=False),
                               rtol=2e-4, atol=2e-4)
    ref = gnn.apply(params, cfg, gt).cpu().numpy()
    _cuda.reset_launch_counts()
    exact = ServingModel(params, cfg, mode="blocksparse").predict(g)
    assert blocksparse.build_block_adjacency.launches == 1
    assert blocksparse.mp_blocksparse_grouped.launches == cfg.mp_layers
    np.testing.assert_allclose(exact, ref, rtol=5e-4, atol=5e-4)
    fast = ServingModel(params, cfg, mode="blocksparse", precision="fast").predict(g)
    assert np.corrcoef(fast, exact)[0, 1] > 0.9999
    np.testing.assert_allclose(fast, exact, rtol=0.05, atol=1.0)


# -- the fused Chebyshev build + MP layer 1 (B13), the builds with a
# -- caller-given window start (B7), the fused exact edge stage in bfloat16


def _mp_close(got, want, dtype):
    """The MP tolerances: float32 2e-4; bfloat16 one step of h carried
    through the second product (relative to the output's scale) plus one
    rounding of the output."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                   atol=2 * BF16_STEP * float(want.float().abs().max()))


@pytest.mark.parametrize("f,e,nodes_dtype,out_dtype,act", [
    (256, 3, torch.float32, torch.float32, "softplus"),
    (256, 3, torch.bfloat16, torch.bfloat16, "softplus"),
    (128, 1, torch.bfloat16, torch.float32, "relu"),
    (64, 4, torch.float32, torch.bfloat16, "tanh"),
])
def test_mp_banded_poly_fused_kernel_matches_plain_and_serial(dev, f, e, nodes_dtype,
                                                              out_dtype, act):
    """M within the build tolerances of its plain version and equal to
    build_band_poly's on the card bit for bit (the same Chebyshev function
    and slot order); nodes_1 within the MP tolerances of its plain version
    and equal bit for bit to build_band_poly (in nodes.dtype) followed by
    mp_banded: the same band entries through the same MP kernel."""
    n = 520
    nlist, dists = skewed_nlist(n, 16, seed=f + e)
    cheb = make_cheb(e, seed=e)
    plan = banded.band_plan(nlist, dists)
    rng = np.random.default_rng(f + e)
    nodes = rng.normal(size=(plan.n_padded, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    inv = rng.uniform(0, 1, plan.n_padded).astype(np.float32)
    plan = banded.plan_on_device(plan, dev)
    nl, d, x, wt, iv = _on(dev, nlist, dists, nodes, w, inv)
    x = x.to(nodes_dtype)
    before = banded.mp_banded_poly_fused.launches
    M, got = banded.mp_banded_poly_fused(nl, d, cheb, plan, x, wt, iv, act, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert banded.mp_banded_poly_fused.launches == before + 1
    assert M.dtype == out_dtype and got.dtype == nodes_dtype and got.shape == x.shape
    M_want, want = banded.mp_banded_poly_fused_plain(nl, d, cheb, plan, x, wt, iv, act,
                                                     out_dtype=out_dtype)
    _close(M, M_want, out_dtype)
    _mp_close(got, want, nodes_dtype)
    assert torch.equal(M, banded.build_band_poly(nl, d, cheb, plan, out_dtype=out_dtype))
    serial = banded.mp_banded(banded.build_band_poly(nl, d, cheb, plan, out_dtype=nodes_dtype),
                              plan, x, wt, iv, act)
    assert torch.equal(got, serial)


@pytest.mark.parametrize("e,dtype", [(3, torch.float32), (3, torch.bfloat16),
                                     (1, torch.bfloat16), (4, torch.float32)])
def test_tracedlo_builds_with_shifted_indices(dev, e, dtype):
    """Both builds with the plan's lo as a tensor equal build_band /
    build_band_poly; with nlist - m and lo - m (negative indices and
    window starts) the same bands, and their plain versions. The interior
    + halo composition of a 2-way row split at m (halo.py:609-645) equals
    one mp_banded_partial over the full band, within the MP tolerance."""
    n, k, f = 1000, 16, 128
    nlist, dists, efeat, *_ = make_case(n, k, 8, e, seed=e, banded_nlist=True)
    rng = np.random.default_rng(e)
    cheb = make_cheb(e, seed=e + 1)
    plan = banded.band_plan(nlist, dists)
    B, W, npad = plan.block_rows, plan.window, plan.n_padded
    m = (npad // 2 + B - 1) // B * B
    pad = npad - n
    nl_p, d_p, e_p = _on(dev, np.pad(nlist, ((0, pad), (0, 0)), constant_values=-1),
                         np.pad(dists, ((0, pad), (0, 0))),
                         np.pad(efeat, ((0, pad), (0, 0), (0, 0))))
    nl, d, ef = _on(dev, nlist, dists, efeat)
    lo = torch.as_tensor(plan.lo, dtype=torch.int32, device=dev)
    dplan = banded.plan_on_device(plan, dev)
    b2, b4 = banded.build_band_tracedlo.launches, banded.build_band_poly_tracedlo.launches
    bands = {
        "B2": (banded.build_band(nl, ef, dplan, out_dtype=dtype),
               lambda nl_, lo_, w_=W: banded.build_band_tracedlo(nl_, e_p[:nl_.shape[0]], lo_,
                                                                w_, B, dtype),
               lambda nl_, lo_, w_=W: banded.build_band_tracedlo_plain(
                   nl_, e_p[:nl_.shape[0]], lo_, w_, B, dtype)),
        "B4": (banded.build_band_poly(nl, d, cheb, dplan, out_dtype=dtype),
               lambda nl_, lo_, w_=W: banded.build_band_poly_tracedlo(
                   nl_, d_p[:nl_.shape[0]], cheb, lo_, w_, B, dtype),
               lambda nl_, lo_, w_=W: banded.build_band_poly_tracedlo_plain(
                   nl_, d_p[:nl_.shape[0]], cheb, lo_, w_, B, dtype)),
    }
    table = torch.as_tensor(rng.normal(size=(npad, f)).astype(np.float32), device=dev).to(dtype)
    w = torch.as_tensor((rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32), device=dev)
    lo_int, lo_halo = split_windows(plan.lo[: m // B], m, W, npad)
    for name, (full, build, plain) in bands.items():
        assert torch.equal(build(nl_p, lo), full), name
        shifted = build(nl_p - m, lo - m)
        torch.cuda.synchronize()
        assert torch.equal(shifted, full), name
        assert torch.equal(shifted, plain(nl_p - m, lo - m)), name
        M_int = build(nl_p[:m].contiguous(), lo_int)
        M_halo = build(nl_p[:m] - m, lo_halo)
        assert torch.equal(M_int, plain(nl_p[:m].contiguous(), lo_int)), name
        assert torch.equal(M_halo, plain(nl_p[:m] - m, lo_halo)), name
        acc = (banded.mp_banded_partial(M_int, lo_int, table[:m].contiguous(), w)
               + banded.mp_banded_partial(M_halo, lo_halo, table[m:].contiguous(), w))
        want = banded.mp_banded_partial(full[: m // B].contiguous(), plan.lo[: m // B], table, w)
        _mp_close(acc, want, dtype)
    assert banded.build_band_tracedlo.launches == b2 + 4
    assert banded.build_band_poly_tracedlo.launches == b4 + 4


def test_tracedlo_and_fused_first_wrappers_raise(dev):
    nlist, dists = skewed_nlist(300, 8, seed=3)
    nl, d = _on(dev, nlist[:256], dists[:256])
    cheb = make_cheb(3)
    plan = banded.plan_on_device(banded.band_plan(nlist[:256], dists[:256]), dev)
    iv = torch.ones(256, device=dev)
    x96 = torch.randn(256, 96, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    w96 = torch.randn(96, 96, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1)) / 10
    got = banded.mp_banded_poly_fused(nl, d, cheb, plan, x96, w96, iv)  # F = 96, padded
    want = banded.mp_banded_poly_fused_plain(nl, d, cheb, plan, x96, w96, iv)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):  # a node table of other rows than the plan's
        banded.mp_banded_poly_fused(nl, d, cheb, plan, torch.zeros(384, 128, device=dev),
                                    torch.zeros(128, 128, 3, device=dev), iv)
    lo = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # 250 rows are not whole 128-row tiles
        banded.build_band_poly_tracedlo(nl[:250].contiguous(), d[:250].contiguous(), cheb, lo,
                                        128)
    with pytest.raises(ValueError):  # lo of the wrong length
        banded.build_band_poly_tracedlo(nl, d, cheb, lo[:1], 128)
    with pytest.raises(TypeError):
        banded.build_band_tracedlo(nl, d[..., None].double(), lo, 128)


@pytest.mark.parametrize("k,e,edge_fc_layers,out_dtype,compute_dtype", [
    (16, 3, 4, torch.bfloat16, torch.bfloat16), (8, 1, 1, torch.bfloat16, torch.bfloat16),
    (32, 4, 2, torch.float32, torch.bfloat16), (16, 2, 3, torch.bfloat16, torch.float32),
])
def test_fused_kernel_bf16_matches_plain(dev, k, e, edge_fc_layers, out_dtype, compute_dtype):
    """The fused exact edge stage with bfloat16 operands and/or output
    against its plain version. Both round the same operands; the EdgeFC
    sums are taken in another order, so an activation near a bfloat16
    rounding boundary rounds the other way as the next product's operand
    and moves M by about a step: tolerance one bfloat16 step relative to
    M's scale."""
    nlist, dists, *_ = make_case(400, k, 8, e, seed=k + e, banded_nlist=True)
    cfg = ModelConfig(edge_feature_size=e, edge_fc_layers=edge_fc_layers)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(k), device=dev)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, d = _on(dev, nlist, dists)
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation,
              out_dtype=out_dtype, compute_dtype=compute_dtype)
    got = banded.build_band_fused(nl, d, params["edge_fc"], plan, **kw)
    want = banded.build_band_fused_plain(nl, d, params["edge_fc"], plan, **kw)
    assert got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                               atol=BF16_STEP * float(want.float().abs().max()))
    with pytest.raises(TypeError):
        banded.build_band_fused(nl, d, params["edge_fc"], plan, rbf_low=cfg.rbf_low,
                                rbf_high=cfg.rbf_high, compute_dtype=torch.float16)


def test_fused_first_forward_and_exact_bf16_serving_on_the_card(dev):
    """apply_banded(fused_first=True, cheb=...) launches 1 B13 and one B1
    per later layer, no B4, and equals the serial forward bit for bit;
    with hbm_table or without cheb, fused_first is ignored. Exact serving
    of a bfloat16 config launches 1 fused build and one bfloat16 B1 per
    layer a frame, within the fast band of the plain versions."""
    from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev

    cfg = ModelConfig()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(2), device=dev)
    n = 600
    rng = np.random.default_rng(6)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-50, 50, (n, 16)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
    g = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    gt = Graph(*_on(dev, *g))
    plan = banded.plan_on_device(precompute_band(g), dev)
    cheb = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                              rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation,
                              degree=64)
    L = cfg.mp_layers
    for c in (cfg, cfg.replace(compute_dtype="bfloat16")):
        _cuda.reset_launch_counts()
        fused = apply_banded(params, c, gt, plan, cheb=cheb, fused_first=True)
        torch.cuda.synchronize()
        assert banded.mp_banded_poly_fused.launches == 1
        assert banded.mp_banded.launches == L - 1 and banded.build_band_poly.launches == 0
        assert torch.equal(fused, apply_banded(params, c, gt, plan, cheb=cheb))
        _cuda.reset_launch_counts()
        for kw in ({"hbm_table": True, "cheb": cheb}, {}):
            assert torch.equal(apply_banded(params, c, gt, plan, fused_first=True, **kw),
                               apply_banded(params, c, gt, plan, **kw))
        assert banded.mp_banded_poly_fused.launches == 0
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    _cuda.reset_launch_counts()
    peaks = ServingModel(params, cfg16).predict(g)
    assert banded.build_band_fused.launches == 1 and banded.mp_banded.launches == L
    plain = apply_banded(params, cfg16, gt, plan, use_kernels=False).cpu().numpy()
    served = ServingModel(params, cfg16, reorder=False).predict(g)
    assert np.corrcoef(served, plain)[0, 1] > 0.9999
    np.testing.assert_allclose(served, plain, rtol=0.05, atol=1.0)
    assert np.abs(served - plain).mean() < 0.05
    exact = ServingModel(params, cfg).predict(g)
    np.testing.assert_allclose(peaks, exact, rtol=0.05, atol=1.0)


# -- the MP kernel that walks the band's nonzeros (csrc/mp.cuh): the chunk
# -- occupancy and every mode, on a band with an empty 32-row block


def _nz_case(dev, f, e, dtype, seed):
    """A skewed band whose rows 160-191 (tile 1, rows 32-63: one whole
    block of the MP kernel) have no real edge, with its node table,
    weights and inv_degree on the card."""
    n, k = 600, 12
    nlist, dists = skewed_nlist(n, k, seed=seed)
    dists[160:192] = 0.0
    rng = np.random.default_rng(seed)
    efeat = rng.normal(size=(n, k, e)).astype(np.float32) * (dists > 0)[..., None]
    plan = banded.band_plan(nlist, dists)
    pad = plan.n_padded - n
    nodes = np.pad(rng.normal(size=(n, f)).astype(np.float32), ((0, pad), (0, 0)))
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    inv = np.pad(inv_degree_from_nlist(nlist), (0, pad))
    nl, d, ef, x, wt, iv = _on(dev, nlist, dists, efeat, nodes, w, inv)
    dplan = banded.plan_on_device(plan, dev)
    M = banded.build_band_plain(nl, ef, dplan).to(dtype)
    return dict(nlist=nlist, dists=dists, nl=nl, d=d, ef=ef, plan=dplan, M=M, x=x.to(dtype),
                w=wt, inv=iv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_occupancy_kernels_match_plain(dev, dtype):
    """Both occupancy kernels equal their plain versions and each other;
    every nonzero of the band lies in a marked chunk and the empty block
    marks none; with a class's ids, a bad id marks nothing."""
    c = _nz_case(dev, 64, 3, dtype, seed=11)
    plan, M = c["plan"], c["M"]
    B, W = plan.block_rows, plan.window
    before = banded.band_occupancy.launches, banded.band_occupancy_from_band.launches
    got = banded.band_occupancy(c["nl"], c["d"], plan.lo, W, B, plan.n_padded)
    from_band = banded.band_occupancy_from_band(M)
    torch.cuda.synchronize()
    assert (banded.band_occupancy.launches, banded.band_occupancy_from_band.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, banded.band_occupancy_plain(c["nl"], c["d"], plan.lo, W, B,
                                                        plan.n_padded))
    assert torch.equal(from_band, banded.band_occupancy_from_band_plain(M))
    assert torch.equal(from_band, got)
    bits = banded.occupancy_bits(got, W).view(-1, B, W // 16)
    nz = (M != 0).any(1).view(-1, B, W // 16, 16).any(-1)
    assert not (nz & ~bits).any() and nz.any()
    assert not bits[1, 32:64].any()
    cls_plan = banded.band_plan_classes(c["nlist"], c["dists"])
    for cl in banded.plan_on_device(cls_plan, dev).classes:
        ids = cl.ids.clone()
        ids[0] = cls_plan.num_tiles
        args = (c["nl"], c["d"], cl.lo, cl.window, B, cls_plan.n_padded)
        got = banded.band_occupancy(*args, ids=ids)
        assert torch.equal(got, banded.band_occupancy_plain(*args, ids=ids))
        assert not got[:B].any()


@pytest.mark.parametrize("f,e", [(64, 1), (256, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["full", "ids", "partial", "build"])
def test_mp_kernel_every_mode_matches_plain(dev, mode, dtype, f, e):
    """The MP kernel in each mode against its plain version (the MP
    tolerances), with the occupancy from nlist equal bit for bit to the one
    derived from M. full: B1 on a band with an empty block. ids: B9 with a
    bad id (zero rows). partial: B6 with window rows outside the table (read
    as zeros). build: B13 equal to B4 + B1 bit for bit."""
    c = _nz_case(dev, f, e, dtype, seed=f + e)
    plan, M, x, wt, iv = c["plan"], c["M"], c["x"], c["w"], c["inv"]
    B, W = plan.block_rows, plan.window
    occ = banded.band_occupancy(c["nl"], c["d"], plan.lo, W, B, plan.n_padded)
    if mode == "full":
        got = banded.mp_banded(M, plan, x, wt, iv, "softplus", occ)
        _mp_close(got, banded.mp_banded_plain(M, plan, x, wt, iv, "softplus"), dtype)
        assert torch.equal(got, banded.mp_banded(M, plan, x, wt, iv, "softplus"))
    elif mode == "ids":
        cls_plan = banded.band_plan_classes(c["nlist"], c["dists"])
        cl = max(banded.plan_on_device(cls_plan, dev).classes, key=lambda k: len(k.ids))
        assert len(cl.ids) > 1
        rows = cl.ids.long()
        full = banded.build_band_plain(c["nl"], c["ef"], banded.BandPlan(
            lo=torch.zeros(plan.num_tiles, dtype=torch.int32, device=dev).index_put(
                (rows,), cl.lo), window=cl.window, block_rows=B, n_padded=plan.n_padded))
        Mc = full[rows].to(dtype).contiguous()
        bad = cl._replace(ids=torch.cat([torch.tensor([plan.num_tiles], dtype=torch.int32,
                                                      device=dev), cl.ids[1:]]))
        occ_c = banded.band_occupancy(c["nl"], c["d"], cl.lo, cl.window, B, plan.n_padded,
                                      ids=cl.ids)
        got = banded.mp_banded_hbm_cls(Mc, bad, B, x, wt, iv, "softplus", occ_c)
        assert float(got[:B].float().abs().max()) == 0.0
        want = banded.mp_banded_hbm_cls_plain(Mc, cl, B, x, wt, iv, "softplus")
        _mp_close(got[B:], want[B:], dtype)
        assert torch.equal(got[B:], banded.mp_banded_hbm_cls(Mc, bad, B, x, wt, iv)[B:])
    elif mode == "partial":
        n_t = int(plan.lo.max()) + W - 3 * 16  # the widest-reaching window passes the end
        table = x[:n_t]
        got = banded.mp_banded_partial(M, plan.lo, table, wt, occ)
        padded = torch.nn.functional.pad(table, (0, 0, 0, plan.n_padded - n_t))
        _mp_close(got, banded.mp_banded_partial_plain(M, plan.lo, padded, wt), dtype)
        assert torch.equal(got, banded.mp_banded_partial(M, plan.lo, table, wt))
    else:
        cheb = make_cheb(e, seed=e)
        M13, got = banded.mp_banded_poly_fused(c["nl"], c["d"], cheb, plan, x, wt, iv,
                                               "softplus", out_dtype=dtype)
        M4 = banded.build_band_poly(c["nl"], c["d"], cheb, plan, out_dtype=dtype)
        assert torch.equal(M13, M4)
        assert torch.equal(got, banded.mp_banded(M4, plan, x, wt, iv, "softplus", occ))
        _, want = banded.mp_banded_poly_fused_plain(c["nl"], c["d"], cheb, plan, x, wt, iv,
                                                    "softplus", out_dtype=dtype)
        _mp_close(got, want, dtype)


def test_exact_bf16_serving_on_the_other_paths(dev):
    """Exact serving of a bfloat16 config through "banded_hbm" (the path
    forced as the CPU tests force it), "blocksparse" and predict_frames:
    the compute type's kernels launched, peaks within the fast band of the
    float32 exact peaks."""
    cfg = ModelConfig()
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    params = gnn.init_params(cfg, torch.Generator().manual_seed(3), device=dev)
    n = 600
    rng = np.random.default_rng(8)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    frames = []
    for f in range(3):
        nlist = np.clip(np.arange(n)[:, None] + rng.integers(-50, 50, (n, 16)), 0, n - 1)
        nlist = nlist.astype(np.int32)
        dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
        frames.append(Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist)))
    exact = ServingModel(params, cfg, reorder=False)
    want = np.stack([exact.predict(g) for g in frames])
    L = cfg.mp_layers

    def in_band(got):
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
        np.testing.assert_allclose(got, want, rtol=0.05, atol=1.0)

    hbm = ServingModel(params, cfg16, reorder=False)
    hbm._resolved = "banded_hbm"
    _cuda.reset_launch_counts()
    in_band(np.stack([hbm.predict(g) for g in frames]))
    assert hbm._resolved == "banded_hbm"
    assert banded.mp_banded_hbm.launches == 3 * L and banded.mp_banded.launches == 0
    assert banded.band_occupancy.launches == 3

    from nmrgnn_tpu_torch.ops import blocksparse as bs

    _cuda.reset_launch_counts()
    wide = ServingModel(params, cfg16, mode="blocksparse", reorder=False)
    in_band(np.stack([wide.predict(g) for g in frames]))
    assert bs.mp_blocksparse_grouped.launches == 3 * L

    batch = ServingModel(params, cfg16, reorder=False)
    _cuda.reset_launch_counts()
    got = batch.predict_frames(frames)
    in_band(got)
    assert banded.mp_banded.launches in (L, 3 * L)  # batched, or frame by frame past the budget


# -- the block-sparse MP layer on mp.cuh's kernel (kPairs) and its block
# -- occupancy; the fused exact edge stage at every shape it takes


@pytest.mark.parametrize("block_size,group,dtype", [
    (128, 1, torch.float32), (128, 4, torch.bfloat16), (64, 2, torch.float32),
    (256, 1, torch.bfloat16),
])
def test_block_occupancy_kernels_match_plain(dev, block_size, group, dtype):
    """Both block-occupancy kernels equal their plain versions and each
    other word for word; every nonzero of A lies in a marked piece, padding
    pairs are empty; a structure given as numpy equals one on the card."""
    from nmrgnn_tpu_torch.ops import blocksparse

    nlist, dists, efeat, *_ = make_case(700, 16, 8, 3, seed=block_size + group,
                                        banded_nlist=True)
    s = blocksparse.block_structure(nlist, dists, block_size, pair_rounding=32, group=group)
    sd = blocksparse.struct_on_device(s, dev)
    nl, d, ef = _on(dev, nlist, dists, efeat)
    A = blocksparse.build_block_adjacency(nl, ef, sd, out_dtype=dtype)
    before = (blocksparse.block_occupancy.launches,
              blocksparse.block_occupancy_from_adjacency.launches)
    occ = blocksparse.block_occupancy(nl, d, sd)
    from_a = blocksparse.block_occupancy_from_adjacency(A)
    torch.cuda.synchronize()
    assert (blocksparse.block_occupancy.launches,
            blocksparse.block_occupancy_from_adjacency.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    assert torch.equal(occ, blocksparse.block_occupancy_plain(nl, d, sd))
    assert torch.equal(from_a, blocksparse.block_occupancy_from_adjacency_plain(A))
    assert torch.equal(occ, from_a) and occ.any()
    assert not occ[torch.as_tensor(s.pair_valid == 0, device=dev)].any()
    assert torch.equal(blocksparse.block_occupancy(nl, d, s), occ)


@pytest.mark.parametrize("f,e,dtype,act", [
    (256, 3, torch.float32, "softplus"), (256, 3, torch.bfloat16, "softplus"),
    (128, 1, torch.float32, "relu"), (64, 4, torch.bfloat16, "tanh"),
    (128, 2, torch.bfloat16, "linear"),
])
def test_mp_blocksparse_at_every_occupancy(dev, f, e, dtype, act):
    """B11 (group-1 structure) and B12 (group-4) given an empty, the real
    (from nlist) and a full occupancy, each against the plain version read
    through the same occupancy (the MP tolerances of
    test_mp_blocksparse_kernels_match_plain), and B12 equal to B11 bit for
    bit at each; the real and the full occupancy give the same bits."""
    from nmrgnn_tpu_torch.ops import blocksparse

    n = 700
    s1, sd1, nl, ef, x, wt, iv = _block_case(dev, n, 16, f, e, f + e, True, 1)
    s4, sd4, *_ = _block_case(dev, n, 16, f, e, f + e, True, 4)
    d = _on(dev, make_case(n, 16, f, e, f + e, True)[1])[0]
    x = x.to(dtype)
    outs = {}
    for grp, sd in ((1, sd1), (4, sd4)):
        A = blocksparse.build_block_adjacency(nl, ef, sd, out_dtype=dtype)
        real = blocksparse.block_occupancy(nl, d, sd)
        for name, occ in (("empty", torch.zeros_like(real)), ("real", real),
                          ("full", torch.full_like(real, -1))):
            got = blocksparse.mp_blocksparse(A, sd, x, wt, iv, act, group=grp, occupancy=occ)
            want = blocksparse.mp_blocksparse_plain(A, sd, x, wt, iv, act, occupancy=occ)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
            else:
                torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                           atol=BF16_STEP * float(want.float().abs().max()))
            outs[grp, name] = got
    for name in ("empty", "real", "full"):
        assert torch.equal(outs[4, name], outs[1, name]), name
    assert torch.equal(outs[1, "full"], outs[1, "real"])
    if act == "softplus" and dtype == torch.float32:  # h = 0: softplus(0) + nodes
        torch.testing.assert_close(outs[1, "empty"], torch.log(torch.tensor(2.0)) + x,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mp_blocksparse_row_block_past_one_segment(dev, dtype):
    """Row block 0 holds 300 pairs, so at a full occupancy a block lists
    2,400 (pair, chunk) entries, past one segment of the kernel's list:
    the layer still equals its plain version and the real occupancy's."""
    from nmrgnn_tpu_torch.ops import blocksparse

    nbk, k, f, e = 300, 16, 64, 1
    n = nbk * 128
    rng = np.random.default_rng(3)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    cols = (np.arange(128)[:, None] * k + np.arange(k)) % nbk  # row block 0: every col block
    nlist[:128] = cols * 128 + rng.integers(0, 128, (128, k))
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    efeat = rng.normal(size=(n, k, e)).astype(np.float32)
    s = blocksparse.block_structure(nlist, dists, 128, pair_rounding=32)
    assert int(s.pair_rows[s.pair_valid == 1].tolist().count(0)) == nbk
    sd = blocksparse.struct_on_device(s, dev)
    nodes = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    nl, d, ef, x, wt, iv = _on(dev, nlist, dists, efeat, nodes, w, inv_degree_from_nlist(nlist))
    x = x.to(dtype)
    A = blocksparse.build_block_adjacency(nl, ef, sd, out_dtype=dtype)
    real = blocksparse.block_occupancy(nl, d, sd)
    full = torch.full_like(real, -1)
    got = blocksparse.mp_blocksparse(A, sd, x, wt, iv, occupancy=full)
    _mp_close(got, blocksparse.mp_blocksparse_plain(A, sd, x, wt, iv), dtype)
    assert torch.equal(got, blocksparse.mp_blocksparse(A, sd, x, wt, iv, occupancy=real))


@pytest.mark.parametrize("k,e,hidden", [
    (8, 1, 0), (16, 2, 1), (32, 3, 2), (16, 4, 3), (8, 3, 3), (32, 1, 1), (16, 3, 3),
])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_every_shape(dev, k, e, hidden, compute_dtype):
    """The fused exact edge stage at K in {8, 16, 32}, E in 1-4 and 0-3
    hidden layers, on a graph with padded rows (400 atoms in 512 rows),
    against its plain version: float32 within 1e-5 (the float32 output);
    bfloat16 operands within one bfloat16 step of M's scale (the bfloat16
    output: the EdgeFC sums are taken in another order on the tensor
    cores)."""
    nlist, dists, *_ = make_case(400, k, 8, e, seed=k + e + hidden, banded_nlist=True)
    cfg = ModelConfig(edge_feature_size=e, edge_fc_layers=hidden + 1)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(k + hidden), device=dev)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    assert plan.n_padded > nlist.shape[0]
    nl, d = _on(dev, nlist, dists)
    out_dtype = compute_dtype
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation,
              out_dtype=out_dtype, compute_dtype=compute_dtype)
    got = banded.build_band_fused(nl, d, params["edge_fc"], plan, **kw)
    want = banded.build_band_fused_plain(nl, d, params["edge_fc"], plan, **kw)
    assert got.dtype == out_dtype
    if compute_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                   atol=BF16_STEP * float(want.float().abs().max()))
    rows = torch.arange(plan.num_tiles * plan.block_rows, device=dev).view(
        plan.num_tiles, 1, plan.block_rows, 1)
    assert not got.masked_select(rows >= nlist.shape[0]).any()  # padded rows stay zero


@pytest.mark.parametrize("cut", [1, 2, 4])
def test_band_writers_take_any_window(dev, cut):
    """The band-row writer B2, B3 and B4 share (common.cuh's band_rows) at
    a window cut by 1, 2 and 4 columns, so W % 4 is 3, 2 and 0 (stores one
    by one, and 16 bytes at a time in float32): each build against its
    plain version, indices past the cut dropped; B2 and B4 equal to it,
    B3 within the tolerances above."""
    nlist, dists, efeat, *_ = make_case(400, 16, 8, 3, seed=cut, banded_nlist=True)
    cfg = ModelConfig(edge_feature_size=3)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(cut), device=dev)
    plan = banded.band_plan(nlist, dists)
    plan = banded.plan_on_device(plan._replace(window=plan.window - cut), dev)
    nl, d, ef = _on(dev, nlist, dists, efeat)
    got = banded.build_band(nl, ef, plan)
    assert got.shape[-1] == plan.window
    assert torch.equal(got, banded.build_band_plain(nl, ef, plan))
    cheb = make_cheb(3, seed=cut)
    dev_cheb = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(banded.build_band_poly(nl, d, dev_cheb, plan, out_dtype=dt),
                           banded.build_band_poly_plain(nl, d, cheb, plan, out_dtype=dt))
        kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                  activation_name=cfg.fc_activation, out_dtype=dt, compute_dtype=dt)
        got = banded.build_band_fused(nl, d, params["edge_fc"], plan, **kw)
        want = banded.build_band_fused_plain(nl, d, params["edge_fc"], plan, **kw)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                       atol=BF16_STEP * float(want.float().abs().max()))


def test_blocksparse_occupancy_and_fused_wrappers_raise(dev):
    """What the new kernels' wrappers refuse: a block size the occupancy
    kernels do not take, an occupancy of another shape or type; a K the
    fused build's 128-slot blocks do not divide runs with the last slots
    masked."""
    from nmrgnn_tpu_torch.ops import blocksparse

    s, sd, nl, ef, x, wt, iv = _block_case(dev, 300, 7, 64, 3, 5, False, 1)
    d = torch.ones(nl.shape, dtype=torch.float32, device=dev)
    odd = blocksparse.block_structure(nl.cpu().numpy(), d.cpu().numpy(), 48)
    with pytest.raises(NotImplementedError):  # B = 48
        blocksparse.block_occupancy(nl, d, odd)
    with pytest.raises(TypeError):  # float64 distances
        blocksparse.block_occupancy(nl, d.double(), sd)
    A = blocksparse.build_block_adjacency(nl, ef, sd)
    occ = blocksparse.block_occupancy(nl, d, sd)
    with pytest.raises(ValueError):
        blocksparse.mp_blocksparse(A, sd, x, wt, iv, occupancy=occ[:-1].contiguous())
    with pytest.raises(TypeError):
        blocksparse.mp_blocksparse(A, sd, x, wt, iv, occupancy=occ.long())
    nlist, dists, *_ = make_case(256, 12, 8, 3, seed=1, banded_nlist=True)
    cfg = ModelConfig()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high)
    got = banded.build_band_fused(*_on(dev, nlist, dists), params["edge_fc"], plan, **kw)
    torch.testing.assert_close(  # K = 12: 8 atoms (96 of 128 slots) a block
        got, banded.build_band_fused_plain(*_on(dev, nlist, dists), params["edge_fc"], plan,
                                           **kw), rtol=1e-5, atol=1e-5)


# -- the band builds by row group (csrc/banded.cu, csrc/poly.cu: B2, B4, B7, B8)


def _build_inputs(n, k, e, seed, block_rows):
    """A banded graph with duplicate indices, a row of one index K times,
    padding slots, distances past the Chebyshev domain and an all-padding
    tile (rows [block_rows, 2 block_rows): index -1, distance 0), with edge
    values zero on padding."""
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-60, 60, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    if k > 1:
        nlist[:, 0] = nlist[:, 1]  # duplicate indices
    nlist[7, :] = 0                # one index K times
    dists = rng.uniform(0.01, 0.45, (n, k)).astype(np.float32)  # d_hi is 0.35
    dists[rng.uniform(size=(n, k)) < 0.2] = 0.0
    nlist[block_rows:2 * block_rows] = -1
    dists[block_rows:2 * block_rows] = 0.0
    efeat = rng.normal(size=(n, k, e)).astype(np.float32) * (dists > 0)[..., None]
    return nlist, dists, efeat


def _every_build(dev, nlist, dists, efeat, cheb, block_rows, dtype, window_cut=0):
    """(name, kernel band, plain band) of B2, B4, B8 (each window class, one
    id out of range), B7a and B7b (the plan's window starts, and indices
    and starts shifted by -m, negative)."""
    plan = banded.band_plan(nlist, dists, block_rows=block_rows)
    plan = plan._replace(window=plan.window - window_cut)
    B, W, npad = plan.block_rows, plan.window, plan.n_padded
    dplan = banded.plan_on_device(plan, dev)
    nl, d, ef = _on(dev, nlist, dists, efeat)
    dc = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    out = [("B2", banded.build_band(nl, ef, dplan, out_dtype=dtype),
            banded.build_band_plain(nl, ef, dplan, out_dtype=dtype)),
           ("B4", banded.build_band_poly(nl, d, dc, dplan, out_dtype=dtype),
            banded.build_band_poly_plain(nl, d, cheb, dplan, out_dtype=dtype))]
    cls_plan = banded.band_plan_classes(nlist, dists, block_rows=block_rows)
    for c in cls_plan.classes:
        c = c._replace(window=c.window - window_cut)
        got = banded.build_band_poly_cls(nl, d, dc, c, B, npad, out_dtype=dtype)
        out.append((f"B8 @ {c.window}", got, banded.build_band_poly_cls_plain(
            nl, d, cheb, c, B, npad, out_dtype=dtype)))
        bad = c._replace(ids=np.concatenate([[cls_plan.num_tiles + 3], c.ids[1:]]).astype(
            np.int32))
        got = banded.build_band_poly_cls(nl, d, dc, bad, B, npad, out_dtype=dtype)
        want = out[-1][2].clone()
        want[0] = 0  # a tile id out of range reads nothing
        out.append((f"B8 @ {c.window}, bad id", got, want))
    pad = npad - nlist.shape[0]
    nl_p, d_p, e_p = _on(dev, np.pad(nlist, ((0, pad), (0, 0)), constant_values=-1),
                         np.pad(dists, ((0, pad), (0, 0))),
                         np.pad(efeat, ((0, pad), (0, 0), (0, 0))))
    m = (npad // 2 + B - 1) // B * B
    lo = torch.as_tensor(plan.lo, dtype=torch.int32, device=dev)
    for shift in (0, m):
        out.append((f"B7a, lo - {shift}",
                    banded.build_band_tracedlo(nl_p - shift, e_p, lo - shift, W, B, dtype),
                    banded.build_band_tracedlo_plain(nl_p - shift, e_p, lo - shift, W, B,
                                                     dtype)))
        out.append((f"B7b, lo - {shift}",
                    banded.build_band_poly_tracedlo(nl_p - shift, d_p, dc, lo - shift, W, B,
                                                    dtype),
                    banded.build_band_poly_tracedlo_plain(nl_p - shift, d_p, cheb, lo - shift,
                                                          W, B, dtype)))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("e,k", [(1, 1), (2, 3), (3, 16), (4, 32), (1, 128), (4, 128), (3, 3)])
@pytest.mark.parametrize("block_rows", [128, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_builds_equal_plain_bitwise(dev, e, k, block_rows, dtype):
    """B2, B4, B7a, B7b and B8 equal their plain versions bit for bit: the
    same float32 values summed in slot order from 0 and rounded once."""
    nlist, dists, efeat = _build_inputs(700, k, e, seed=e * 131 + k, block_rows=block_rows)
    cheb = make_cheb(e, degree=96, seed=k)
    for name, got, want in _every_build(dev, nlist, dists, efeat, cheb, block_rows, dtype):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name


def _max_degree(e):
    return banded.POLY_MAX_COEFFS // e - 1


@pytest.mark.parametrize("e", [1, 2, 3, 4])
@pytest.mark.parametrize("which", ["one", "96", "largest"])
def test_chebyshev_builds_every_degree(dev, e, which):
    """B4 and B7b at degree 1, 96 and the largest (degree + 1) * E the
    kernel stages (1024), in float32 and bfloat16, bit for bit."""
    degree = {"one": 1, "96": 96, "largest": _max_degree(e)}[which]
    nlist, dists, _ = _build_inputs(300, 16, e, seed=degree, block_rows=128)
    cheb = make_cheb(e, degree=degree, seed=e)
    plan = banded.band_plan(nlist, dists)
    dplan = banded.plan_on_device(plan, dev)
    nl, d = _on(dev, nlist, dists)
    pad = plan.n_padded - nlist.shape[0]
    nl_p, d_p = nnf_pad_rows(nl, d, pad)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(banded.build_band_poly(nl, d, cheb, dplan, out_dtype=dtype),
                           banded.build_band_poly_plain(nl, d, cheb, dplan, out_dtype=dtype))
        assert torch.equal(
            banded.build_band_poly_tracedlo(nl_p, d_p, cheb, dplan.lo, plan.window, 128, dtype),
            banded.build_band_poly_tracedlo_plain(nl_p, d_p, cheb, dplan.lo, plan.window, 128,
                                                  dtype))


def nnf_pad_rows(nl, d, pad):
    """nlist and distances padded by ``pad`` rows (-1, 0)."""
    return (torch.nn.functional.pad(nl, (0, 0, 0, pad), value=-1),
            torch.nn.functional.pad(d, (0, 0, 0, pad)))


@pytest.mark.parametrize("cut", [0, 7, 4])  # W % 8 of 0, 1 and 4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_builds_any_window_and_small_tiles(dev, cut, dtype):
    """Every build at windows cut by 0, 7 and 4 columns (W % 8 of 0, 1 and
    4: 16-byte stores, or one value at a time), and the caller-given-start
    builds with 8 and 6 rows a tile (a block takes 4 and 2 rows), window
    starts shifted negative: bit for bit equal to their plain versions."""
    nlist, dists, efeat = _build_inputs(520, 16, 3, seed=cut, block_rows=128)
    cheb = make_cheb(3, degree=64, seed=cut)
    for name, got, want in _every_build(dev, nlist, dists, efeat, cheb, 128, dtype, cut):
        assert got.shape[-1] % 8 == (-cut) % 8, name
        assert torch.equal(got, want), name
    nl, d, ef = _on(dev, nlist[:504], dists[:504], efeat[:504])
    for rows in (8, 6):
        t = 504 // rows
        lo = torch.as_tensor(np.arange(t) * rows - 40 - 300, dtype=torch.int32, device=dev)
        W = 96 - cut
        assert torch.equal(banded.build_band_tracedlo(nl - 300, ef, lo, W, rows, dtype),
                           banded.build_band_tracedlo_plain(nl - 300, ef, lo, W, rows, dtype))
        assert torch.equal(
            banded.build_band_poly_tracedlo(nl - 300, d, cheb, lo, W, rows, dtype),
            banded.build_band_poly_tracedlo_plain(nl - 300, d, cheb, lo, W, rows, dtype))


def test_band_build_wrappers_raise_past_the_kernels_limits(dev):
    """What the build kernels do not take: K past the 8,192 slots a block
    stages, degree 0, a row count that is not whole tiles, an output type
    other than float32 or bfloat16. E > 4 and (degree + 1) * E > 1024 run
    as channel groups, equal to the plain versions bit for bit."""
    k = banded.MAX_K + 1
    nlist, dists, efeat = _build_inputs(256, k, 3, seed=1, block_rows=128)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, d, ef = _on(dev, nlist, dists, efeat)
    with pytest.raises(NotImplementedError):  # K = 8,193
        banded.build_band(nl, ef, plan)
    with pytest.raises(NotImplementedError):
        banded.build_band_poly(nl, d, make_cheb(3), plan)
    nl, d, ef = nl[:, :16].contiguous(), d[:, :16].contiguous(), ef[:, :16].contiguous()
    e5 = torch.randn(256, 16, 5, device=dev) * (d > 0)[..., None]
    assert torch.equal(banded.build_band(nl, e5, plan), banded.build_band_plain(nl, e5, plan))
    wide = make_cheb(3, degree=_max_degree(3) + 1)  # (degree + 1) * E = 1026
    assert torch.equal(banded.build_band_poly(nl, d, wide, plan),
                       banded.build_band_poly_plain(nl, d, wide, plan))
    with pytest.raises(NotImplementedError):  # degree 0
        banded.build_band_poly(nl, d, make_cheb(3, degree=0), plan)
    with pytest.raises(ValueError):  # 256 rows are not whole 96-row tiles
        banded.build_band_tracedlo(nl, ef, torch.zeros(3, dtype=torch.int32, device=dev), 128,
                                   96)
    with pytest.raises(TypeError):
        banded.build_band_poly(nl, d, make_cheb(3), plan, out_dtype=torch.float16)


# -- the training step: the differentiable wrappers and the Trainer ----------------


def _grads(fn, inputs, cot):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, cot)


def _close_rel(got, want, tol):
    scale = float(want.float().abs().max()) + 1e-9
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale)


@pytest.mark.parametrize("n,f", [(300, 128), (517, 256), (256, 64)])
def test_band_df_wrappers_gradients_equal_plain(dev, n, f):
    """build_band_df, build_band_tracedlo_df, mp_banded_df and
    mp_banded_partial_df on the card (kernels forward, plain backward)
    against autograd through the plain versions on the card."""
    nlist, dists, efeat, nodes, w, inv = make_case(n, 16, f, 3, seed=n, banded_nlist=True)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    pad = plan.n_padded - n
    nl, ef, d = _on(dev, nlist, efeat, dists)
    gen = torch.Generator(device=dev).manual_seed(n)
    gM = torch.randn((plan.num_tiles, 3, plan.block_rows, plan.window), generator=gen,
                     device=dev)
    M, (de,) = _grads(lambda e: banded.build_band_df(nl, e, plan), [ef], gM)
    M_p, (de_p,) = _grads(lambda e: banded.build_band_plain(nl, e, plan), [ef], gM)
    assert torch.equal(M, M_p)
    _close_rel(de, de_p, 1e-5)
    nl_p = torch.nn.functional.pad(nl, (0, 0, 0, pad), value=-1) - 128
    ef_p = torch.nn.functional.pad(ef, (0, 0, 0, 0, 0, pad))
    Mt, (det,) = _grads(lambda e: banded.build_band_tracedlo_df(nl_p, e, plan.lo, plan.window),
                        [ef_p], gM)
    Mt_p, (det_p,) = _grads(lambda e: banded.build_band_tracedlo_plain(
        nl_p, e, plan.lo, plan.window), [ef_p], gM)
    assert torch.equal(Mt, Mt_p)
    _close_rel(det, det_p, 1e-5)
    x = torch.from_numpy(np.pad(nodes, ((0, pad), (0, 0)))).to(dev)
    wt = torch.from_numpy(w).to(dev)
    iv = torch.from_numpy(np.pad(inv, (0, pad))).to(dev)
    g = torch.randn(x.shape, generator=gen, device=dev)
    occ = banded.band_occupancy(nl, d, plan.lo, plan.window, plan.block_rows,
                                plan.n_padded)
    out, grads = _grads(lambda *a: banded.mp_banded_df(a[0], plan, a[1], a[2], a[3],
                                                       "softplus", occ), [M, x, wt, iv], g)
    out_p, grads_p = _grads(lambda *a: banded.mp_banded_plain(a[0], plan, a[1], a[2], a[3]),
                            [M, x, wt, iv], g)
    _close_rel(out, out_p, 2e-4)
    for a, b in zip(grads, grads_p):
        _close_rel(a, b, 1e-4)
    out, grads = _grads(lambda *a: banded.mp_banded_partial_df(a[0], plan.lo, a[1], a[2]),
                        [M, x, wt], g)
    out_p, grads_p = _grads(lambda *a: banded.mp_banded_partial_plain(a[0], plan.lo, a[1], a[2]),
                            [M, x, wt], g)
    _close_rel(out, out_p, 2e-4)
    for a, b in zip(grads, grads_p):
        _close_rel(a, b, 1e-4)


def _fragment_batch(dev, b=4, n=128, k=16, seed=0):
    """A batch of b random fragments of n atoms, half of them padding rows."""
    rng = np.random.default_rng(seed)
    real = n // 2
    nlist = np.zeros((b, n, k), np.int32)
    nlist[:, :real] = rng.integers(0, real, (b, real, k))
    dists = np.zeros((b, n, k), np.float32)
    dists[:, :real] = rng.uniform(0.08, 0.3, (b, real, k))
    atoms = np.zeros((b, n, 10), np.float32)
    atoms[:, :real, 4] = 1.0  # hydrogen: an element with shift standards
    inv = np.stack([inv_degree_from_nlist(x) for x in nlist])
    return Graph(*[torch.from_numpy(a).to(dev) for a in (atoms, nlist, dists, inv)])


def test_training_forward_keeps_a_noised_real_slot(dev):
    """A real slot whose noised distance falls to <= 0 still carries its
    message: the band's occupancy comes from the distances before the
    noise. Kernels against the plain versions, value and gradients."""
    from nmrgnn_tpu_torch.models.infer import apply_banded_fragments

    cfg = ModelConfig(atom_feature_size=128, edge_hidden_size=32, mp_layers=2, fc_layers=2,
                      edge_fc_layers=2, dropout=False)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    g = _fragment_batch(dev)
    noise = torch.zeros(g.edges.shape, device=dev)
    noise[0, :8, :] = -(g.edges[0, :8, :] / cfg.noise) - 1.0  # 128 real slots below 0
    assert bool((g.edges[0, :8] + cfg.noise * noise[0, :8] < 0).all())
    leaves = gnn.trainable_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    res = []
    for use_kernels in (True, False):
        peaks = apply_banded_fragments(params, cfg, g, training=True, noise=noise,
                                       use_kernels=use_kernels)
        res.append((peaks.detach(), torch.autograd.grad(peaks.sum(), leaves)))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=5e-4, atol=5e-4)
    for a, b in zip(res[0][1], res[1][1]):
        _close_rel(a, b, 1e-3)
    clean = apply_banded_fragments(params, cfg, g).detach()
    assert not torch.allclose(res[0][0][0, :8], clean[0, :8])


def test_trainer_step_on_the_card(dev):
    """One Trainer step on "cuda" on the banded path: its launches, a finite
    loss, and params that moved; the loss equal to the gather path's from the
    same state (rel 1e-5) and the params after Adam within a tenth of its
    step (1e-4 at lr 1e-3)."""
    from nmrgnn_tpu_torch.config import TrainConfig
    from nmrgnn_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(atom_feature_size=128, edge_hidden_size=32, mp_layers=2, fc_layers=2,
                      edge_fc_layers=2, learning_rate=1e-3, noise=0.0, dropout=False)
    g = _fragment_batch(dev)
    y = torch.zeros(g.nlist.shape[:2] + (3,), device=dev)
    y[..., 0] = torch.rand(g.nlist.shape[:2], generator=torch.Generator(device=dev).manual_seed(2),
                           device=dev) * 10  # varied: Pearson's r of constant labels has no gradient
    y[..., 1] = 1.0
    y[:, :64, 2] = 1.0
    w = torch.ones(g.nlist.shape[:2], device=dev)
    after, losses = {}, {}
    for path in ("banded", "gather"):
        tr = Trainer(cfg, TrainConfig(batch_size=4, pad_to=128, mp_path=path))
        assert tr.use_banded == (path == "banded")
        state = tr.init_state(torch.Generator().manual_seed(1))
        before = [t.detach().clone() for t in gnn.trainable_leaves(state.params)]
        opt = tr.optimizer(state)
        _cuda.reset_launch_counts()
        loss = tr.train_step(state, opt, g, y, w)
        torch.cuda.synchronize()
        if path == "banded":
            assert (banded.build_band.launches, banded.band_occupancy.launches,
                    banded.mp_banded.launches) == (1, 1, 2)
        assert torch.isfinite(loss)
        losses[path] = float(loss)
        now = gnn.trainable_leaves(state.params)
        assert all(not torch.equal(a, b) for a, b in zip(before, now))
        after[path] = [t.detach() for t in now]
    assert losses["banded"] == pytest.approx(losses["gather"], rel=1e-5)
    for a, b in zip(after["banded"], after["gather"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert Trainer(cfg, TrainConfig(batch_size=4, pad_to=128)).use_banded  # "auto" on the card


# -- the attention family: B2 and B6 at one edge channel, the forward, the
# -- padding row, and the device k-NN

def _softmax_band_case(dev, n=700, k=16, f=256, seed=0):
    """A banded graph with padding slots (index 0, distance 0), the real
    slots' softmax weights of random logits as one edge channel, a node
    table and wv [F, F, 1] on the card."""
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.05, 0.2, (n, k)).astype(np.float32)
    pad = rng.uniform(size=(n, k)) < 0.2
    dists[pad], nlist[pad] = 0.0, 0
    logits = rng.normal(size=(n, k)).astype(np.float32)
    a = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    a_band = np.where(dists > 0, a, 0.0).astype(np.float32)[..., None]
    plan = banded.band_plan(nlist, dists)
    nodes = rng.normal(size=(plan.n_padded, f)).astype(np.float32)
    wv = (rng.normal(size=(f, f, 1)) / np.sqrt(f)).astype(np.float32)
    nl, d, ab, x, w = _on(dev, nlist, dists, a_band, nodes, wv)
    return nl, d, ab, x, w, banded.plan_on_device(plan, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_band_kernels_match_plain(dev, dtype):
    """B2 on the softmax weights (E = 1) equals its plain version bit for
    bit; B6 at E = 1, F = 256 against its plain version (the MP
    tolerances), given the occupancy from nlist and the distances."""
    nl, d, ab, x, w, plan = _softmax_band_case(dev)
    before = (banded.build_band.launches, banded.mp_banded_partial.launches)
    M = banded.build_band(nl, ab, plan, out_dtype=dtype)
    assert torch.equal(M, banded.build_band_plain(nl, ab, plan, out_dtype=dtype))
    assert M.shape[1] == 1
    occ = banded.band_occupancy(nl, d, plan.lo, plan.window, plan.block_rows, plan.n_padded)
    assert torch.equal(occ, banded.band_occupancy_from_band(M))
    table = x.to(dtype)
    got = banded.mp_banded_partial(M, plan.lo, table, w, occ)
    torch.cuda.synchronize()
    assert (banded.build_band.launches, banded.mp_banded_partial.launches) == (
        before[0] + 1, before[1] + 1)
    _mp_close(got, banded.mp_banded_partial_plain(M, plan.lo, table, w), dtype)


def _attention_model(dev, f=256, mp_layers=4, **kw):
    cfg = ModelConfig(atom_feature_size=f, mp_layers=mp_layers, mp_type="attention", **kw)
    return cfg, gnn.init_params(cfg, torch.Generator().manual_seed(0), device=dev)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_banded_attention_forward_on_the_card(dev, compute_dtype):
    """apply_banded_attention with the kernels: 4 B2, 4 B6 and 1 band
    occupancy launches a forward of 4 MP layers, equal to the plain
    versions (float32 2e-4; bfloat16 the fast band) and, in float32, to the
    gather forward; its gradients through the differentiable wrappers
    within 1e-6 of their max of the plain versions' (the last EdgeFC
    bias, which the softmax makes 0 but for rounding on a graph whose rows
    all have real slots, of the largest leaf's)."""
    from nmrgnn_tpu_torch.models.infer import apply_banded_attention

    cfg, params = _attention_model(dev, compute_dtype=compute_dtype, noise=0.0, dropout=False)
    nlist, dists, *_ = make_case(700, 16, 8, 1, seed=4, banded_nlist=True)
    nlist[dists == 0] = 0
    atoms = np.eye(10, dtype=np.float32)[np.random.default_rng(0).integers(0, 10, 700)]
    g = Graph(*_on(dev, atoms, nlist, dists, inv_degree_from_nlist(nlist)))
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    _cuda.reset_launch_counts()
    got = apply_banded_attention(params, cfg, g, plan)
    torch.cuda.synchronize()
    assert (banded.build_band.launches, banded.mp_banded_partial.launches,
            banded.band_occupancy.launches, banded.band_occupancy_from_band.launches) == (
        4, 4, 1, 0)
    plain = apply_banded_attention(params, cfg, g, plan, use_kernels=False)
    if compute_dtype == "float32":
        torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(got, gnn.apply(params, cfg, g), rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), rtol=0.05, atol=1.0)
        return
    leaves = gnn.trainable_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    grads = [torch.autograd.grad(apply_banded_attention(
        params, cfg, g, plan, differentiable=True, use_kernels=k).sum(), leaves)
        for k in (True, False)]
    top = max(float(b.abs().max()) for b in grads[1])
    blind = id(params["edge_fc"][-1]["bias"])
    for t, a, b in zip(leaves, *grads):
        scale = top if id(t) == blind else float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)


def test_attention_padding_row_served_on_the_card(dev):
    """A molecule of fewer than 17 atoms served with the RCM reorder: the
    padding slots name the old row 0's new place; "banded_attn" equals
    "gather" within 2e-4."""
    from nmrgnn_tpu_torch.data.neighbors import neighbors_host
    from nmrgnn_tpu_torch.data.organic import random_molecule

    cfg, params = _attention_model(dev)
    for seed in range(50):
        coords, elem = random_molecule(np.random.default_rng(seed))
        if coords.shape[0] < 17:
            break
    nlist, d = neighbors_host(coords, 16)
    g = Graph(np.eye(10, dtype=np.float32)[elem], nlist.astype(np.int32),
              (d * 0.1).astype(np.float32), inv_degree_from_nlist(nlist))
    model = ServingModel(params, cfg, device=dev)
    got = model.predict(g)
    assert model._resolved == "banded_attn" and model._order[0] != 0
    gather = ServingModel(params, cfg, device=dev)
    gather._resolved = "gather"
    np.testing.assert_allclose(got, gather.predict(g), rtol=2e-4, atol=2e-4)


def test_neighbors_device_on_the_card(dev):
    """neighbors_device on the card: the host's neighbor sets wherever the
    k-th and (k+1)-th distances differ by more than 0.05 A (the formula's
    float32 cancellation, about 1e-2 A at these magnitudes), distances
    within 0.02 A; fragment_device's members (the seed first) and
    neighbor lists in range."""
    from nmrgnn_tpu_torch.data.device_graph import fragment_device
    from nmrgnn_tpu_torch.data.neighbors import neighbors_device, neighbors_host

    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 40, (3000, 3)).astype(np.float32)
    k = 16
    nl, d = neighbors_device(torch.from_numpy(coords).to(dev), k)
    nl, d = nl.cpu().numpy(), d.cpu().numpy()
    hi, hd = neighbors_host(coords, k + 1)
    clear = hd[:, k] - hd[:, k - 1] > 0.05
    assert clear.mean() > 0.5
    for i in np.flatnonzero(clear):
        assert set(nl[i]) == set(hi[i, :k])
    np.testing.assert_allclose(np.sort(d, 1), np.sort(hd[:, :k], 1), rtol=0, atol=0.02)
    members, nbr, dist, weight = fragment_device(torch.from_numpy(coords).to(dev),
                                                 torch.arange(0, 3000, 500, device=dev), 256, k)
    assert members.shape == (6, 256) and nbr.shape == (6, 256, k)
    assert int(nbr.max()) < 256 and bool((dist > 0).all())
    assert torch.equal(members[:, 0].long().cpu(), torch.arange(0, 3000, 500))


# -- widths the kernels are not instantiated for: node tables padded to 64,
# -- 128, 256 or 512 columns, edge channels in groups, EdgeFC widths padded
# -- to 128 or 256, K that does not divide the fused build's slots


@pytest.mark.parametrize("f,e,dtype", [
    (96, 8, torch.float32), (32, 64, torch.bfloat16), (320, 3, torch.float32),
    (512, 5, torch.bfloat16), (256, 8, torch.bfloat16),
])
def test_mp_kernels_at_other_widths_match_plain(dev, f, e, dtype):
    """mp_banded, mp_banded_partial and mp_banded_hbm_cls with the node
    table padded (96, 32, 320) and the channels in groups (4 a launch, 2 at
    F = 512), one count a call, against their plain versions."""
    nlist, dists, nl, ef, plan, M, x, wt, iv = _mp_case(dev, f, e, dtype, n=400, seed=f + e)
    occ = banded.band_occupancy(nl, _on(dev, dists)[0], plan.lo, plan.window,
                                plan.block_rows, plan.n_padded)
    before = (banded.mp_banded.launches, banded.mp_banded_partial.launches)
    got = banded.mp_banded(M, plan, x, wt, iv, "softplus", occ)
    part = banded.mp_banded_partial(M, plan.lo, x, wt, occ)
    torch.cuda.synchronize()
    assert (banded.mp_banded.launches, banded.mp_banded_partial.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == x.shape and got.dtype == dtype and part.shape == x.shape
    _mp_close(got, banded.mp_banded_plain(M, plan, x, wt, iv), dtype)
    _mp_close(part, banded.mp_banded_partial_plain(M, plan.lo, x, wt), dtype)
    c = banded.plan_on_device(banded.band_plan_classes(nlist, dists), dev).classes[-1]
    Mc = M[c.ids.long()].contiguous()
    cls = c._replace(window=plan.window, lo=plan.lo[c.ids.long()].contiguous())
    _mp_close(banded.mp_banded_hbm_cls(Mc, cls, plan.block_rows, x, wt, iv),
              banded.mp_banded_hbm_cls_plain(Mc, cls, plan.block_rows, x, wt, iv), dtype)


@pytest.mark.parametrize("e", [5, 8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_builds_in_channel_groups_equal_plain(dev, e, dtype):
    """B2, B4, B7a, B7b and B8 with E past one launch's 4 channels: each
    group's channels of one M, equal to the plain versions bit for bit."""
    nlist, dists, efeat = _build_inputs(700, 16, e, seed=e, block_rows=128)
    cheb = make_cheb(e, degree=64, seed=e)
    for name, got, want in _every_build(dev, nlist, dists, efeat, cheb, 128, dtype):
        assert got.shape == want.shape and torch.equal(got, want), name


@pytest.mark.parametrize("f,e,dtype", [(96, 8, torch.float32), (32, 5, torch.bfloat16),
                                       (320, 3, torch.float32)])
def test_blocksparse_at_other_widths_matches_plain(dev, f, e, dtype):
    """B10 in channel groups (bit for bit) and B11/B12 with the node table
    padded and the channels in groups, against their plain versions."""
    from nmrgnn_tpu_torch.ops import blocksparse

    s, sd, nl, ef, x, wt, iv = _block_case(dev, 300, 7, f, e, 5, True, 1)
    A = blocksparse.build_block_adjacency(nl, ef, sd, out_dtype=dtype)
    assert torch.equal(A, blocksparse.build_block_adjacency_plain(nl, ef, sd, dtype))
    x = x.to(dtype)
    got = blocksparse.mp_blocksparse(A, sd, x, wt, iv)
    assert got.shape == x.shape and got.dtype == dtype
    _mp_close(got, blocksparse.mp_blocksparse_plain(A, sd, x, wt, iv), dtype)


@pytest.mark.parametrize("h,k,e,compute_dtype", [
    (16, 16, 3, torch.float32), (64, 12, 8, torch.float32), (200, 16, 3, torch.bfloat16),
    (256, 16, 2, torch.float32), (256, 12, 5, torch.bfloat16), (128, 12, 3, torch.bfloat16),
])
def test_fused_kernel_at_other_widths_matches_plain(dev, h, k, e, compute_dtype):
    """B3 with H padded to 128 or 256 (zero weights), K = 12 (the block's
    last slots masked) and E in channel groups, on a graph with padded
    rows, against its plain version (tolerances of
    test_fused_kernel_every_shape)."""
    nlist, dists, *_ = make_case(400, k, 8, e, seed=h + k, banded_nlist=True)
    cfg = ModelConfig(edge_feature_size=e, edge_hidden_size=h, edge_fc_layers=3)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(h), device=dev)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, d = _on(dev, nlist, dists)
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation,
              out_dtype=compute_dtype, compute_dtype=compute_dtype)
    before = banded.build_band_fused.launches
    got = banded.build_band_fused(nl, d, params["edge_fc"], plan, **kw)
    want = banded.build_band_fused_plain(nl, d, params["edge_fc"], plan, **kw)
    assert banded.build_band_fused.launches == before + 1
    if compute_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                   atol=BF16_STEP * float(want.float().abs().max()))


@pytest.mark.parametrize("f,e,h,k", [(96, 8, 64, 16), (32, 64, 256, 16), (256, 8, 128, 12)])
def test_serving_and_training_at_other_widths(dev, f, e, h, k):
    """ServingModel ("banded", exact and fast) and one banded Trainer step
    of a config at the widths the hyperparameter search samples: kernels
    launched, peaks against the plain gather forward (exact 5e-4; fast
    within the fast band, rtol 0.05 and 1 ppm); "auto" training takes the
    banded step where the JAX package's rule does (F a multiple of 128),
    with the loss equal to the gather path's (rel 1e-5)."""
    from nmrgnn_tpu_torch.config import TrainConfig
    from nmrgnn_tpu_torch.train.trainer import Trainer, banded_fragments_eligible

    cfg = ModelConfig(atom_feature_size=f, edge_feature_size=e, edge_hidden_size=h,
                      neighbor_number=k, noise=0.0, dropout=False)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(f + e), device=dev)
    n = 600
    rng = np.random.default_rng(e)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-50, 50, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.09, 0.3, (n, k)).astype(np.float32)
    g = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    ref = gnn.apply(params, cfg, Graph(*_on(dev, *g))).cpu()
    for precision in ("exact", "fast"):
        sm = ServingModel(params, cfg, mode="banded", precision=precision, device="cuda")
        _cuda.reset_launch_counts()
        peaks = torch.as_tensor(sm.predict(g))
        torch.cuda.synchronize()
        assert banded.mp_banded.launches + banded.mp_banded_partial.launches >= cfg.mp_layers
        if precision == "exact":
            torch.testing.assert_close(peaks, ref, rtol=5e-4, atol=5e-4)
        else:
            torch.testing.assert_close(peaks, ref, rtol=0.05, atol=1.0)
    gb = _fragment_batch(dev, k=k)
    y = torch.zeros(gb.nlist.shape[:2] + (3,), device=dev)
    y[..., 0] = torch.rand(gb.nlist.shape[:2], device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2)) * 10
    y[..., 1] = 1.0
    y[:, :64, 2] = 1.0
    wts = torch.ones(gb.nlist.shape[:2], device=dev)
    shape_ok, fits = banded_fragments_eligible(cfg, 4, 128)
    eligible = shape_ok and fits  # F a multiple of 128, as in the JAX package
    assert Trainer(cfg, TrainConfig(batch_size=4, pad_to=128)).use_banded == eligible
    losses = {"banded": None}
    for path in ("banded", "gather") if eligible else ("gather",):
        tr = Trainer(cfg, TrainConfig(batch_size=4, pad_to=128, mp_path=path))
        state = tr.init_state(torch.Generator().manual_seed(1))
        _cuda.reset_launch_counts()
        losses[path] = float(tr.train_step(state, tr.optimizer(state), gb, y, wts))
        if path == "banded":
            assert (banded.build_band.launches, banded.mp_banded.launches) == (1, cfg.mp_layers)
    assert np.isfinite(losses["gather"])
    if eligible:
        assert losses["banded"] == pytest.approx(losses["gather"], rel=1e-5)


# -- the widths of fault C6 (past the kernels' widths before its repair):
# -- F > 512 through the F-split, an EdgeFC wider than 256, K > 128


class _KernelsOnly:
    """Within it, every ``*_plain`` function of ``ops/banded.py`` and
    ``ops/blocksparse.py`` raises: a kernel wrapper that took its plain
    version would fail the test."""

    def __enter__(self):
        from nmrgnn_tpu_torch.ops import blocksparse

        self.saved = []
        for mod in (banded, blocksparse):
            for name in dir(mod):
                if name.endswith("_plain") and callable(getattr(mod, name)):
                    self.saved.append((mod, name, getattr(mod, name)))
                    setattr(mod, name, self._refuse(name))
        return self

    @staticmethod
    def _refuse(name):
        def refuse(*args, **kwargs):
            raise AssertionError(f"{name} called on the card")
        return refuse

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


@pytest.mark.parametrize("e,dtype", [(1, torch.float32), (3, torch.float32),
                                     (1, torch.bfloat16), (3, torch.bfloat16)])
def test_mp_kernels_at_f768_match_plain(dev, e, dtype):
    """B1/B5 (mp_banded), B6, B9, B13 and B11 at F = 768 (three column
    blocks of 256, each output block chaining every input block and
    channel group through acc_in): kernels only, one count a call, against
    their plain versions."""
    from nmrgnn_tpu_torch.ops import blocksparse

    f = 768
    nlist, dists, nl, ef, plan, M, x, wt, iv = _mp_case(dev, f, e, dtype, n=400, seed=e)
    d = _on(dev, dists)[0]
    c = banded.plan_on_device(banded.band_plan_classes(nlist, dists), dev).classes[-1]
    Mc = M[c.ids.long()].contiguous()
    cls = c._replace(window=plan.window, lo=plan.lo[c.ids.long()].contiguous())
    cheb = make_cheb(e, degree=64, seed=e)
    dc = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    s, sd, bnl, bef, bx, bwt, biv = _block_case(dev, 300, 7, f, e, 5, True, 1)
    for fn in _cuda.KERNEL_WRAPPERS:
        fn.launches = 0
    with _KernelsOnly():
        occ = banded.band_occupancy(nl, d, plan.lo, plan.window, plan.block_rows,
                                    plan.n_padded)
        got = banded.mp_banded(M, plan, x, wt, iv, "softplus", occ)
        part = banded.mp_banded_partial(M, plan.lo, x, wt, occ)
        got_cls = banded.mp_banded_hbm_cls(Mc, cls, plan.block_rows, x, wt, iv)
        Mf, got_ff = banded.mp_banded_poly_fused(nl, d, dc, plan, x, wt, iv, out_dtype=dtype)
        A = blocksparse.build_block_adjacency(bnl, bef, sd, out_dtype=dtype)
        got_bs = blocksparse.mp_blocksparse(A, sd, bx.to(dtype), bwt, biv)
        torch.cuda.synchronize()
    assert (banded.mp_banded.launches, banded.mp_banded_partial.launches,
            banded.mp_banded_hbm_cls.launches, banded.mp_banded_poly_fused.launches,
            blocksparse.mp_blocksparse.launches) == (1, 1, 1, 1, 1)
    assert got.shape == x.shape and got.dtype == dtype and part.shape == x.shape
    _mp_close(got, banded.mp_banded_plain(M, plan, x, wt, iv), dtype)
    _mp_close(part, banded.mp_banded_partial_plain(M, plan.lo, x, wt), dtype)
    _mp_close(got_cls, banded.mp_banded_hbm_cls_plain(Mc, cls, plan.block_rows, x, wt, iv),
              dtype)
    Mw, want_ff = banded.mp_banded_poly_fused_plain(nl, d, cheb, plan, x, wt, iv,
                                                    out_dtype=dtype)
    assert torch.equal(Mf, Mw)
    _mp_close(got_ff, want_ff, dtype)
    _mp_close(got_bs, blocksparse.mp_blocksparse_plain(A, sd, bx.to(dtype), bwt, biv), dtype)


@pytest.mark.parametrize("h,k,e,compute_dtype", [
    (512, 16, 3, torch.float32), (512, 16, 3, torch.bfloat16), (400, 12, 5, torch.bfloat16),
    (128, 160, 3, torch.float32), (128, 160, 3, torch.bfloat16), (256, 160, 2, torch.bfloat16),
    (1024, 16, 1, torch.float32), (2048, 16, 2, torch.bfloat16),
])
def test_fused_kernel_at_c6_widths_matches_plain(dev, h, k, e, compute_dtype):
    """B3 at an EdgeFC 512, 1,024 and 2,048 wide (the hidden kernel
    streamed through the ring; bfloat16 operands on the CUDA cores) and
    at K = 160 (one atom a block, its slots through the EdgeFC in several
    passes): kernels only, against its plain version (the tolerances of
    test_fused_kernel_every_shape)."""
    nlist, dists, *_ = make_case(300, k, 8, e, seed=h + k, banded_nlist=True)
    cfg = ModelConfig(edge_feature_size=e, edge_hidden_size=h, edge_fc_layers=3)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(h), device=dev)
    plan = banded.plan_on_device(banded.band_plan(nlist, dists), dev)
    nl, d = _on(dev, nlist, dists)
    kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation,
              out_dtype=compute_dtype, compute_dtype=compute_dtype)
    _cuda.reset_launch_counts()
    with _KernelsOnly():
        got = banded.build_band_fused(nl, d, params["edge_fc"], plan, **kw)
        torch.cuda.synchronize()
    assert banded.build_band_fused.launches == 1
    want = banded.build_band_fused_plain(nl, d, params["edge_fc"], plan, **kw)
    if compute_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP,
                                   atol=BF16_STEP * float(want.float().abs().max()))


@pytest.mark.parametrize("e,k", [(3, 160), (1, 700), (4, 3000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_builds_past_128_slots_equal_plain(dev, e, k, dtype):
    """B2, B4, B7a, B7b and B8 at K = 160, 700 and 3,000 (fewer rows a
    block as K grows; one row a block past 48 KB of staged slots): equal
    to their plain versions bit for bit."""
    nlist, dists, efeat = _build_inputs(300, k, e, seed=e + k, block_rows=128)
    cheb = make_cheb(e, degree=64, seed=k)
    for name, got, want in _every_build(dev, nlist, dists, efeat, cheb, 128, dtype):
        assert got.shape == want.shape and torch.equal(got, want), name


# -- atom-partitioned serving: ranks sharing the card under gloo ---------------------


def test_partitioned_banded_on_two_ranks_kernels_match_plain(dev, tmp_path):
    """apply_partitioned_banded on 2 gloo ranks sharing the card (exact,
    fast and attention): B7a, B7b and B6 launched (2 builds + 2 B6 a layer
    bilinear; 2 B7a + 2 B6 a layer attention), the peaks against the same
    ranks' plain versions (exact and attention 2e-4; fast at bfloat16's
    band, rtol 0.05 and 1 ppm), every rank the whole peaks."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_parallel_worker as worker

    cfg = dict(atom_feature_size=64, edge_hidden_size=32, mp_layers=2, dropout=False,
               noise=0.0)
    acfg = dict(cfg, mp_type="attention")
    params = {}
    for name, kw in (("bilinear", cfg), ("attention", acfg)):
        p = gnn.init_params(ModelConfig(**kw), torch.Generator().manual_seed(3), device="cpu")
        params[name] = gnn.tree_map(lambda t: t.numpy(), p)
    n = 1500
    rng = np.random.default_rng(0)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-50, 50, (n, 16)), 0, n - 1)
    dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
    dists[rng.uniform(size=(n, 16)) < 0.1] = 0.0
    nlist = np.where(dists > 0, nlist, 0).astype(np.int32)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    g = (atoms, nlist, dists, inv_degree_from_nlist(nlist))
    cheb = make_cheb(3, degree=64, seed=1)
    fast = (cheb.coeffs, cheb.d_lo, cheb.d_hi)
    tasks = []
    for use_kernels in (True, False):
        tasks += [dict(kind="banded", model="bilinear", graph="g", use_kernels=use_kernels),
                  dict(kind="banded", model="bilinear", graph="g", cheb=fast,
                       use_kernels=use_kernels),
                  dict(kind="banded", model="attention", graph="g", use_kernels=use_kernels)]
    case = dict(configs={"bilinear": cfg, "attention": acfg}, params=params,
                graphs={"g": g}, tasks=tasks, device="cuda", timeout_s=120)
    out = worker.spawn(2, case, tmp_path, timeout_s=300)[1]()
    for r in out[1:]:
        for a, b in zip(r, out[0]):
            np.testing.assert_array_equal(a["peaks"], b["peaks"])
    got, plain = out[0][:3], out[0][3:]
    for k in (0, 2):
        np.testing.assert_allclose(got[k]["peaks"], plain[k]["peaks"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1]["peaks"], plain[1]["peaks"], rtol=0.05, atol=1.0)
    for rank in out:
        c = [t["counts"] for t in rank[:3]]
        assert (c[0]["build_band_tracedlo"], c[0]["mp_banded_partial"]) == (2, 4)
        assert (c[1]["build_band_poly_tracedlo"], c[1]["mp_banded_partial"]) == (2, 4)
        assert (c[2]["build_band_tracedlo"], c[2]["mp_banded_partial"]) == (4, 4)
        assert all(t["counts"]["mp_banded_partial"] == 0 for t in rank[3:])


# -- partitioned training: ranks sharing the card under gloo ---------------------------


def test_partitioned_training_on_two_ranks_kernels_match_plain(dev, tmp_path):
    """The gradients of apply_partitioned_banded(differentiable=True) on 2
    gloo ranks sharing the card (bilinear and attention), summed over the
    ranks, through B7a and B6's autograd wrappers (2 builds + 2 B6 a layer
    bilinear, 2 B7a + 2 B6 a layer attention) against the same ranks'
    plain versions under autograd: each leaf within 1e-3 of its largest
    gradient (phase 9's gate); one partitioned step's loss and weights too."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_parallel_worker as worker

    cfg = dict(atom_feature_size=64, edge_hidden_size=32, mp_layers=2, dropout=False,
               noise=0.0)
    acfg = dict(cfg, mp_type="attention")
    params = {}
    for name, kw in (("bilinear", cfg), ("attention", acfg)):
        p = gnn.init_params(ModelConfig(**kw), torch.Generator().manual_seed(3), device="cpu")
        params[name] = gnn.tree_map(lambda t: t.numpy(), p)
    n = 1536
    rng = np.random.default_rng(0)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-50, 50, (n, 16)), 0, n - 1)
    dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
    dists[rng.uniform(size=(n, 16)) < 0.1] = 0.0
    nlist = np.where(dists > 0, nlist, 0).astype(np.int32)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    y = np.stack([rng.normal(size=n).astype(np.float32) * 3,
                  rng.integers(0, 6, n).astype(np.float32), np.ones(n, np.float32)], -1)
    tasks = []
    for use_kernels in (True, False):
        tasks += [dict(kind="grad", model="bilinear", graph=2, graph_name="g",
                       use_kernels=use_kernels),
                  dict(kind="grad", model="attention", graph=2, graph_name="g",
                       use_kernels=use_kernels),
                  dict(kind="step", model="bilinear", graph=2, frames=["g"], lr=1e-3,
                       use_kernels=use_kernels)]
    case = dict(configs={"bilinear": cfg, "attention": acfg}, params=params,
                graphs={"g": (atoms, nlist, dists, inv_degree_from_nlist(nlist))},
                y={"g": y}, w={"g": np.ones(n, np.float32)},
                target=np.sin(np.arange(n, dtype=np.float32) * 0.1),
                loss_idx=tuple(range(1, 7)), tasks=tasks, device="cuda", timeout_s=120)
    out = worker.spawn(2, case, tmp_path, timeout_s=300)[1]()
    got, plain = out[0][:3], out[0][3:]
    for k in (0, 1):
        a, b = gnn.tree_leaves(got[k]["grads"]), gnn.tree_leaves(plain[k]["grads"])
        assert len(a) == len(b) >= 10
        for x, z in zip(a, b):
            assert np.all(np.isfinite(x))
            assert np.abs(x - z).max() <= 1e-3 * np.abs(z).max(), (k, x.shape)
    np.testing.assert_allclose(got[2]["loss"], plain[2]["loss"], rtol=1e-5)
    for x, z in zip(gnn.tree_leaves(got[2]["params"]), gnn.tree_leaves(plain[2]["params"])):
        np.testing.assert_allclose(x, z, rtol=2e-3, atol=2e-5)
    for rank in out:
        c = [t["counts"] for t in rank[:2]]
        assert (c[0]["build_band_tracedlo"], c[0]["mp_banded_partial"]) == (2, 4)
        assert (c[1]["build_band_tracedlo"], c[1]["mp_banded_partial"]) == (4, 4)
        assert all(t["counts"]["mp_banded_partial"] == 0 for t in rank[3:5])


def _prepare_case(n, seed):
    """A banded graph of ``n`` atoms (K = 16, 10 elements) with padding
    slots, a row of index-0 neighbors, a run of rows without a real
    neighbor (an empty tile), negative indices, and its RCM order."""
    from nmrgnn_tpu_torch.data.reorder import rcm_order

    rng = np.random.default_rng(seed)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-60, 60, (n, 16)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
    dists[rng.uniform(size=(n, 16)) < 0.1] = 0.0
    nlist[7, :] = 0
    dists[n // 2:n // 2 + 200] = 0.0
    order = rcm_order(nlist, dists)
    nlist[::11, 3] = -1 - rng.integers(0, n, len(nlist[::11]))  # counted from the end
    g = Graph(atoms, nlist, dists, inv_degree_from_nlist(np.maximum(nlist, 0)))
    inverse = np.empty(n, np.int64)
    inverse[order] = np.arange(n)
    return g, order, inverse


@pytest.mark.parametrize("n", [2482, 44676])
def test_permute_tile_bounds_kernel_equals_plain(dev, n):
    """The preparation kernel equals its plain version bit for bit at the
    served structures' sizes, with the permutation and without, at half a
    tile and a whole one; wrong inputs raise."""
    g, order, inverse = _prepare_case(n, seed=n)
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
    host = [torch.from_numpy(np.ascontiguousarray(a)).to(dt) for a, dt in zip(g, dtypes)]
    card = [t.to(dev) for t in host]
    perm = [torch.as_tensor(a.astype(np.int32)) for a in (order, inverse)]
    for rows in (64, 128):
        for o, i in (perm, (None, None)):
            before = banded.permute_tile_bounds.launches
            got = banded.permute_tile_bounds(*card, *(None if o is None else o.to(dev),
                                                      None if i is None else i.to(dev)), rows)
            assert banded.permute_tile_bounds.launches == before + 1
            want = banded.permute_tile_bounds_plain(*host, o, i, rows)
            assert got[-1].shape == (-(-n // rows), 2)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    with pytest.raises(TypeError):
        banded.permute_tile_bounds(card[0], card[1].long(), *card[2:], None, None, 64)
    with pytest.raises(ValueError):
        banded.permute_tile_bounds(*card[:3], card[3][:-1], None, None, 64)


def test_serving_prepared_on_the_card_equals_host_permuted(dev):
    """Served on the card, prepared there: bit-equal peaks and equal plans
    to the same model served without the reorder on frames permuted on the
    host, over frames with plan hits and misses; a trajectory's frames too."""
    from nmrgnn_tpu_torch.data.reorder import permute_graph

    cfg = ModelConfig()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(2), device=dev)
    n, rng = 2482, np.random.default_rng(5)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-50, 50, (n, 16)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.09, 0.3, (n, 16)).astype(np.float32)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([2, 3, 4, 5], n)]
    f0 = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    wide = nlist.copy()
    wide[::97, 0] = np.clip(np.arange(0, n, 97) + 400, 0, n - 1)
    frames = [f0, f0._replace(edges=dists * 1.01), f0._replace(nlist=wide), f0]
    for precision in ("exact", "fast"):
        sm = ServingModel(params, cfg, device=dev, precision=precision)
        host = ServingModel(params, cfg, device=dev, precision=precision, reorder=False)
        plans = []
        for f in frames:
            got = sm.predict(f)
            fp, inverse = permute_graph(f, sm._order, pin_zero=False)
            assert np.array_equal(got, host.predict(fp)[inverse])
            np.testing.assert_array_equal(sm._plan.lo, host._plan.lo)
            assert sm._plan.window == host._plan.window
            plans.append(sm._plan)
        assert len({id(p) for p in plans}) > 1
        # in flight together: each frame's plan copies leave the last ones be
        launched = [sm._predict_async(f) for f in frames]
        want = [host._predict_async(permute_graph(f, sm._order, pin_zero=False)[0])
                for f in frames]
        for got, (peaks, _) in zip(launched, want):
            assert np.array_equal(sm._finalize(*got), sm._finalize(peaks, sm._inverse))


def _painn_message_case(n, k, f, seed, dev, blocks=3, blk=1):
    """PaiNN message inputs on the card: w the column slice of block ``blk``
    of a [n, k, 3 blocks f] filter (taken in place), 25% padding slots and
    two rows all padding (filter exactly 0 there, as the filter makes it),
    real slots past the cutoff with a zero filter, indices counted from
    the end (-1), and v = 0 on seed 0 (the first block)."""
    rng = np.random.default_rng(seed)
    nlist = rng.integers(0, n, (n, k)).astype(np.int32)
    nlist[::7, 0] = -1
    edges = rng.uniform(0.1, 0.6, (n, k)).astype(np.float32)
    edges[rng.uniform(size=(n, k)) < 0.25] = 0.0
    edges[[3, n - 2]] = 0.0
    filt = rng.normal(size=(n, k, 3 * blocks * f)).astype(np.float32)
    filt[(edges == 0) | (edges >= 0.5)] = 0.0
    unit = rng.normal(size=(n, k, 3)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    s = rng.normal(size=(n, f)).astype(np.float32)
    v = np.zeros((n, 3, f), np.float32) if seed == 0 else rng.normal(size=(n, 3, f)).astype(
        np.float32)
    nl, ed, filt_t, un, st, vt = _on(dev, nlist, edges, filt, unit, s, v)
    gen = torch.Generator().manual_seed(seed)
    p = {"context": [{"kernel": torch.randn(f, f, generator=gen) / f ** 0.5,
                      "bias": torch.randn(f, generator=gen) * 0.1},
                     {"kernel": torch.randn(f, 3 * f, generator=gen) / f ** 0.5,
                      "bias": torch.randn(3 * f, generator=gen) * 0.1}]}
    p = gnn.tree_map(lambda t: t.to(dev), p)
    return p, st, vt, filt_t[..., 3 * f * blk:3 * f * (blk + 1)], un, nl, ed


@pytest.mark.parametrize("f", [32, 128])
@pytest.mark.parametrize("k", [24, 80])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_painn_message_kernel_matches_plain(dev, f, k, seed):
    """The message kernel against its plain version. Tolerance: float32 sums
    of the 2K + 1 terms of an output in another order, with the products
    fused into the sums on the card: each side lies within (2K + 2) 2^-24
    of the sum of the terms' magnitudes (the plain version computed on
    their magnitudes), so the two within twice that. Rows all padding give
    s and v back bit for bit; no [N, K, 3F] tensor is allocated."""
    from nmrgnn_tpu_torch.ops import painn

    n = 300
    p, s, v, w, unit, nlist, edges = _painn_message_case(n, k, f, seed, dev)
    act = torch.nn.functional.silu
    ctx = painn.context(p, s, act, gnn.dense)
    want = painn.message_sums_plain(s, v, ctx, w, unit, nlist)
    mags = painn.message_sums_plain(s.abs(), v.abs(), ctx.abs(), w.abs(), unit.abs(), nlist)
    torch.cuda.synchronize()
    before, base = painn.message.launches, torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = painn.message(p, s, v, w, unit, nlist, edges, act, gnn.dense)
    torch.cuda.synchronize()
    assert painn.message.launches == before + 1
    assert torch.cuda.max_memory_allocated() - base < w.numel() * 4 // 8
    for g, wt, m in zip(got, want, mags):
        assert torch.all((g - wt).abs() <= 2 * (2 * k + 2) * 2.0 ** -24 * m)
    for row in (3, n - 2):
        assert torch.equal(got[0][row], s[row]) and torch.equal(got[1][row], v[row])
    assert got[0].shape == s.shape and got[1].shape == v.shape


def test_painn_message_kernel_refuses_what_it_does_not_take(dev):
    """On the card ``message`` launches the kernel or raises: no fallback."""
    from nmrgnn_tpu_torch.ops import painn

    act = torch.nn.functional.silu
    p, s, v, w, unit, nlist, edges = _painn_message_case(64, 24, 32, 1, dev)
    args = dict(s=s, v=v, w=w, unit=unit, nlist=nlist, edges=edges)
    before = painn.message.launches
    for key, bad, error in (("nlist", nlist.long(), TypeError),
                            ("w", w.to(torch.bfloat16), TypeError),
                            ("w", torch.randn(64, 96, 24, device=dev).transpose(1, 2),
                             ValueError),
                            ("edges", edges.cpu(), ValueError),
                            ("v", v.transpose(1, 2).contiguous().transpose(1, 2), ValueError)):
        a = dict(args, **{key: bad})
        with pytest.raises(error):
            painn.message(p, a["s"], a["v"], a["w"], a["unit"], a["nlist"], a["edges"], act,
                          gnn.dense)
    p48, s48, v48, w48, u48, n48, e48 = _painn_message_case(64, 24, 48, 1, dev)
    with pytest.raises(ValueError):
        painn.message(p48, s48, v48, w48, u48, n48, e48, act, gnn.dense)
    assert painn.message.launches == before


# -- the attention layer on "gather": one kernel a layer (csrc/attention.cu) --------


def _amp_case(dev, n, k, f, e, seed):
    """An attention layer's operands on the card: 25% padding slots (edge
    features 0, as the edge stage's mask leaves them) that name real rows,
    a row all padding, indices counted from the end (-1), logits of a few
    units."""
    rng = np.random.default_rng(seed)
    nlist = rng.integers(0, n, (n, k)).astype(np.int32)
    nlist[::7, 0] = -1
    edges = rng.normal(size=(n, k, e)).astype(np.float32)
    pad = rng.uniform(size=(n, k)) < 0.25
    pad[3] = True
    edges[pad] = 0.0
    nodes = rng.normal(size=(n, f)).astype(np.float32)
    wq = (rng.normal(size=(f, e)) / np.sqrt(f)).astype(np.float32)
    wk = rng.normal(size=(e, e)).astype(np.float32)
    wv = (rng.normal(size=(f, f)) / np.sqrt(f)).astype(np.float32)
    inv = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return _on(dev, wq, wk, wv, nodes, nlist, edges, inv)


def _amp_bound(wq, wk, wv, nodes, nlist, edges, inv, want):
    """Twice a float32 bound of either side's error: the values' F-term
    and the weighted sum's K-term sums (F + K + 8 units of 2^-24 of the
    sum of |a| |x| |wv|), each weight's relative error from its logit's
    two E-term sums and the max (4 (E + 2) units of the logits' largest
    magnitude, plus the softmax's K-term sum), then the activation (slope
    at most 1) and the residual (a few units of the output)."""
    d = torch.float64
    x, nl, iv = nodes.to(d), nlist.long(), inv.to(d)
    F, (n, K, E) = x.shape[1], edges.shape
    q = x @ wq.to(d)
    a = torch.softmax(iv[:, None] * torch.einsum("ijk,kl,il->ij", edges.to(d), wk.to(d), q), -1)
    m1 = torch.einsum("ij,ijm->im", a, (x.abs() @ wv.to(d).abs())[nl])
    lmag = iv.abs()[:, None] * torch.einsum("ijk,kl,il->ij", edges.to(d).abs(), wk.to(d).abs(),
                                            x.abs() @ wq.to(d).abs())
    coef = F + 2 * K + 16 + 4 * (E + 2) * lmag.max(1).values[:, None]
    return 2 * 2.0 ** -24 * (coef * m1 + 4 * x.abs() + 4 * want.to(d).abs())


def _amp_check(dev, ops, act):
    from nmrgnn_tpu_torch.ops import attention

    n, k = ops[4].shape
    f = ops[3].shape[1]
    want = attention.amp_plain(*ops, act)
    torch.cuda.synchronize()
    before, base = attention.amp.launches, torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = attention.amp(*ops, act)
    torch.cuda.synchronize()
    assert attention.amp.launches == before + 1
    assert torch.cuda.max_memory_allocated() - base < n * k * f * 4 // 2
    assert got.shape == want.shape and torch.all(torch.isfinite(got))
    bound = _amp_bound(*ops, want)
    assert torch.all((got - want).abs().to(torch.float64) <= bound), \
        float(((got - want).abs() / bound).max())
    assert torch.equal(attention.amp(*ops, act), got)  # no atomics: the same bits again


@pytest.mark.parametrize("n,k,f,e,seed", [
    (700, 16, 256, 3, 0),  # the amp cell's widths
    (300, 40, 256, 3, 1),  # K past 32: two chunks of slots
    (300, 16, 100, 3, 2),  # F padded to 128
    (300, 24, 192, 4, 3),  # 6 channels a lane, 8-byte loads
    (300, 16, 96, 1, 4),   # 3 channels a lane, 4-byte loads
    (300, 33, 512, 8, 5),  # F past 256: two channel groups
])
def test_amp_kernel_matches_plain(dev, n, k, f, e, seed):
    """The attention kernel (with its projection and residual) against
    ``amp_plain`` elementwise within float32 rounding (``_amp_bound``),
    padding slots and negative indices included; one count a call, no
    [N, K, F] tensor allocated, the same bits on a second call."""
    _amp_check(dev, _amp_case(dev, n, k, f, e, seed), "softplus")


@pytest.mark.parametrize("act", ["linear", "relu", "softplus", "tanh"])
def test_amp_kernel_every_activation_matches_plain(dev, act):
    _amp_check(dev, _amp_case(dev, 300, 16, 64, 3, 10), act)


def test_amp_kernel_on_a_flattened_batch(dev):
    """A flattened ``apply_batched`` graph: each fragment's padding slots
    name its row 0, moved by b N."""
    g = gnn.flatten_batch(_fragment_batch(dev, b=4, n=128, k=16, seed=3))
    n, k = g.nlist.shape
    wq, wk, wv, nodes, _, edges, _ = _amp_case(dev, n, k, 256, 3, 11)
    assert int(g.nlist.max()) >= 3 * 128 and int((g.edges == 0).sum()) > 0
    edges = edges * (g.edges > 0)[..., None]
    _amp_check(dev, (wq, wk, wv, nodes, g.nlist, edges, g.inv_degree), "softplus")


def _parent_attention_apply(params, cfg, g):
    """The attention forward as ``gnn.apply`` computes it where autograd
    records: ``amp_layer`` plus the residual, a layer at a time."""
    from nmrgnn_tpu_torch.ops.activations import get_activation
    from nmrgnn_tpu_torch.ops.message_passing import amp_layer

    atoms, nlist, edges, inv = g
    e = gnn.edge_features(params, cfg, edges, mask=(edges > 0).to(torch.float32)[..., None])
    nodes = gnn.dense(params["embed"], atoms)
    act = get_activation(cfg.mp_activation)
    for p in params["mp"]:
        nodes = amp_layer(p["wq"], p["wk"], p["wv"], nodes, nlist, e, inv, act) + nodes
    return gnn.readout(params, cfg, atoms, nodes)


def test_attention_gather_forward_on_the_card(dev):
    """An attention ServingModel.predict on "gather" launches the kernel 4
    times (one a layer), as gnn.apply and apply_batched do under no grad,
    and equals the plain forward within float32 rounding (1e-5 of the
    largest peak); a forward while autograd records launches it 0 times,
    equals the plain layers bit for bit, and its gradients equal theirs
    within 1e-5 of each leaf's largest (the gather's backward sums by
    atomics)."""
    from nmrgnn_tpu_torch.ops import attention

    cfg, params = _attention_model(dev, noise=0.0, dropout=False)
    nlist, dists, *_ = make_case(700, 16, 8, 1, seed=6, banded_nlist=True)
    atoms = np.eye(10, dtype=np.float32)[np.random.default_rng(6).integers(0, 10, 700)]
    g_np = Graph(atoms, nlist, dists, inv_degree_from_nlist(nlist))
    g = Graph(*_on(dev, *g_np))
    with torch.no_grad():
        plain = _parent_attention_apply(params, cfg, g)
    _cuda.reset_launch_counts()
    model = ServingModel(params, cfg, device=dev)
    model._resolved = "gather"
    served = model.predict(g_np)
    assert attention.amp.launches == 4
    scale = 1e-5 * float(plain.abs().max())
    np.testing.assert_allclose(served, plain.cpu().numpy(), rtol=0, atol=scale)
    with torch.no_grad():
        torch.testing.assert_close(gnn.apply(params, cfg, g), plain, rtol=0, atol=scale)
        gb = Graph(*[torch.stack([t, t.flip(0)]) for t in g])
        batched = gnn.apply_batched(params, cfg, gb)
    assert attention.amp.launches == 12
    want_b = torch.stack([plain, _parent_attention_apply(params, cfg, Graph(*[t.flip(0)
                                                                             for t in g]))])
    torch.testing.assert_close(batched, want_b.detach(), rtol=0, atol=scale)

    leaves = gnn.trainable_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    w = torch.rand(700, generator=torch.Generator().manual_seed(0)).to(dev)
    got = gnn.apply(params, cfg, g)
    want = _parent_attention_apply(params, cfg, g)
    assert attention.amp.launches == 12 and torch.equal(got, want)
    for a, b in zip(torch.autograd.grad((got * w).sum(), leaves),
                    torch.autograd.grad((want * w).sum(), leaves)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_amp_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """On the card ``amp`` launches the kernel or raises: an activation
    with no kernel code (silu), nlist on the host, no edge feature."""
    from nmrgnn_tpu_torch.ops import attention

    wq, wk, wv, nodes, nlist, edges, inv = ops = _amp_case(dev, 64, 16, 64, 3, 12)
    before = attention.amp.launches
    with pytest.raises(ValueError):
        attention.amp(*ops, "silu")
    with pytest.raises(ValueError):
        attention.amp(wq, wk, wv, nodes, nlist.cpu(), edges, inv, "softplus")
    with pytest.raises(ValueError):
        attention.amp(wq[:, :0], wk[:0, :0], wv, nodes, nlist, edges[..., :0], inv, "softplus")
    assert attention.amp.launches == before


# -- the equivariant transformer's attention stage: one kernel a layer (csrc/et.cu) --


def _et_case(dev, n, k, F, heads, R, seed, empty_rows=()):
    """An ET layer's attention operands on the card: ``n`` atoms at about
    100 a cubic nm (protein density: about 55 within the 0.5 nm cutoff
    inside the box), each row's ``k`` nearest slots, every fifth row's
    slots past the cutoff made padding (index 0, distance 0), and rows
    ``empty_rows`` with no real slot but the self term (all padding where
    even; where odd, the atom moved 10 nm off, so its slots lie past the
    cutoff). q, k, v, v_state drawn; dk and dv of ``R`` functions with
    nonzero biases. Returns (p, q, k, v, vec, Geometry, heads)."""
    from nmrgnn_tpu_torch.ops import et

    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, (n / 100.0) ** (1 / 3), (n, 3)).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nlist = np.argsort(d, 1, kind="stable")[:, :k].astype(np.int32)
    edges = np.take_along_axis(d, nlist, 1).astype(np.float32)
    far = (edges >= 0.5) & (np.arange(n) % 5 == 0)[:, None]
    nlist[far], edges[far] = 0, 0.0
    for r in empty_rows:
        if r % 2 == 0:
            nlist[r], edges[r] = 0, 0.0
        else:
            pos[r] += 10.0
    nl, ed, xyz = _on(dev, nlist, edges, pos)
    geo = et.geometry(xyz, nl, ed, R, 0.0, 0.5)
    dense = lambda c: {"kernel": torch.from_numpy(  # noqa: E731
        (rng.normal(size=(R, c)) / np.sqrt(R)).astype(np.float32)).to(dev),
        "bias": torch.from_numpy(rng.uniform(-0.1, 0.1, c).astype(np.float32)).to(dev)}
    p = {"dk": dense(F), "dv": dense(3 * F)}
    q, kk, v, vec = _on(dev, *(rng.normal(size=s).astype(np.float32)
                               for s in ((n, F), (n, F), (n, 3 * F), (n, 3, F))))
    return p, q, kk, v, vec, geo, heads


def _et_check(ops, compute_dtype=torch.float32):
    """``fused_attention`` against ``attention`` on the card: elementwise
    within ``et_stage_bound`` (float32 sums in another order), finite, one
    count a call, nothing allocated past its outputs, the same bits on a
    second call (no atomics)."""
    from nmrgnn_tpu_torch.ops import et

    q, silu = ops[1], torch.nn.functional.silu
    with torch.no_grad():
        want = et.attention(*ops, silu, compute_dtype)
        torch.cuda.synchronize()
        before, base = et.fused_attention.launches, torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = et.fused_attention(*ops, silu, compute_dtype)
        torch.cuda.synchronize()
        assert et.fused_attention.launches == before + 1
        assert torch.cuda.max_memory_allocated() - base <= 4 * q.numel() * 4 + (1 << 20)
        for a, b, bound in zip(got, want, et_stage_bound(*ops)):
            assert a.shape == b.shape and torch.all(torch.isfinite(a))
            assert torch.all((a - b).abs().to(torch.float64) <= bound), \
                float(((a - b).abs() / bound.clamp_min(1e-300)).max())
        again = et.fused_attention(*ops, silu, compute_dtype)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
    return got, want


@pytest.mark.parametrize("n,k,F,heads,R,seed", [
    (700, 80, 256, 8, 64, 0),   # the ET cell's widths: D 32, K 80, R 64
    (500, 80, 128, 8, 64, 1),   # D 16 (ET-MD17's heads)
    (333, 40, 256, 4, 64, 2),   # D 64; N not a multiple of the 32-atom tile
    (257, 24, 256, 8, 18, 3),   # R 18: the staged basis reads the ones column, zero W rows
    (200, 128, 256, 8, 128, 4),  # K 128 and R 128, the largest the kernel takes
    (150, 128, 128, 8, 128, 10),  # the same at D 16: the most shared memory, 176 KB
])
def test_et_attention_kernel_matches_plain(dev, n, k, F, heads, R, seed):
    _et_check(_et_case(dev, n, k, F, heads, R, seed))


def test_et_attention_kernel_rows_with_no_real_slot(dev):
    """Rows all padding and rows all past the cutoff add only their self
    term, at the first and last atoms of tiles too."""
    ops = _et_case(dev, 300, 40, 256, 8, 64, 5, empty_rows=(0, 1, 31, 32, 63, 298, 299))
    geo = ops[5]
    assert int((geo.nlist[[0, 1, 31, 32, 63, 298, 299], :-1] < 300).sum()) == 0
    _et_check(ops)


def test_et_attention_kernel_self_term_alone(dev):
    """A graph of no slots (K = 0): the stage is each atom's self term."""
    p, q, k, v, vec, geo, heads = _et_case(dev, 96, 8, 128, 8, 32, 6)
    from nmrgnn_tpu_torch.ops import et

    empty = torch.zeros((96, 0), dtype=torch.int32, device=dev)
    xyz = torch.rand((96, 3), device=dev)
    geo = et.geometry(xyz, empty, empty.float(), 32, 0.0, 0.5)
    assert geo.nlist.shape == (96, 1)
    _et_check((p, q, k, v, vec, geo, heads))


def test_et_attention_kernel_bfloat16_operands(dev):
    """A bfloat16 ``compute_dtype``: the basis and W rounded as they are
    staged, as ``as_operand`` rounds them; the products and sums float32."""
    ops = _et_case(dev, 400, 80, 256, 8, 64, 7)
    got, want = _et_check(ops, torch.bfloat16)
    f32 = _et_check(ops)[0]
    assert float((got[0] - f32[0]).abs().max()) > 0


def _et_model(dev):
    cfg = ModelConfig(atom_feature_size=128, edge_feature_size=8, edge_hidden_size=32,
                      mp_layers=2, fc_layers=1, edge_fc_layers=1, neighbor_number=40,
                      mp_type="et", mp_activation="silu", fc_activation="silu", rbf_low=0.0,
                      rbf_high=0.5)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(3), device=dev)
    gen = torch.Generator().manual_seed(4)
    for layer in params["mp"]:  # nonzero biases
        for name in ("dk", "dv"):
            b = layer[name]["bias"]
            layer[name]["bias"] = ((torch.rand(b.shape, generator=gen) - 0.5) * 0.2).to(dev)
    return cfg, params


def test_et_forward_on_the_card(dev, monkeypatch):
    """An ET ServingModel.predict launches the kernel once a layer and
    equals the forward through the plain stage within 1e-5 of the largest
    peak (half the cell's ``peak_gap`` limit); a forward while autograd
    records launches it 0 times and equals the plain one bit for bit."""
    from nmrgnn_tpu_torch.ops import et

    cfg, params = _et_model(dev)
    rng = np.random.default_rng(8)
    n = 400
    pos = rng.uniform(0.0, (n / 100.0) ** (1 / 3), (n, 3)).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nlist = np.argsort(d, 1, kind="stable")[:, :40].astype(np.int32)
    edges = np.take_along_axis(d, nlist, 1).astype(np.float32)
    atoms = np.eye(10, dtype=np.float32)[rng.integers(1, 10, n)]
    g_np = Graph(atoms, nlist, edges, inv_degree_from_nlist(nlist))
    g, xyz = Graph(*_on(dev, *g_np)), torch.from_numpy(pos).to(dev)
    with torch.no_grad(), monkeypatch.context() as m:
        m.setattr(et, "fused_attention", et.attention)
        plain = gnn.apply(params, cfg, g, positions=xyz)
    _cuda.reset_launch_counts()
    served = ServingModel(params, cfg, device=dev).predict(g_np, positions=pos)
    assert et.fused_attention.launches == cfg.mp_layers
    scale = 1e-5 * float(plain.abs().max())
    np.testing.assert_allclose(served, plain.cpu().numpy(), rtol=0, atol=scale)
    for t in gnn.trainable_leaves(params):
        t.requires_grad_(True)
    recorded = gnn.apply(params, cfg, g, positions=xyz)
    assert et.fused_attention.launches == cfg.mp_layers and recorded.requires_grad
    assert torch.equal(recorded.detach(), plain)


def test_et_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """On the card ``fused_attention`` launches the kernel or raises:
    heads of 12, 129 functions, 130 slots a row, float64 operands, the
    neighbour list on the host, ReLU, float16 operands."""
    from nmrgnn_tpu_torch.ops import et

    p, q, k, v, vec, geo, heads = ops = _et_case(dev, 64, 16, 128, 8, 32, 9)
    silu = torch.nn.functional.silu
    n, S, width = geo.nlist.shape + (geo.basis.shape[-1],)
    wide = {"kernel": torch.zeros((129, 128), device=dev), "bias": p["dk"]["bias"]}
    bad = [
        (p, q[:, :96], k[:, :96], v[:, :288], vec[..., :96], geo, 8, silu),
        ({"dk": wide, "dv": p["dv"]}, q, k, v, vec, geo._replace(
            basis=torch.zeros((n, S, 136), device=dev)), heads, silu),
        (p, q, k, v, vec, et.Geometry(torch.full((n, 130), n, device=dev), torch.zeros(
            (n, 130, width), device=dev), torch.zeros((n, 130), device=dev),
            torch.zeros((n, 130, 3), device=dev)), heads, silu),
        (p, q.double(), k, v, vec, geo, heads, silu),
        (p, q, k, v, vec, geo._replace(nlist=geo.nlist.cpu()), heads, silu),
        (*ops, torch.relu),
    ]
    before = et.fused_attention.launches
    with torch.no_grad():
        for args in bad:
            with pytest.raises((ValueError, TypeError)):
                et.fused_attention(*args)
        with pytest.raises(TypeError):
            et.fused_attention(*ops, silu, torch.float16)
    assert et.fused_attention.launches == before


def _mace_case(dev, seed=2 ** 31 + 19):
    """The mace cell's configuration and one 2,482-atom chain of its
    traffic (K = 80, 5 A), weights drawn on the card: (ModelConfig, its
    dict, params, graph as numpy, positions nm as numpy)."""
    import dataclasses
    import json

    from portbench.drivers import predict_loop_xyz as xyz_loop
    from portbench.harness import inputs
    from portbench.harness.weights_mace import draw_params
    from portbench.reference.structures import one_hot

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench")
    with open(os.path.join(bench, "configs", "mace-off23-medium.json")) as f:
        cfg_d = json.load(f)
    with open(os.path.join(bench, "traffic", "predict-44676-r5-mace.json")) as f:
        t = {**json.load(f), "grid": [1, 1, 1]}
    cfg = ModelConfig(**{k: v for k, v in cfg_d.items()
                         if k in {f.name for f in dataclasses.fields(ModelConfig)}})
    xyz, elements = xyz_loop.supercell(t)
    conf = torch.as_tensor(xyz.astype(np.float32), device=dev)
    g = inputs.graph(one_hot(elements), *xyz_loop.cutoff_graph(conf, t["neighbors"], t["cutoff"]))
    return cfg, cfg_d, draw_params(cfg_d, seed, dev), Graph(*g), xyz.astype(np.float32) * 0.1


def test_mace_forward_on_the_card_matches_the_reference(dev):
    """At the published widths on a 2,482-atom chain of the cell's traffic,
    ``ServingModel.predict`` (``apply_mace``) equals the benchmark's plain
    reference within the cell's ``peak_gap`` limit, and a TF32 reference
    does not."""
    import json

    from portbench.reference import mace as ref
    from portbench.reference.model import Products

    cfg, cfg_d, params, g, pos = _mace_case(dev)
    assert g.atoms.shape[0] == 2482
    served = ServingModel(params, cfg, device=dev).predict(g, positions=pos)
    args = [torch.as_tensor(np.asarray(a), device=dev) for a in g[:3]]
    xyz = torch.as_tensor(pos, device=dev)
    with torch.no_grad():
        want = ref.forward(params, cfg_d, *args, xyz).cpu().numpy()
        tf32 = ref.forward(params, cfg_d, *args, xyz, prod=Products(tf32=True)).cpu().numpy()
    limits = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "portbench", "limits", "mace-predict-44676.json")
    with open(limits) as f:
        limit = json.load(f)["peak_gap"]
    scale = float(np.max(np.abs(want)))
    assert np.all(np.isfinite(served)) and scale > 0
    assert float(np.max(np.abs(served - want))) <= limit * scale
    assert float(np.max(np.abs(tf32 - want))) > limit * scale


def test_mace_conv_blocks_stay_under_their_memory_target(dev):
    """The second interaction's convolution (10 paths, 1,280 radial weights
    a slot) over 2,482 atoms, one full block of ``BLOCK_ROWS`` rows at
    K = 80, F = 128: its peak above its inputs and output stays under 4 GB."""
    from nmrgnn_tpu_torch.ops import mace

    cfg, _, params, g, pos = _mace_case(dev)
    gt = Graph(*[torch.as_tensor(np.asarray(a), device=dev) for a in g])
    geo = mace.geometry(torch.as_tensor(pos, device=dev), gt.nlist, gt.edges,
                        cfg.edge_hidden_size, cfg.rbf_high)
    n, F = gt.atoms.shape[0], cfg.atom_feature_size
    gen = torch.Generator(device=dev).manual_seed(0)
    ht = [torch.randn((n, 1, F), generator=gen, device=dev),
          torch.randn((n, 3, F), generator=gen, device=dev)]
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = mace.conv(params["mp"][1], ht, geo, params["avg_num_neighbors"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    assert a.shape == (n, 16, F) and bool(torch.isfinite(a).all())
    assert n > mace.BLOCK_ROWS
    assert peak < 4e9, peak
