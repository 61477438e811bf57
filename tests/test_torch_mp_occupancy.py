"""The band's chunk occupancy (``ops/banded.py``: ``band_occupancy``), the
map of 16-column window chunks that the MP kernel (``csrc/mp.cuh``) stages
and multiplies, on the CPU through the plain versions.

The occupancy the forwards make from nlist, the distances and the window
starts must be exact: every nonzero of the band, as each band build of the
port makes it, lies in a marked chunk. On these graphs (no band entry that
sums to zero) it equals the occupancy read from the band itself, for the
uniform, class (ids) and frames plans. An MP layer given the occupancy
equals the JAX package's layer.

Graphs are banded as ``tests/test_banded.py:187-192`` builds them
(nlist = i + randint(-40, 40)), with padding slots (distance 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.ops import banded as jbanded
from nmrgnn_tpu_torch.ops import banded
from nmrgnn_tpu_torch.ops import mp as tmp
from nmrgnn_tpu_torch.ops.edgefn import EdgeCheb


def banded_graph(n=700, k=16, seed=0, e=3):
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    if n > 400:  # a few far neighbors, so the tiles' windows differ
        nlist[::37, 0] = np.minimum(np.arange(0, n, 37) + 300, n - 1)
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    dists[5, :] = 0.0
    dists[rng.uniform(size=(n, k)) < 0.1] = 0.0  # padding slots, index still in the window
    efeat = rng.normal(size=(n, k, e)).astype(np.float32) * (dists > 0)[..., None]
    return nlist, dists, efeat


def cheb(e=3, degree=16, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(degree + 1, e)) * 0.8 ** np.arange(degree + 1)[:, None]
    return EdgeCheb(coeffs=c.astype(np.float32), d_lo=0.0, d_hi=0.25)


def covers(occ, M):
    """Whether every nonzero of M [T, E, B, W] lies in a chunk of occ."""
    T, _, B, W = M.shape
    bits = banded.occupancy_bits(occ, W).view(T, B, W // 16)
    nz = (M != 0).any(1).view(T, B, W // 16, 16).any(-1)
    return bool(nz.any()) and not bool((nz & ~bits).any())


def tens(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uniform_occupancy_is_exact(dtype):
    nlist, dists, efeat = banded_graph()
    plan = banded.band_plan(nlist, dists)
    nl, d, ef = tens(nlist, dists, efeat)
    occ = banded.band_occupancy(nl, d, plan.lo, plan.window, plan.block_rows, plan.n_padded)
    assert occ.dtype == torch.int32
    assert occ.shape == (plan.n_padded, banded.occupancy_words(plan.window))
    for M in (banded.build_band_plain(nl, ef, plan, dtype),
              banded.build_band_poly_plain(nl, d, cheb(), plan, dtype)):
        assert covers(occ, M)
        assert torch.equal(occ, banded.band_occupancy_from_band(M))
    # padded rows occupy nothing; a padding slot alone marks no chunk
    assert not occ[len(nlist):].any()
    bits = banded.occupancy_bits(occ, plan.window)
    assert int(bits.sum()) < int((dists > 0).sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_class_occupancy_with_ids_is_exact(dtype):
    nlist, dists, _ = banded_graph(n=900, seed=1)
    cls_plan = banded.band_plan_classes(nlist, dists)
    assert len(cls_plan.classes) > 1
    nl, d = tens(nlist, dists)
    B = cls_plan.block_rows
    for c in cls_plan.classes:
        occ = banded.band_occupancy(nl, d, c.lo, c.window, B, cls_plan.n_padded, ids=c.ids)
        Mc = banded.build_band_poly_cls_plain(nl, d, cheb(), c, B, cls_plan.n_padded, dtype)
        assert covers(occ, Mc)
        assert torch.equal(occ, banded.band_occupancy_from_band(Mc))
        # grid row i * B + r is row ids[i] * B + r of the uniform occupancy at these windows
        lo_full = np.zeros(cls_plan.num_tiles, np.int32)
        lo_full[c.ids] = c.lo
        full = banded.band_occupancy(nl, d, lo_full, c.window, B, cls_plan.n_padded)
        rows = (torch.as_tensor(c.ids, dtype=torch.long)[:, None] * B + torch.arange(B)).view(-1)
        assert torch.equal(occ, full[rows])
    # an id outside the plan's tiles occupies nothing
    c = cls_plan.classes[-1]
    assert len(c.ids) > 2
    bad = np.array([cls_plan.num_tiles, -1] + list(c.ids[2:]), np.int32)
    occ = banded.band_occupancy(nl, d, c.lo, c.window, B, cls_plan.n_padded, ids=bad)
    assert not occ[: 2 * B].any()


def test_frames_occupancy_is_exact():
    """The batched frames' layout (``apply_banded_frames``): frames end to
    end along the rows, indices and window starts moved by f * n_padded."""
    frames = [banded_graph(n=500, seed=s) for s in (2, 3, 4)]
    nl_s = np.stack([f[0] for f in frames])
    d_s = np.stack([f[1] for f in frames])
    plan = banded.band_plan_frames(nl_s, d_s)
    npad, fr = plan.n_padded, len(frames)
    pad = npad - nl_s.shape[1]
    offsets = (np.arange(fr) * npad)[:, None, None]
    nl_p = np.pad(nl_s, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
    nl_b = np.where(nl_p >= 0, nl_p + offsets, nl_p).reshape(fr * npad, -1).astype(np.int32)
    d_b = np.pad(d_s, ((0, 0), (0, pad), (0, 0))).reshape(fr * npad, -1)
    e_b = np.pad(np.stack([f[2] for f in frames]),
                 ((0, 0), (0, pad), (0, 0), (0, 0))).reshape(fr * npad, nl_s.shape[2], -1)
    lo_b = (np.asarray(plan.lo)[None, :] + offsets[:, 0]).reshape(-1).astype(np.int32)
    big = plan._replace(lo=lo_b, n_padded=fr * npad)
    nl, d, ef = tens(nl_b, d_b, e_b)
    occ = banded.band_occupancy(nl, d, big.lo, big.window, big.block_rows, big.n_padded)
    M = banded.build_band_plain(nl, ef, big)
    assert covers(occ, M)
    assert torch.equal(occ, banded.band_occupancy_from_band(M))


def test_occupancy_bits_round_trip():
    rng = np.random.default_rng(5)
    bits = torch.from_numpy(rng.uniform(size=(37, 70)) < 0.3)
    occ = tmp.pack_bits(bits)
    assert occ.shape == (37, 3) and occ.dtype == torch.int32
    assert torch.equal(banded.occupancy_bits(occ, 70 * 16), bits)
    assert (occ < 0).any()  # bit 31 set: the word's sign


def test_missing_chunk_changes_the_layer():
    """The MP layer reads only the chunks the occupancy marks: a complete
    occupancy gives the dense layer, one with a chunk dropped does not."""
    nlist, dists, efeat = banded_graph(n=300, seed=6)
    plan = banded.band_plan(nlist, dists)
    nl, d, ef = tens(nlist, dists, efeat)
    M = banded.build_band_plain(nl, ef, plan)
    rng = np.random.default_rng(6)
    nodes = torch.from_numpy(rng.normal(size=(plan.n_padded, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 64, 3)) / 8).astype(np.float32))
    occ = banded.band_occupancy(nl, d, plan.lo, plan.window, plan.block_rows, plan.n_padded)
    dense = banded.mp_banded_partial(M, plan.lo, nodes, w)
    assert torch.equal(banded.mp_banded_partial(M, plan.lo, nodes, w, occ), dense)
    holed = occ.clone()
    holed[10] = 0
    assert not torch.equal(banded.mp_banded_partial(M, plan.lo, nodes, w, holed), dense)


@pytest.mark.parametrize("use_cls", [False, True])
def test_mp_layers_given_the_occupancy_match_jax(use_cls):
    """mp_banded (uniform) and mp_banded_hbm_cls (a class, through its ids)
    given the occupancy from nlist equal the JAX package's layers."""
    nlist, dists, efeat = banded_graph(n=900, seed=7)
    rng = np.random.default_rng(7)
    F, E = 64, 3
    nl, d, ef = tens(nlist, dists, efeat)
    w = (rng.normal(size=(F, F, E)) / np.sqrt(F)).astype(np.float32)
    if not use_cls:
        plan = banded.band_plan(nlist, dists)
        nodes = rng.normal(size=(plan.n_padded, F)).astype(np.float32)
        inv = rng.uniform(0.05, 1.0, plan.n_padded).astype(np.float32)
        M = banded.build_band_plain(nl, ef, plan)
        occ = banded.band_occupancy(nl, d, plan.lo, plan.window, plan.block_rows,
                                    plan.n_padded)
        got = banded.mp_banded(M, plan, *tens(nodes, w, inv), "softplus", occ)
        jplan = jbanded.BandPlan(lo=np.asarray(plan.lo), window=plan.window,
                                 block_rows=plan.block_rows, n_padded=plan.n_padded)
        want = jbanded.mp_banded(jnp.asarray(M.numpy()), jplan, jnp.asarray(nodes),
                                 jnp.asarray(w), jnp.asarray(inv), "softplus", interpret=True)
    else:
        cp = banded.band_plan_classes(nlist, dists)
        c, B = cp.classes[-1], cp.block_rows
        nodes = rng.normal(size=(cp.n_padded, F)).astype(np.float32)
        inv = rng.uniform(0.05, 1.0, cp.n_padded).astype(np.float32)
        Mc = banded.build_band_poly_cls_plain(nl, d, cheb(), c, B, cp.n_padded)
        occ = banded.band_occupancy(nl, d, c.lo, c.window, B, cp.n_padded, ids=c.ids)
        got = banded.mp_banded_hbm_cls(Mc, c, B, *tens(nodes, w, inv), "softplus", occ)
        jc = jbanded.BandClass(ids=np.asarray(c.ids), lo=np.asarray(c.lo), window=c.window)
        want = jbanded.mp_banded_hbm_cls(jnp.asarray(Mc.numpy()), jc, B, jnp.asarray(nodes),
                                         jnp.asarray(w), jnp.asarray(inv), "softplus",
                                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.device_get(want)), rtol=2e-4,
                               atol=2e-4)
