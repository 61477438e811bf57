"""The port's MACE family (``mp_type="mace"``, ``ops/mace.py``,
``gnn.apply_mace``) on the CPU against the benchmark's plain reference
``portbench/reference/mace.py``, at 48 atoms, K = 16 slots, F = 16
channels, both interactions, hidden L = 1, l to 3 and correlation 3, on
seeded weights (e3nn's scales, the post-convolution Linears at ``GAIN``
so that A's rms is of order 1 at every l and the order-2 and order-3
terms and the l = 2, 3 paths move the peaks, peak spreads drawn, peak
means 0 so that the peaks are the network's part alone). Each
interaction's A and the symmetric contraction, order by order on
unit-scale A, are held to the reference's on their own.

Tolerances, as ``peak_gap``: the widest gap of a peak over the largest
reference peak.
  * port against reference, 1e-5: the same float32 mathematics in
    another order (the slot sums before C, the symmetric contraction as
    x (x) x against each element's folded W U), so float32 rounding alone.
    Measured 2.5e-6 on these weights; the reference with TF32 products
    reads 1e-3 at the published widths (the benchmark's control).
  * a rotated and shifted structure against the structure, 1e-5: the
    peaks are invariant, so this holds Y, C and U without the reference.
  * padding slots added, 1e-6: they add exactly 0.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from nmrgnn_tpu import config as jconfig
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import mace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from portbench.reference import mace as ref  # noqa: E402

torch.set_num_threads(2)

with open(os.path.join(REPO, "portbench", "configs", "mace-off23-medium.json")) as f:
    PUBLISHED_JSON = json.load(f)
PUBLISHED = ModelConfig(**{k: v for k, v in PUBLISHED_JSON.items()
                           if k in {f.name for f in dataclasses.fields(ModelConfig)}})
SMALL = PUBLISHED.replace(atom_feature_size=16, neighbor_number=16)
GAIN = (300.0, 10.0)  # the post-convolution Linears' gain, an interaction each
TOL = 1e-5       # port against reference (module docstring)
ROT_TOL = 1e-5   # rotated against unrotated
PAD_TOL = 1e-6   # padding slots added


def _structure(seed=0, k=16):
    """(Graph of numpy arrays, positions f32[N, 3] nm): a jittered 4 x 4 x 3
    lattice of 0.25 nm, so that corner atoms' 16 nearest slots reach past
    the 0.5 nm cutoff; on even rows the slots past it are padding (index 0,
    distance 0), on odd rows they stay, slots that are no edge."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3), indexing="ij"),
                    -1).reshape(-1, 3)
    pos = (grid * 0.25 + rng.normal(scale=0.02, size=grid.shape)).astype(np.float32)
    n = pos.shape[0]
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nlist = np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)
    edges = np.take_along_axis(d, nlist, 1).astype(np.float32)
    far = (edges >= SMALL.rbf_high) & (np.arange(n) % 2 == 0)[:, None]
    nlist[far], edges[far] = 0, 0.0
    atoms = np.zeros((n, SMALL.num_elements), np.float32)
    atoms[np.arange(n), rng.integers(1, 6, n)] = 1.0
    inv = np.full(n, 1.0 / k, np.float32)
    return Graph(atoms, nlist, edges, inv), pos


def _params(config, seed=1):
    """init_params with the post-convolution Linears at ``GAIN``,
    ``avg_num_neighbors`` 9, the peak spreads drawn, the means 0."""
    params = gnn.init_params(config, torch.Generator().manual_seed(seed), device="cpu")
    for layer, gain in zip(params["mp"], GAIN):
        for lin in layer["linear"]:
            lin["kernel"].mul_(gain)
    gen = torch.Generator().manual_seed(seed + 1)
    params["avg_num_neighbors"] = torch.tensor(9.0)
    params["peak_std"] = 1.0 + 19.0 * torch.rand(config.num_elements, generator=gen)
    params["peak_avg"] = torch.zeros(config.num_elements)
    return params


def _tensors(g, pos):
    return Graph(*[torch.as_tensor(a) for a in g]), torch.as_tensor(pos)


def _want(params, g, pos, **kw):
    gt, post = _tensors(g, pos)
    return ref.forward(params, dataclasses.asdict(SMALL), *gt[:3], post, **kw).numpy()


def _port(params, config, g, pos):
    gt, post = _tensors(g, pos)
    return gnn.apply(params, config, gt, positions=post).numpy()


def _gap(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


@pytest.fixture(scope="module")
def case():
    g, pos = _structure()
    params = _params(SMALL)
    return g, pos, params, _want(params, g, pos)


def test_the_structure_has_padding_and_slots_past_the_cutoff(case):
    g, _, _, want = case
    assert (g.edges == 0).any() and (g.edges >= SMALL.rbf_high).any()
    assert ((g.edges > 0) & (g.edges < SMALL.rbf_high)).sum(1).min() > 0
    assert np.max(np.abs(want)) > 0


def test_gather_forward_equals_the_reference(case):
    g, pos, params, want = case
    assert _gap(_port(params, SMALL, g, pos), want) <= TOL


def test_predict_with_reorder_equals_the_reference(case):
    g, pos, params, want = case
    sm = ServingModel(params, SMALL, device="cpu", reorder=True)
    got = sm.predict(g, positions=pos)
    assert sm._resolved == "gather" and sm._inverse is not None
    assert _gap(got, want) <= TOL


@pytest.mark.parametrize("seed", [3, 4])
def test_peaks_do_not_change_when_the_structure_rotates(case, seed):
    g, pos, params, _ = case
    moved = (pos.astype(np.float64) @ _rotation(seed).T + 0.7).astype(np.float32)
    a, b = _port(params, SMALL, g, pos), _port(params, SMALL, g, moved)
    assert _gap(b, a.astype(np.float64)) <= ROT_TOL


def _first_a(params, g, pos):
    """The first interaction's A [N, 16, F], before its element mix."""
    gt, post = _tensors(g, pos)
    geo = mace.geometry(post, gt.nlist, gt.edges, SMALL.edge_hidden_size, SMALL.rbf_high)
    h = [(gt.atoms @ params["embed"]["kernel"])[:, None, :]]
    p = params["mp"][0]
    return mace.conv(p, mace.linear(p["up"], h), geo, params["avg_num_neighbors"]).double()


@pytest.mark.parametrize("seed", [5, 6])
def test_the_first_layers_a_turns_with_d_l(case, seed):
    g, pos, params, _ = case
    rot = _rotation(seed)
    a = _first_a(params, g, pos)
    b = _first_a(params, g, (pos.astype(np.float64) @ rot.T).astype(np.float32))
    scale = float(a.abs().max())
    for l in range(4):
        sl = slice(l * l, (l + 1) ** 2)
        turned = torch.einsum("mn,anf->amf", torch.as_tensor(mace.wigner_d(l, rot)), a[:, sl])
        assert float((b[:, sl] - turned).abs().max()) <= 1e-5 * scale
        if l:
            assert float(a[:, sl].abs().max()) > 1e-3 * scale  # each l is there


def _rms(x):
    return float(x.double().pow(2).mean().sqrt())


@pytest.mark.parametrize("t", [0, 1])
def test_each_interactions_a_equals_the_references(case, monkeypatch, t):
    """A [N, 16, F] as ``apply_mace`` hands it to ``product`` (in element
    order, put back) against the reference's ``layer_out``, each l at
    unit-order rms."""
    g, pos, params, _ = case
    seen = []
    product = mace.product
    monkeypatch.setattr(mace, "product", lambda p, A, *a: seen.append(A) or product(p, A, *a))
    _port(params, SMALL, g, pos)
    want = []
    _want(params, g, pos, layer_out=want)
    got = seen[t][mace.element_groups(torch.as_tensor(g.atoms)).inverse]
    for l in range(4):
        assert _rms(want[t][:, l * l:(l + 1) ** 2]) > 0.1
    assert float((got - want[t]).abs().max()) <= TOL * float(want[t].abs().max())


def _contraction_case(t, nu=None):
    """(weights of interaction ``t``'s contraction, with only order ``nu``
    kept if given; its outputs L; A ~ N(0, 1) [48, 16, F]; one-hot atoms)."""
    g, _ = _structure()
    params = _params(SMALL)
    wts = [{k: (v if nu is None or k == f"w{nu}" else torch.zeros_like(v))
            for k, v in w.items()} for w in params["mp"][t]["product"]]
    A = torch.randn((g.atoms.shape[0], 16, SMALL.atom_feature_size),
                    generator=torch.Generator().manual_seed(40 + t))
    return wts, gnn.mace_irreps(SMALL)[1][t], A, torch.as_tensor(g.atoms)


def _product(wts, Ls, A, atoms, **kw):
    groups = mace.element_groups(atoms)
    return mace.product(wts, A[groups.order], groups.spans, Ls, **kw)[groups.inverse]


@pytest.mark.parametrize("t,nu", [(0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3)])
def test_product_equals_the_references_contraction_order_by_order(t, nu):
    wts, Ls, A, atoms = _contraction_case(t, nu)
    want = torch.cat([ref.contract(w, A, atoms, L) for w, L in zip(wts, Ls)], 1)
    got = _product(wts, Ls, A, atoms)
    assert _rms(want) > 0.1
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_product_blocks_do_not_change_the_contraction():
    wts, Ls, A, atoms = _contraction_case(0)
    whole = _product(wts, Ls, A, atoms)
    parts = _product(wts, Ls, A, atoms, block=7)
    assert max(b - a for _, a, b in mace.element_groups(atoms).spans) > 7
    assert torch.allclose(parts, whole, rtol=1e-6, atol=1e-6 * float(whole.abs().max()))


def test_spherical_harmonics_are_normalized_per_l():
    u = np.random.default_rng(0).normal(size=(50, 3))
    y = mace.spherical_harmonics(torch.as_tensor(u / np.linalg.norm(u, axis=1, keepdims=True)))
    for l in range(4):
        np.testing.assert_allclose((y[:, l * l:(l + 1) ** 2] ** 2).sum(1), 2 * l + 1,
                                   rtol=1e-12)


TRIPLES = [(l1, l2, l3) for l1 in range(4) for l2 in range(4) for l3 in range(abs(l1 - l2),
           min(l1 + l2, 3) + 1) if (l1 + l2 + l3) % 2 == 0]


def test_clebsch_gordan_equal_the_references_and_intertwine():
    rot = _rotation(9)
    for l1, l2, l3 in TRIPLES:
        c = mace.clebsch_gordan(l1, l2, l3)
        assert np.max(np.abs(c - ref.cg(l1, l2, l3))) <= 1e-10
        assert abs(np.linalg.norm(c) - 1.0) <= 1e-12
        assert c.reshape(-1)[np.flatnonzero(np.abs(c) > 1e-9)[0]] > 0
        d1, d2, d3 = (mace.wigner_d(l, rot) for l in (l1, l2, l3))
        np.testing.assert_allclose(np.einsum("ia,jb,ijk->abk", d1, d2, c),
                                   np.einsum("kc,abc->abk", d3, c), atol=1e-10)


def _apply_rep(u, rep, nu):
    """U with ``rep`` [16, 16] applied to each of its nu a indices."""
    for ax in range(1, nu + 1):
        u = np.moveaxis(np.tensordot(rep, u, axes=([0], [ax])), 0, ax)
    return u


@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("L", [0, 1])
def test_coupling_bases_equal_the_references_and_are_orthonormal_symmetric_equivariant(nu, L):
    u = mace.coupling_basis(nu, L)
    assert u.shape == ref.u_basis(nu, L).shape
    assert np.max(np.abs(u - ref.u_basis(nu, L))) <= 1e-10
    flat = u.reshape(-1, u.shape[-1])
    np.testing.assert_allclose(flat.T @ flat, np.eye(u.shape[-1]), atol=1e-12)
    for axes in ((1, 2), (2, 3)):
        if axes[1] <= nu:
            np.testing.assert_allclose(np.swapaxes(u, *axes), u, atol=1e-12)
    rot = _rotation(11)
    rep = np.zeros((16, 16))
    for l in range(4):
        rep[l * l:(l + 1) ** 2, l * l:(l + 1) ** 2] = mace.wigner_d(l, rot)
    np.testing.assert_allclose(_apply_rep(u, rep, nu),
                               np.tensordot(mace.wigner_d(L, rot), u, axes=([1], [0])),
                               atol=1e-10)
    parity = np.diag([(-1.0) ** l for l in range(4) for _ in range(2 * l + 1)])
    np.testing.assert_allclose(_apply_rep(u, parity, nu), (-1) ** L * u, atol=1e-12)


def test_padding_slots_add_exactly_nothing(case):
    g, pos, params, want = case
    gt, post = _tensors(g, pos)
    geo = mace.geometry(post, gt.nlist, gt.edges, SMALL.edge_hidden_size, SMALL.rbf_high)
    no_edge = (gt.edges <= 0) | (gt.edges >= SMALL.rbf_high)
    assert torch.isfinite(geo.sh).all() and torch.isfinite(geo.basis).all()
    assert bool((geo.basis[no_edge] == 0).all())
    for layer in params["mp"]:  # a slot's term in M is w times finite rows: w is 0
        assert bool((mace.radial_weights(layer["radial"], geo.basis[no_edge]) == 0).all())
    wide = Graph(g.atoms, np.pad(g.nlist, ((0, 0), (0, 8))), np.pad(g.edges, ((0, 0), (0, 8))),
                 g.inv_degree)
    got = ServingModel(params, SMALL, device="cpu").predict(wide, positions=pos)
    assert np.all(np.isfinite(got))
    assert _gap(got, _port(params, SMALL, g, pos).astype(np.float64)) <= PAD_TOL
    assert _gap(got, want) <= TOL


def test_an_atom_of_no_element_adds_nothing_of_its_own(case):
    g, pos, params, _ = case
    atoms = g.atoms.copy()
    atoms[5] = 0.0
    bare = Graph(atoms, g.nlist, g.edges, g.inv_degree)
    groups = mace.element_groups(torch.as_tensor(atoms))
    assert sum(b - a for _, a, b in groups.spans) == len(atoms) - 1
    assert int(groups.order[-1]) == 5
    got = _port(params, SMALL, bare, pos)
    assert got[5] == 0.0
    assert _gap(got, _want(params, bare, pos)) <= TOL


def test_conv_blocks_do_not_change_the_sums(case):
    g, pos, params, _ = case
    gt, post = _tensors(g, pos)
    geo = mace.geometry(post, gt.nlist, gt.edges, SMALL.edge_hidden_size, SMALL.rbf_high)
    p = params["mp"][1]
    gen = torch.Generator().manual_seed(3)
    ht = [torch.randn((48, 1, 16), generator=gen), torch.randn((48, 3, 16), generator=gen)]
    whole = mace.conv(p, ht, geo, params["avg_num_neighbors"])
    parts = mace.conv(p, ht, geo, params["avg_num_neighbors"], block=7)
    assert torch.allclose(parts, whole, rtol=1e-6, atol=1e-7)


def test_published_widths_have_the_configurations_parameter_count():
    params = gnn.init_params(PUBLISHED, torch.Generator().manual_seed(0), device="cpu")
    assert gnn.count_params(params) == PUBLISHED_JSON["parameters"] == 1_342_922
    assert "avg_num_neighbors" not in {k for k, v in gnn.trainable_mask(params).items()
                                       if v is True}
    layer = params["mp"][1]
    assert layer["radial"][-1]["kernel"].shape == (64, 10 * 128)
    assert [p["w3"].shape for p in params["mp"][0]["product"]] == [(10, 8, 128), (10, 12, 128)]


def test_a_hidden_l_past_three_raises(case):
    with pytest.raises(ValueError, match="mp_type='mace'"):
        gnn.init_params(SMALL.replace(edge_feature_size=4), torch.Generator(), device="cpu")


def test_calls_without_positions_and_unsupported_paths_raise(case):
    from nmrgnn_tpu_torch.parallel.mesh import Mesh
    from nmrgnn_tpu_torch.train.partitioned import PartitionedTrainer
    from nmrgnn_tpu_torch.train.trainer import Trainer

    g, pos, params, _ = case
    gt, post = _tensors(g, pos)
    with pytest.raises(ValueError, match="mp_type='mace' needs the atoms' positions"):
        gnn.apply(params, SMALL, gt)
    with pytest.raises(ValueError, match="mp_type='mace' serves inference only"):
        gnn.apply(params, SMALL, gt, positions=post, training=True)
    sm = ServingModel(params, SMALL, device="cpu")
    with pytest.raises(ValueError, match="mp_type='mace' needs the atoms' positions"):
        sm.predict(g)
    with pytest.raises(ValueError, match="predict_frames does not serve mp_type='mace'"):
        sm.predict_frames([g, g])
    with pytest.raises(ValueError, match="predict_trajectory does not serve mp_type='mace'"):
        next(sm.predict_trajectory(None))
    mesh = Mesh(1, 2, {}, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="mp_type='mace' is not served partitioned"):
        ServingModel(params, SMALL, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="Trainer does not train mp_type='mace'"):
        Trainer(SMALL, device="cpu")
    with pytest.raises(ValueError, match="PartitionedTrainer does not train mp_type='mace'"):
        PartitionedTrainer(SMALL, mesh=mesh, device="cpu")


def test_the_mace_config_loads_in_the_jax_packages_model_config():
    j = jconfig.ModelConfig.from_json(PUBLISHED.to_json())
    assert j.to_json() == PUBLISHED.to_json()
    assert ModelConfig.from_json(j.to_json()) == PUBLISHED
