"""The port's equivariant-transformer family (``mp_type="et"``,
``ops/et.py``, ``gnn.apply_et``) against the plain reference
``tests/_et_reference.py`` on the CPU, at 216 atoms, K = 24 slots, F = 64
in 8 heads of 8 and 2 layers, on seeded random weights with nonzero
biases and drawn LayerNorm affines.

Tolerances, as ``peak_gap``: the widest gap of a peak over the largest
reference peak (132 ppm here; the standards put 0-150 ppm means on
outputs of about 0.3-0.6).
  * port against reference, 2e-6: the same float32 mathematics in
    another order (the basis in nm, the head sums as products, the self
    term as one more slot, the padding masked in dv), so float32 rounding
    alone. Measured 1.2e-7, one float32 step of the largest peak. With
    the Dense products' operands in bfloat16 (a
    ``compute_dtype="bfloat16"`` config) it reads 8.0e-4, so it fails
    (``test_the_tolerance_catches_bfloat16_products``); the reference
    without the self term reads 6.9e-3 and without the padding mask of
    the value message 0.14
    (``test_the_tolerance_catches_a_missing_self_term_or_mask``).
  * a rotated and shifted structure against the structure, 2e-6: the
    peaks are invariant, and only float32 rounding of the moved
    coordinates and directions moves them. Measured 1.2e-7 to 1.4e-7 on
    two rotations; bfloat16 products read 1.4e-5 there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _et_reference as ref
from nmrgnn_tpu import config as jconfig
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda, et

torch.set_num_threads(2)

PUBLISHED = ModelConfig(atom_feature_size=256, mp_layers=8, edge_hidden_size=64,
                        edge_feature_size=8, rbf_low=0.0, rbf_high=0.5, edge_fc_layers=1,
                        fc_layers=1, mp_activation="silu", fc_activation="silu",
                        neighbor_number=80, mp_type="et")
SMALL = PUBLISHED.replace(atom_feature_size=64, mp_layers=2, neighbor_number=24)
TOL = 2e-6       # port against reference (module docstring)
ROT_TOL = 2e-6   # rotated against unrotated (module docstring)


def _structure(seed=0, n_side=6, spacing=0.3, k=24):
    """(Graph of numpy arrays, positions f32[N, 3] nm): a jittered cubic
    lattice of 0.3 nm, so that each atom's 24 nearest slots reach past the
    0.5 nm cutoff; on even rows the slots past it are padding (index 0,
    distance 0), on odd rows they stay, slots that are no edge."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = (grid * spacing + rng.normal(scale=0.02, size=grid.shape)).astype(np.float32)
    n = pos.shape[0]
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nlist = np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)
    edges = np.take_along_axis(d, nlist, 1).astype(np.float32)
    far = (edges >= SMALL.rbf_high) & (np.arange(n) % 2 == 0)[:, None]
    nlist[far], edges[far] = 0, 0.0
    atoms = np.zeros((n, SMALL.num_elements), np.float32)
    atoms[np.arange(n), rng.integers(1, SMALL.num_elements, n)] = 1.0
    deg = (nlist > 0).sum(1).astype(np.float32)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0).astype(np.float32)
    return Graph(atoms, nlist, edges, inv), pos


def _params(config, seed=1):
    """init_params with every bias, the LayerNorm affines and the peak
    standards drawn too."""
    gen = torch.Generator().manual_seed(seed)
    params = gnn.init_params(config, gen, device="cpu")

    def fill(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "bias":
                    tree[k] = (torch.rand(v.shape, generator=gen) * 2 - 1) * 0.05
                elif k == "weight":
                    tree[k] = 0.8 + 0.4 * torch.rand(v.shape, generator=gen)
                else:
                    fill(v)
        elif isinstance(tree, list):
            for v in tree:
                fill(v)

    fill(params)
    params["peak_std"] = 1.0 + 19.0 * torch.rand(config.num_elements, generator=gen)
    params["peak_avg"] = 150.0 * torch.rand(config.num_elements, generator=gen)
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
    return (q if np.linalg.det(q) > 0 else -q).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    g, pos = _structure()
    params = _params(SMALL)
    return g, pos, params, _want(params, g, pos)


def test_the_structure_has_padding_and_slots_past_the_cutoff(case):
    g, pos, params, _ = case
    assert (g.edges == 0).any() and (g.edges >= SMALL.rbf_high).any()
    assert ((g.edges > 0) & (g.edges < SMALL.rbf_high)).sum(1).min() > 0
    assert all(float(b.abs().min()) > 0 for b in
               (params["mp"][0]["dv"]["bias"], params["mp"][1]["dk"]["bias"]))


def test_gather_forward_equals_the_reference(case):
    g, pos, params, want = case
    assert _gap(_port(params, SMALL, g, pos), want) <= TOL


def test_predict_with_reorder_equals_the_reference(case):
    g, pos, params, want = case
    sm = ServingModel(params, SMALL, device="cpu", reorder=True)
    got = sm.predict(g, positions=pos)
    assert sm._resolved == "gather" and sm._inverse is not None
    assert not np.array_equal(sm._order, np.arange(len(pos)))
    assert _gap(got, want) <= TOL
    # a second request of the same structure takes the cached order
    assert _gap(sm.predict(g, positions=pos), want) <= TOL


@pytest.mark.parametrize("seed", [3, 4])
def test_peaks_do_not_change_when_the_structure_rotates(case, seed):
    g, pos, params, _ = case
    rot = pos @ _rotation(seed).T + np.float32(0.7)
    a, b = _port(params, SMALL, g, pos), _port(params, SMALL, g, rot)
    assert _gap(b, a.astype(np.float64)) <= ROT_TOL


def test_padding_slots_add_nothing_and_stay_finite(case):
    g, pos, params, want = case
    # eight more padding slots an atom, against the graph without them
    wide = Graph(g.atoms, np.pad(g.nlist, ((0, 0), (0, 8))), np.pad(g.edges, ((0, 0), (0, 8))),
                 g.inv_degree)
    got = ServingModel(params, SMALL, device="cpu").predict(wide, positions=pos)
    assert np.all(np.isfinite(got))
    assert _gap(got, _port(params, SMALL, g, pos).astype(np.float64)) <= TOL
    assert _gap(got, want) <= TOL
    # the padding and the slots past the cutoff removed: each row's edges
    # first, then its columns past the widest row's edges dropped
    edge = (g.edges > 0) & (g.edges < SMALL.rbf_high)
    order = np.argsort(~edge, axis=1, kind="stable")
    keep = int(edge.sum(1).max())
    nl = np.where(np.take_along_axis(edge, order, 1), np.take_along_axis(g.nlist, order, 1), 0)
    ed = np.where(np.take_along_axis(edge, order, 1), np.take_along_axis(g.edges, order, 1), 0)
    tight = Graph(g.atoms, nl[:, :keep].copy(), ed[:, :keep].astype(np.float32).copy(),
                  g.inv_degree)
    assert keep < g.nlist.shape[1]
    assert _gap(_port(params, SMALL, tight, pos), want) <= TOL
    # atom 0 with every slot padding: each names atom 0 itself, at r_ij = 0
    lonely = Graph(g.atoms, g.nlist.copy(), g.edges.copy(), g.inv_degree)
    lonely.nlist[0], lonely.edges[0] = 0, 0.0
    got = _port(params, SMALL, lonely, pos)
    assert np.all(np.isfinite(got))
    assert _gap(got, _want(params, lonely, pos)) <= TOL


@pytest.mark.parametrize("left_out", ["self_term", "mask_values"])
def test_the_tolerance_catches_a_missing_self_term_or_mask(case, left_out):
    g, pos, params, _ = case
    wrong = _want(params, g, pos, **{left_out: False})
    assert _gap(_port(params, SMALL, g, pos), wrong) > TOL


@pytest.mark.parametrize("test", ["reference", "rotation"])
def test_the_tolerance_catches_bfloat16_products(case, test):
    g, pos, params, want = case
    bf16 = SMALL.replace(compute_dtype="bfloat16")
    got = _port(params, bf16, g, pos)
    if test == "reference":
        assert _gap(got, want) > TOL
    else:
        rot = pos @ _rotation(3).T + np.float32(0.7)
        assert _gap(_port(params, bf16, g, rot), got.astype(np.float64)) > ROT_TOL


def test_attention_blocks_do_not_change_the_sums(case):
    g, pos, params, _ = case
    gt, post = _tensors(g, pos)
    geo = et.geometry(post, gt.nlist, gt.edges, SMALL.edge_hidden_size, SMALL.rbf_low,
                      SMALL.rbf_high)
    gen = torch.Generator().manual_seed(5)
    n, F = g.atoms.shape[0], SMALL.atom_feature_size
    q, k = torch.randn((n, F), generator=gen), torch.randn((n, F), generator=gen)
    v, vec = torch.randn((n, 3 * F), generator=gen), torch.randn((n, 3, F), generator=gen)
    act = torch.nn.functional.silu
    whole = et.attention(params["mp"][0], q, k, v, vec, geo, 8, act)
    parts = et.attention(params["mp"][0], q, k, v, vec, geo, 8, act, block=37)
    for a, b in zip(whole, parts):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)


def test_published_widths_have_the_published_parameter_count():
    params = gnn.init_params(PUBLISHED, torch.Generator().manual_seed(0), device="cpu")
    assert gnn.count_params(params) == 6_507_914
    layer = params["mp"][0]
    assert layer["vec"].keys() == {"kernel"} and layer["dv"]["kernel"].shape == (64, 768)
    assert float(layer["norm"]["weight"].min()) == 1.0
    assert float(layer["norm"]["bias"].abs().max()) == 0
    assert "edge_fc" not in params and "filter" not in params


def test_heads_that_do_not_divide_the_features_raise(case):
    g, pos, _, _ = case
    with pytest.raises(ValueError, match="heads"):
        gnn.init_params(SMALL.replace(edge_feature_size=6), torch.Generator(), device="cpu")
    params = _params(SMALL)
    with pytest.raises(ValueError, match="heads"):
        _port(params, SMALL.replace(edge_feature_size=6), g, pos)


def test_calls_without_positions_and_unsupported_paths_raise(case):
    from nmrgnn_tpu_torch.parallel.mesh import Mesh
    from nmrgnn_tpu_torch.train.partitioned import PartitionedTrainer
    from nmrgnn_tpu_torch.train.trainer import Trainer

    g, pos, params, _ = case
    gt, post = _tensors(g, pos)
    with pytest.raises(ValueError, match="mp_type='et' needs the atoms' positions"):
        gnn.apply(params, SMALL, gt)
    with pytest.raises(ValueError, match="mp_type='et' serves inference only"):
        gnn.apply(params, SMALL, gt, positions=post, training=True)
    sm = ServingModel(params, SMALL, device="cpu")
    with pytest.raises(ValueError, match="mp_type='et' needs the atoms' positions"):
        sm.predict(g)
    with pytest.raises(ValueError, match="predict_frames does not serve mp_type='et'"):
        sm.predict_frames([g, g])
    with pytest.raises(ValueError, match="predict_trajectory does not serve mp_type='et'"):
        next(sm.predict_trajectory(None))
    mesh = Mesh(1, 2, {}, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="mp_type='et' is not served partitioned"):
        ServingModel(params, SMALL, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="Trainer does not train mp_type='et'"):
        Trainer(SMALL, device="cpu")
    with pytest.raises(ValueError, match="PartitionedTrainer does not train mp_type='et'"):
        PartitionedTrainer(SMALL, mesh=mesh, device="cpu")


def test_the_et_config_loads_in_the_jax_packages_model_config():
    j = jconfig.ModelConfig.from_json(PUBLISHED.to_json())
    assert j.to_json() == PUBLISHED.to_json()
    assert ModelConfig.from_json(j.to_json()) == PUBLISHED


def test_a_cpu_forward_launches_no_kernel(case):
    g, pos, params, want = case
    _cuda.reset_launch_counts()
    assert _gap(_port(params, SMALL, g, pos), want) <= TOL
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS)
