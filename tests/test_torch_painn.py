"""The port's PaiNN family (``mp_type="painn"``, ``ops/painn.py``,
``gnn.apply_painn``) against the plain reference ``tests/_painn_reference.py``
on the CPU, at 216 atoms, K = 24 slots and F = 32, on seeded random weights
with nonzero biases.

Tolerances, as ``peak_gap``: the widest gap of a peak over the largest
reference peak (131 ppm here; the standards put 0-150 ppm means on
outputs of about 0.4).
  * port against reference, 2e-5: the same float32 mathematics in another
    order (the filter's cutoff and bias folded into its product, the
    direction sum as one product), so float32 rounding alone. Measured
    1.2e-7, one float32 step of the largest peak; with the Dense
    products' operands in bfloat16 (a ``compute_dtype="bfloat16"``
    config) the same comparison reads 1.5e-4, so it fails
    (``test_the_tolerance_catches_bfloat16_products``).
  * a rotated and shifted structure against the structure, 2e-5: the
    peaks are invariant, and only float32 rounding of the moved
    coordinates and directions moves them. Measured 1.2e-7 on four
    rotations; bfloat16 products read 1.1e-4 to 1.5e-4 there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _painn_reference as ref
from nmrgnn_tpu import config as jconfig
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import painn

torch.set_num_threads(2)

PUBLISHED = ModelConfig(atom_feature_size=128, mp_layers=3, edge_hidden_size=20, rbf_high=0.5,
                        edge_fc_layers=1, fc_layers=1, mp_activation="silu",
                        fc_activation="silu", neighbor_number=80, mp_type="painn")
SMALL = PUBLISHED.replace(atom_feature_size=32, neighbor_number=24)
TOL = 2e-5       # port against reference (module docstring)
ROT_TOL = 2e-5   # rotated against unrotated (module docstring)


def _structure(seed=0, n_side=6, spacing=0.3, k=24):
    """(Graph of numpy arrays, positions f32[N, 3] nm): a jittered cubic
    lattice of 0.3 nm, so that each atom's 24 nearest slots reach past the
    0.5 nm cutoff; on even rows the slots past it are padding (index 0,
    distance 0), on odd rows they stay, where the cutoff gives them 0."""
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
    """init_params with every bias and the peak standards drawn too."""
    gen = torch.Generator().manual_seed(seed)
    params = gnn.init_params(config, gen, device="cpu")

    def fill(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "bias":
                    tree[k] = (torch.rand(v.shape, generator=gen) * 2 - 1) * 0.05
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


def _want(params, g, pos):
    gt, post = _tensors(g, pos)
    return ref.forward(params, dataclasses.asdict(SMALL), *gt[:3], post).numpy()


def _port(params, config, g, pos):
    gt, post = _tensors(g, pos)
    return gnn.apply(params, config, gt, positions=post).numpy()


def _gap(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def case():
    g, pos = _structure()
    params = _params(SMALL)
    return g, pos, params, _want(params, g, pos)


def test_the_structure_has_padding_and_slots_past_the_cutoff(case):
    g, pos, _, _ = case
    assert (g.edges == 0).any() and (g.edges >= SMALL.rbf_high).any()
    assert ((g.edges > 0) & (g.edges < SMALL.rbf_high)).sum(1).min() > 0


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


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return (q if np.linalg.det(q) > 0 else -q).astype(np.float32)


@pytest.mark.parametrize("seed", [3, 4])
def test_peaks_do_not_change_when_the_structure_rotates(case, seed):
    g, pos, params, _ = case
    rot = pos @ _rotation(seed).T + np.float32(0.7)
    a, b = _port(params, SMALL, g, pos), _port(params, SMALL, g, rot)
    assert _gap(b, a.astype(np.float64)) <= ROT_TOL


def test_padding_slots_add_nothing_and_stay_finite(case):
    g, pos, params, want = case
    # eight more padding slots an atom
    wide = Graph(g.atoms, np.pad(g.nlist, ((0, 0), (0, 8))), np.pad(g.edges, ((0, 0), (0, 8))),
                 g.inv_degree)
    got = ServingModel(params, SMALL, device="cpu").predict(wide, positions=pos)
    assert np.all(np.isfinite(got))
    assert _gap(got, want) <= TOL
    # atom 0 with every slot padding: each names atom 0 itself, at r_ij = 0
    lonely = Graph(g.atoms, g.nlist.copy(), g.edges.copy(), g.inv_degree)
    lonely.nlist[0], lonely.edges[0] = 0, 0.0
    got = _port(params, SMALL, lonely, pos)
    assert np.all(np.isfinite(got))
    assert _gap(got, _want(params, lonely, pos)) <= TOL


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


def test_published_widths_have_the_published_parameter_count():
    params = gnn.init_params(PUBLISHED, torch.Generator().manual_seed(0), device="cpu")
    assert gnn.count_params(params) == 578_122
    assert params["filter"]["kernel"].shape == (20, 3 * 3 * 128)
    assert params["mp"][0]["channel_mix"].keys() == {"kernel"}
    assert "edge_fc" not in params


def test_calls_without_positions_and_unsupported_paths_raise(case):
    from nmrgnn_tpu_torch.parallel.mesh import Mesh
    from nmrgnn_tpu_torch.train.partitioned import PartitionedTrainer
    from nmrgnn_tpu_torch.train.trainer import Trainer

    g, pos, params, _ = case
    gt, post = _tensors(g, pos)
    with pytest.raises(ValueError, match="positions"):
        gnn.apply(params, SMALL, gt)
    with pytest.raises(ValueError, match="inference only"):
        gnn.apply(params, SMALL, gt, positions=post, training=True)
    sm = ServingModel(params, SMALL, device="cpu")
    with pytest.raises(ValueError, match="positions"):
        sm.predict(g)
    with pytest.raises(ValueError, match="predict_frames does not serve mp_type='painn'"):
        sm.predict_frames([g, g])
    with pytest.raises(ValueError, match="predict_trajectory does not serve mp_type='painn'"):
        next(sm.predict_trajectory(None))
    mesh = Mesh(1, 2, {}, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="painn"):
        ServingModel(params, SMALL, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="Trainer does not train mp_type='painn'"):
        Trainer(SMALL, device="cpu")
    with pytest.raises(ValueError, match="PartitionedTrainer does not train mp_type='painn'"):
        PartitionedTrainer(SMALL, mesh=mesh, device="cpu")


def test_the_painn_config_loads_in_the_jax_packages_model_config():
    j = jconfig.ModelConfig.from_json(PUBLISHED.to_json())
    assert j.to_json() == PUBLISHED.to_json()
    assert ModelConfig.from_json(j.to_json()) == PUBLISHED


def _kernel_inputs(n=12, k=24, f=32, blocks=3, blk=1):
    """message's kernel arguments on the CPU: w the column slice of block
    ``blk`` of a [n, k, 3 blocks f] filter, taken in place."""
    gen = torch.Generator().manual_seed(0)
    filt = torch.randn((n, k, 3 * blocks * f), generator=gen)
    return dict(s=torch.randn((n, f), generator=gen), v=torch.randn((n, 3, f), generator=gen),
                ctx=torch.randn((n, 3 * f), generator=gen),
                w=filt[..., 3 * f * blk:3 * f * (blk + 1)],
                unit=torch.randn((n, k, 3), generator=gen),
                nlist=torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32),
                edges=torch.rand((n, k), generator=gen))


def test_kernel_args_take_a_strided_filter_slice_in_place():
    a = _kernel_inputs()
    assert painn.kernel_args(**a) == (12, 24, 32, 24 * 288, 288)
    assert painn.kernel_args(**_kernel_inputs(f=256, blocks=1, blk=0)) == (12, 24, 256,
                                                                            24 * 768, 768)


def _wrong(name):
    """One argument of ``_kernel_inputs`` that the kernel does not take."""
    a = _kernel_inputs()
    n, k, f = 12, 24, 32
    if name == "F not a multiple of 32":
        a = _kernel_inputs(f=48)
    elif name == "F past the kernel's":
        a = _kernel_inputs(f=288, blocks=1, blk=0)
    elif name == "int64 nlist":
        a["nlist"] = a["nlist"].long()
    elif name == "bfloat16 w":
        a["w"] = a["w"].to(torch.bfloat16)
    elif name == "w's last stride not 1":
        a["w"] = torch.randn(n, 3 * f, k).transpose(1, 2)
    elif name == "w not 16-byte aligned":
        a["w"] = torch.randn(n * k * 3 * f + 4)[1:1 + n * k * 3 * f].view(n, k, 3 * f)
    elif name == "w's slot stride not a multiple of 4":
        a["w"] = torch.randn(n, k, 3 * f + 2)[..., :3 * f]
    elif name == "v not contiguous":
        a["v"] = torch.randn(n, f, 3).transpose(1, 2)
    elif name == "ctx of 2F columns":
        a["ctx"] = a["ctx"][:, :2 * f].contiguous()
    elif name == "unit of another K":
        a["unit"] = torch.randn(n, k + 1, 3)
    elif name == "edges on another device":
        a["edges"] = torch.empty((n, k), device="meta")
    return a


@pytest.mark.parametrize("name,error", [
    ("F not a multiple of 32", ValueError), ("F past the kernel's", ValueError),
    ("int64 nlist", TypeError), ("bfloat16 w", TypeError), ("w's last stride not 1", ValueError),
    ("w not 16-byte aligned", ValueError), ("w's slot stride not a multiple of 4", ValueError),
    ("v not contiguous", ValueError), ("ctx of 2F columns", ValueError),
    ("unit of another K", ValueError), ("edges on another device", ValueError),
])
def test_kernel_args_refuse_what_the_kernel_does_not_take(name, error):
    with pytest.raises(error):
        painn.kernel_args(**_wrong(name))


def test_a_cpu_forward_takes_the_plain_message(case):
    g, pos, params, want = case
    before = painn.message.launches
    assert _gap(_port(params, SMALL, g, pos), want) <= TOL
    assert painn.message.launches == before
