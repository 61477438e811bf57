"""The port's serving path end to end on the CPU against the JAX package,
its data layer against the JAX package's, and the port's import and
device rules."""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.data import pdb as jpdb
from nmrgnn_tpu.data.parse import inv_degree_np
from nmrgnn_tpu.data import reorder as jreorder
from nmrgnn_tpu.data.neighbors import neighbors_host as jneighbors_host
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.models import gnn as jgnn
from nmrgnn_tpu.models.infer import apply_banded as japply_banded
from nmrgnn_tpu.models.infer import precompute_band as jprecompute_band
from nmrgnn_tpu_torch.data import pdb as tpdb
from nmrgnn_tpu_torch.data import reorder as treorder
from nmrgnn_tpu_torch.data.embeddings import ELEMENTS
from nmrgnn_tpu_torch.data.parse import structure2graph
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.library import check_peaks, load_model, universe2graph
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.infer import apply_banded, precompute_band
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import banded
from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import write_synthetic_pdb  # noqa: E402


@pytest.fixture(scope="module")
def bundled():
    jparams, jcfg = jload_model()
    params, cfg = load_model(device="cpu")
    return jparams, jcfg, params, cfg


@pytest.fixture(scope="module")
def structure(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pdb") / "synthetic.pdb")
    write_synthetic_pdb(path, n_atoms=400, seed=1, frames=3)
    return path


def test_synthetic_pdb_is_protein_like(structure):
    s = tpdb.read_structure(structure)
    assert s.coords.shape == (3, 400, 3)
    counts = {e: s.elements.count(e) for e in set(s.elements)}
    assert set(counts) <= {"H", "C", "N", "O", "S"}
    assert 0.35 < counts["H"] / 400 < 0.65 and 0.2 < counts["C"] / 400 < 0.45
    # listed in chain-like order: consecutive atoms are mostly lattice neighbors
    steps = np.linalg.norm(np.diff(s.coords[0], axis=0), axis=1)
    assert np.median(steps) < 2.0
    motion = np.abs(s.coords[1] - s.coords[0])
    assert 0.01 < motion.mean() < 0.1


def test_pdb_reader_matches_jax(structure):
    got, want = tpdb.read_structure(structure), jpdb.read_structure(structure)
    np.testing.assert_array_equal(got.coords, want.coords)
    assert (got.elements, got.names, got.resnames, got.chains) == (
        want.elements, want.names, want.resnames, want.chains)
    np.testing.assert_array_equal(got.resids, want.resids)


def test_graph_and_reorder_match_jax(structure):
    s = tpdb.read_structure(structure)
    g = universe2graph(structure)
    nlist, dists = jneighbors_host(s.coords[0], 16, use_native=False)
    np.testing.assert_array_equal(g.nlist, nlist)
    np.testing.assert_allclose(g.edges, dists * 0.1, rtol=1e-6)
    assert g.atoms.shape == (400, len(ELEMENTS))
    np.testing.assert_array_equal(g.inv_degree, inv_degree_np(nlist))
    order = treorder.rcm_order(g.nlist, g.edges)
    np.testing.assert_array_equal(order, jreorder.rcm_order(g.nlist, g.edges))
    for pin in (False, True):
        got, inv = treorder.permute_graph(g, order, pin_zero=pin)
        want, jinv = jreorder.permute_graph(JGraph(*g), order, pin_zero=pin)
        np.testing.assert_array_equal(inv, jinv)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    # inv_degree is carried through the permutation, never recomputed
    got, _ = treorder.permute_graph(g, order, pin_zero=False)
    np.testing.assert_array_equal(got.inv_degree, g.inv_degree[order])


def test_serving_predict_matches_jax(structure, bundled):
    jparams, jcfg, params, cfg = bundled
    s = tpdb.read_structure(structure)
    graphs = [structure2graph(s, frame=f) for f in range(3)]
    model = ServingModel(params, cfg, device="cpu")
    for f, g in enumerate(graphs):
        got = model.predict(g)
        want = np.asarray(jgnn.apply(jparams, jcfg, JGraph(*map(jnp.asarray, g))))
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4, err_msg=f"frame {f}")
        if f == 0:
            # the JAX package's banded forward on the same RCM graph
            gp, inv = jreorder.permute_graph(JGraph(*g), model._order, pin_zero=False)
            gj = JGraph(*map(jnp.asarray, gp))
            jb = np.asarray(japply_banded(jparams, jcfg, gj, jprecompute_band(gj),
                                          use_pallas=False))[inv]
            np.testing.assert_allclose(got, jb, rtol=5e-4, atol=5e-4)
    plan = model._plan
    assert banded.plan_covers(plan, *treorder.permute_graph(
        graphs[2], model._order, pin_zero=False)[0][1:3])
    model.predict(graphs[2])
    assert model._plan is plan  # a covered frame reuses the plan
    assert not np.array_equal(model.predict(graphs[0]), model.predict(graphs[1]))


def test_apply_banded_branches_agree(structure, bundled):
    _, _, params, cfg = bundled
    g = universe2graph(structure)
    order = treorder.rcm_order(g.nlist, g.edges)
    gp, _ = treorder.permute_graph(g, order, pin_zero=False)
    plan = precompute_band(gp)
    gt = Graph(*map(torch.from_numpy, gp))
    # the Chebyshev edge stage in float32 serves too (the fast precision's)
    cheb = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                              rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation,
                              degree=64)
    with torch.no_grad():
        ref = gnn.apply(params, cfg, gt)
        for kw in ({}, {"fused_edge": False}, {"use_kernels": False}, {"cheb": cheb},
                   {"cheb": cheb, "use_kernels": False}, {"hbm_table": True},
                   {"hbm_table": True, "cheb": cheb}):
            torch.testing.assert_close(apply_banded(params, cfg, gt, plan, **kw), ref,
                                       rtol=5e-4, atol=5e-4)
        # fused_first: the fused Chebyshev build + layer 1 with cheb, else
        # ignored (the serial forward's bits), as in the JAX package
        torch.testing.assert_close(apply_banded(params, cfg, gt, plan, cheb=cheb,
                                                fused_first=True), ref, rtol=5e-4, atol=5e-4)
        assert torch.equal(apply_banded(params, cfg, gt, plan, fused_first=True),
                           apply_banded(params, cfg, gt, plan))
        # the fused exact edge stage serves a bfloat16 config too
        # (tests/test_torch_exact_bf16.py holds it against the JAX package)
        bf16 = apply_banded(params, cfg.replace(compute_dtype="bfloat16"), gt, plan)
    assert bf16.dtype == torch.float32 and bool(torch.isfinite(bf16).all())


def test_serving_rejects_later_slices(bundled):
    _, _, params, cfg = bundled
    # "fast" now serves, in bfloat16 (tests/test_torch_fast_serving.py)
    fast = ServingModel(params, cfg, device="cpu", precision="fast")
    assert fast.config.compute_dtype == "bfloat16" and cfg.compute_dtype == "float32"
    # "blocksparse" now serves (tests/test_torch_blocksparse.py); an unknown
    # mode raises, as in the JAX package
    assert ServingModel(params, cfg, device="cpu", mode="blocksparse").mode == "blocksparse"
    with pytest.raises(ValueError, match="unknown serving mode"):
        ServingModel(params, cfg, device="cpu", mode="gather")
    # the attention family now serves (tests/test_torch_attention_serving.py)
    acfg = cfg.replace(mp_type="attention")
    aparams = gnn.init_params(acfg, torch.Generator().manual_seed(0), device="cpu")
    assert ServingModel(aparams, acfg, device="cpu").config.mp_type == "attention"
    # exact serving keeps a bfloat16 config's compute type, as the JAX
    # package does (tests/test_torch_exact_bf16.py)
    exact16 = ServingModel(params, cfg.replace(compute_dtype="bfloat16"), device="cpu")
    assert exact16.precision == "exact" and exact16.config.compute_dtype == "bfloat16"
    with pytest.raises(ValueError):
        ServingModel(params, cfg, device="cpu", precision="half")


def test_serving_defaults_to_the_card(bundled):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, params, cfg = bundled
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ServingModel(params, cfg)


def test_check_peaks(structure, bundled):
    _, _, params, cfg = bundled
    g = universe2graph(structure)
    std = {2: 126.0, 3: 118.955, 4: 5.63}
    peaks = np.array([std.get(int(i), 0.0) for i in g.atoms.argmax(-1)], np.float32)
    conf = check_peaks(g.atoms, peaks)
    assert conf.shape == (400,) and conf.dtype == bool
    with pytest.raises(Warning):
        check_peaks(g.atoms, peaks + 1000.0)


FORBIDDEN = ("jax", "jaxlib", "flax", "nmrgnn_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_sources():
    pkg = os.path.join(REPO, "nmrgnn_tpu_torch")
    for root, _, files in os.walk(pkg):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_or_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 15
    for path in sources:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_importing_serving_loads_no_jax():
    code = ("import sys; import nmrgnn_tpu_torch.models.serving, nmrgnn_tpu_torch.library; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
