"""Atom-partitioned serving of the port (``nmrgnn_tpu_torch/parallel/``,
``ServingModel(mesh=...)``, ``eval-struct --graph-parallel``) on the CPU
against the JAX package, on synthetic banded graphs (``nlist = i +
randint(-40, 40)``, padding slots naming row 0) at F = 32, H = 16 and 2 MP
layers.

Host only: the halo plans, ``pad_to_multiple``, ``halo_comm_report`` and
``banded_layer_flops`` equal the JAX package's at D in {2, 4, 8}, with
``like=`` and ``PlanShapeMismatch``; the path rule (``_resolve_mode``,
``_partitioned_fits_vmem``) over a grid of sizes and configs.

Spawned: the port's forwards on D = 2 and D = 4 gloo ranks (one process
each, ``tests/_torch_parallel_worker.py``, a ``file://`` rendezvous under
tmp_path) while this process computes the JAX references (Pallas in
interpret mode on a mesh of D of the 8 host devices ``tests/conftest.py``
forces). Tolerance rtol/atol 2e-4 (float32 sums in another order); the
Chebyshev path within 2e-4 of the port's own single-card ``cheb`` forward,
as ``tests/test_halo.py`` holds the JAX package's. Attention: against the
JAX package's partitioned forward in the identity order (padding slots name
row 0, where its row-0 form and ``gnn.apply`` agree) and against JAX
``gnn.apply`` on an RCM-reordered graph (the port's form). And ``eval-struct
--graph-parallel 2 --device cpu`` under ``torchrun``, whose CSV equals the
single-process command's."""
import csv
import os
import subprocess
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
from nmrgnn_tpu.models import gnn as jgnn
from nmrgnn_tpu.models.serving import ServingModel as JServingModel
from nmrgnn_tpu.parallel import apply_partitioned_banded as japply_banded
from nmrgnn_tpu.parallel import apply_partitioned_halo as japply_halo
from nmrgnn_tpu.parallel import make_banded_halo_plan as jmake_banded
from nmrgnn_tpu.parallel import make_halo_plan as jmake_halo
from nmrgnn_tpu.parallel import make_mesh as jmake_mesh
from nmrgnn_tpu.parallel import pad_to_multiple as jpad
from nmrgnn_tpu.parallel.comm import banded_layer_flops as jflops
from nmrgnn_tpu.parallel.comm import halo_comm_report as jreport
from nmrgnn_tpu.parallel.halo import PlanShapeMismatch as JPlanShapeMismatch
from nmrgnn_tpu_torch import cli
from nmrgnn_tpu_torch import parallel as par
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import params_from_numpy, save_model
from nmrgnn_tpu_torch.models.infer import apply_banded, precompute_band
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)
import _torch_parallel_worker as worker  # noqa: E402
from chip_smoke import write_synthetic_pdb  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(atom_feature_size=32, edge_hidden_size=16, mp_layers=2, fc_layers=3,
             edge_fc_layers=3, dropout=False, noise=0.0)
TOL = dict(rtol=2e-4, atol=2e-4)


def banded_graph(n=1000, k=16, seed=0):
    """A banded graph with 10% padding slots, which name row 0."""
    rng = np.random.default_rng(seed)
    nl = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    d = rng.uniform(0.1, 0.3, (n, k)).astype(np.float32)
    pad = rng.uniform(size=(n, k)) < 0.1
    d[pad] = 0.0
    nl = np.where(pad, 0, nl).astype(np.int32)
    atoms = np.eye(10, dtype=np.float32)[rng.choice([0, 1, 2, 3, 4], n)]
    return Graph(atoms, nl, d, inv_degree_from_nlist(nl))


def jax_params(cfg_kw, seed=0):
    jp = jinit_params(jax.random.PRNGKey(seed), JModelConfig(**cfg_kw), load_standards())
    return jax.tree_util.tree_map(np.asarray, jp)


# -- host only --------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4, 8])
def test_plans_and_reports_equal_jax(D):
    g = banded_graph()
    gp = par.pad_to_multiple(g, D * 128)
    jg = jpad(JGraph(*[jnp.asarray(a) for a in g]), D * 128)
    for a, b in zip(gp, jg):
        np.testing.assert_array_equal(a, np.asarray(b))
    t_gp = par.pad_to_multiple(Graph(*[torch.as_tensor(a) for a in g]), D * 128)
    for a, b in zip(t_gp, gp):
        np.testing.assert_array_equal(a.numpy(), b)
    for mult in (8, 128):
        hp, jhp = (par.make_halo_plan(gp.nlist, D, halo_multiple=mult, edges=gp.edges),
                   jmake_halo(gp.nlist, D, halo_multiple=mult, edges=gp.edges))
        assert hp.offsets == jhp.offsets and hp.halo_sizes == jhp.halo_sizes
        assert (hp.n_shards, hp.rows_per_shard, hp.halo_rows, hp.workspace_rows) == (
            jhp.n_shards, jhp.rows_per_shard, jhp.halo_rows, jhp.workspace_rows)
        np.testing.assert_array_equal(hp.local_nlist, jhp.local_nlist)
        for a, b in zip(hp.send_idx, jhp.send_idx):
            np.testing.assert_array_equal(a, b)
        for F, b in ((32, 4), (256, 2)):
            assert par.halo_comm_report(hp, F, b).as_dict() == jreport(jhp, F, b).as_dict()
    plan, jplan = par.make_banded_halo_plan(gp.nlist, gp.edges, D), jmake_banded(
        gp.nlist, gp.edges, D)
    for f in ("lo", "boundary_ids", "halo_lo"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    assert (plan.window, plan.halo_window, plan.block_rows, plan.halo_lanes,
            plan.num_tiles, plan.num_boundary_tiles) == (
        jplan.window, jplan.halo_window, jplan.block_rows, jplan.halo_lanes,
        jplan.num_tiles, jplan.num_boundary_tiles)
    for E in (1, 3):
        assert par.banded_layer_flops(plan, 32, E) == jflops(jplan, 32, E)
    # a later frame through the first one's envelope, and one that escapes it
    rng = np.random.default_rng(D)
    moved = gp.nlist.copy()
    moved[:, :4] = np.clip(moved[:, :4] + rng.integers(-2, 3, (moved.shape[0], 4)), 0,
                           moved.shape[0] - 1)
    like = par.make_banded_halo_plan(moved, gp.edges, D, like=plan)
    jlike = jmake_banded(moved, gp.edges, D, like=jplan)
    np.testing.assert_array_equal(like.halo.local_nlist, jlike.halo.local_nlist)
    assert like.window == plan.window and like.halo.offsets == plan.halo.offsets
    far = gp.nlist.copy()
    far[:, 0] = (np.arange(far.shape[0]) + far.shape[0] // 2) % far.shape[0]
    with pytest.raises(par.PlanShapeMismatch):
        par.make_banded_halo_plan(far, gp.edges, D, like=plan)
    with pytest.raises(JPlanShapeMismatch):
        jmake_banded(far, gp.edges, D, like=jplan)
    assert par.best_factorization(D * 3) == (D * 3 // _even(D * 3), _even(D * 3))


def _even(n):
    return max(g for g in range(1, int(n ** 0.5) + 1) if n % g == 0)


@pytest.mark.parametrize("kw", [
    dict(), dict(atom_feature_size=768, edge_feature_size=1),
    dict(atom_feature_size=512, edge_feature_size=8), dict(mp_type="attention"),
    dict(atom_feature_size=1024, mp_type="attention"),
])
def test_path_rule_equals_jax(kw):
    """``_resolve_mode`` ("partitioned" first whenever the partition axis
    has more than one rank, as in the JAX package) and
    ``_partitioned_fits_vmem`` equal the JAX package's over sizes,
    precisions and shard counts."""
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    jp = jax_params(kw)
    params = params_from_numpy(jp, device="cpu")
    for n, spread in ((1000, 40), (12000, 150)):
        rng = np.random.default_rng(n)
        nl = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread, (n, 16)), 0, n - 1)
        d = rng.uniform(0.1, 0.3, (n, 16)).astype(np.float32)
        g = Graph(np.zeros((n, 10), np.float32), nl.astype(np.int32), d,
                  inv_degree_from_nlist(nl))
        for D in (1, 2, 4):
            mesh = par.Mesh(8 // D, D, {}, 0, torch.device("cpu"))
            jmesh = jmake_mesh(data=8 // D, graph=D)
            for precision in ("exact", "fast"):
                sm = ServingModel(params, cfg, device="cpu", reorder=False,
                                  precision=precision, mesh=mesh)
                jsm = JServingModel(jp, jcfg, use_pallas=True, reorder=False,
                                    precision=precision, mesh=jmesh)
                assert sm._resolve_mode(g) == jsm._resolve_mode(JGraph(*g)), (n, D)
                if D > 1:
                    gp = par.pad_to_multiple(g, D * 128)
                    plan = par.make_banded_halo_plan(gp.nlist, gp.edges, D)
                    assert sm._partitioned_fits_vmem(plan) == jsm._partitioned_fits_vmem(
                        jmake_banded(gp.nlist, gp.edges, D)), (n, D, precision)


def test_training_flags_raise():
    """Training through the partitioned forward is ported: what still
    raises is the JAX package's refusal of ``cheb`` (the compressed edge
    stage, inference only) with gradients or training draws or the
    attention family, and a forward with no process group running."""
    cfg = ModelConfig(**SMALL)
    params = params_from_numpy(jax_params(SMALL), device="cpu")
    g = par.pad_to_multiple(banded_graph(300), 256)
    plan = par.make_banded_halo_plan(g.nlist, g.edges, 2)
    mesh = par.Mesh(1, 2, {}, 0, torch.device("cpu"))
    cheb = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                              rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation,
                              degree=8)
    for kw in (dict(differentiable=True), dict(training=True)):
        with pytest.raises(ValueError, match="inference-only"):
            par.apply_partitioned_banded(params, cfg, g, plan, mesh, cheb=cheb, **kw)
    with pytest.raises(ValueError, match="bilinear"):
        par.apply_partitioned_banded(params, ModelConfig(**SMALL, mp_type="attention"), g,
                                     plan, mesh, cheb=cheb)
    for kw in (dict(), dict(differentiable=True), dict(training=True, rng=0)):
        with pytest.raises(ValueError, match="process group"):
            par.apply_partitioned_banded(params, cfg, g, plan, mesh, **kw)


# -- spawned ranks against the JAX package --------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results at D = 2 and D = 4 and the references, computed
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("parallel")
    attn_kw = dict(SMALL, mp_type="attention")
    jp = {"bilinear": jax_params(SMALL), "attention": jax_params(attn_kw, seed=1)}
    g = banded_graph()
    order = rcm_order(g.nlist, g.edges)
    g_rcm, _ = permute_graph(g, order, pin_zero=False)
    cheb = fit_edge_chebyshev(
        params_from_numpy(jp["bilinear"], device="cpu")["edge_fc"], rbf_low=0.0, rbf_high=0.5,
        rbf_count=16, activation="softplus", degree=64)
    case = {
        "configs": {"bilinear": SMALL, "attention": attn_kw},
        "params": jp,
        "graphs": {"band": tuple(g), "rcm": tuple(g_rcm)},
        "timeout_s": 120,
    }
    tasks = {
        2: [dict(kind="banded", model="bilinear", graph="band"),
            dict(kind="banded", model="bilinear", graph="band",
                 cheb=(np.asarray(cheb.coeffs), cheb.d_lo, cheb.d_hi)),
            dict(kind="banded", model="attention", graph="band"),
            dict(kind="banded", model="attention", graph="rcm"),
            dict(kind="halo", model="bilinear", graph="band"),
            dict(kind="halo", model="attention", graph="band"),
            dict(kind="v1", model="bilinear", graph="band"),
            dict(kind="serving", model="bilinear", graph="band", repeat=2)],
        4: [dict(kind="banded", model="bilinear", graph="band"),
            dict(kind="banded", model="attention", graph="band"),
            dict(kind="banded", model="attention", graph="rcm"),
            dict(kind="halo", model="bilinear", graph="band"),
            dict(kind="halo", model="attention", graph="band")],
    }
    joins = {D: worker.spawn(D, dict(case, tasks=tasks[D]), tmp)[1] for D in (2, 4)}
    # the references, while the ranks run
    ref = {}
    n = g.atoms.shape[0]
    jg = jpad(JGraph(*[jnp.asarray(a) for a in g]), 256)
    jcfg = JModelConfig(**SMALL)
    plan2 = jmake_banded(np.asarray(jg.nlist), np.asarray(jg.edges), 2)
    ref["banded"] = np.asarray(japply_banded(jp["bilinear"], jcfg, jg, plan2,
                                             jmake_mesh(data=4, graph=2), interpret=True))[:n]
    jacfg = JModelConfig(**attn_kw)
    hplan4 = jmake_halo(np.asarray(jg.nlist), 4, edges=np.asarray(jg.edges))
    ref["attention"] = np.asarray(japply_halo(jp["attention"], jacfg, jg, hplan4,
                                              jmake_mesh(data=2, graph=4)))[:n]
    ref["attention_rcm"] = np.asarray(jax.jit(lambda p, gg: jgnn.apply(p, jacfg, gg))(
        jp["attention"], JGraph(*[jnp.asarray(a) for a in g_rcm])))
    tp = params_from_numpy(jp["bilinear"], device="cpu")
    gp = par.pad_to_multiple(Graph(*[torch.as_tensor(a) for a in g]), 256)
    ref["cheb"] = apply_banded(tp, ModelConfig(**SMALL), gp,
                               precompute_band(Graph(*[a.numpy() for a in gp])),
                               cheb=cheb).numpy()[:n]
    ref["serving_jax"] = JServingModel(jp["bilinear"], jcfg,
                                       mesh=jmake_mesh(data=4, graph=2)).predict(JGraph(*g))
    ref["serving_port"] = ServingModel(tp, ModelConfig(**SMALL), device="cpu").predict(g)
    out = {D: join() for D, join in joins.items()}
    return out, tasks, ref, n


def _rank_peaks(out, D, i):
    """Task i's peaks of every rank, which must all hold the whole [N]."""
    peaks = [r[i]["peaks"] for r in out[D]]
    for p in peaks[1:]:
        np.testing.assert_array_equal(p, peaks[0])
    return peaks[0]


@pytest.mark.parametrize("D", [2, 4])
def test_partitioned_banded_matches_jax(runs, D):
    out, _, ref, n = runs
    np.testing.assert_allclose(_rank_peaks(out, D, 0)[:n], ref["banded"], **TOL)


def test_partitioned_banded_cheb_matches_single_card_fast(runs):
    out, _, ref, n = runs
    np.testing.assert_allclose(_rank_peaks(out, 2, 1)[:n], ref["cheb"], **TOL)


@pytest.mark.parametrize("D,i", [(2, 2), (4, 1)])
def test_partitioned_banded_attention_matches_jax(runs, D, i):
    """Identity order: the padding slots name row 0, where the JAX
    package's row-0 form and the port's gnn.apply form agree."""
    out, _, ref, n = runs
    np.testing.assert_allclose(_rank_peaks(out, D, i)[:n], ref["attention"], **TOL)


@pytest.mark.parametrize("D,i", [(2, 3), (4, 2)])
def test_partitioned_attention_on_a_reordered_graph_matches_gnn_apply(runs, D, i):
    """After RCM the padding slots name the old row 0's new place, held on
    one shard: the port's padding term follows JAX ``gnn.apply``."""
    out, _, ref, n = runs
    np.testing.assert_allclose(_rank_peaks(out, D, i)[:n], ref["attention_rcm"], **TOL)


@pytest.mark.parametrize("D,i,family", [(2, 4, "banded"), (2, 5, "attention"),
                                        (4, 3, "banded"), (4, 4, "attention")])
def test_partitioned_halo_matches_jax(runs, D, i, family):
    out, _, ref, n = runs
    np.testing.assert_allclose(_rank_peaks(out, D, i)[:n], ref[family], **TOL)


def test_partitioned_allgather_matches_jax(runs):
    out, _, ref, n = runs
    np.testing.assert_allclose(_rank_peaks(out, 2, 6)[:n], ref["banded"], **TOL)


def test_serving_model_on_a_mesh_matches_jax(runs):
    """ServingModel(mesh=...) on 2 ranks: "partitioned" through the kernel
    path, the RCM order undone, every rank the whole peaks, a second call
    through the cached plan equal to the first; against the JAX
    ServingModel on a mesh and the port's single-device model."""
    out, _, ref, _ = runs
    res = [r[7] for r in out[2]]
    assert all(r["mode"] == "partitioned" and r["banded"] and r["same"] for r in res)
    peaks = _rank_peaks(out, 2, 7)
    np.testing.assert_allclose(peaks, ref["serving_jax"], **TOL)
    np.testing.assert_allclose(peaks, ref["serving_port"], **TOL)


# -- the CLI ----------------------------------------------------------------------------


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_eval_struct_graph_parallel_under_torchrun(tmp_path, capsys):
    """``eval-struct --graph-parallel 2 --device cpu`` under torchrun: rank
    0 writes the CSV, equal to the single-process command's (the same
    rows; peaks, rounded to 0.01, within one rounding step). Without
    torchrun N > 1 is a usage error that names it."""
    pdb = str(tmp_path / "s.pdb")
    write_synthetic_pdb(pdb, n_atoms=300, seed=3)
    model = str(tmp_path / "model")
    cfg = ModelConfig(**SMALL)
    save_model(model, params_from_numpy(jax_params(SMALL), device="cpu"), cfg)
    single, multi = str(tmp_path / "single.csv"), str(tmp_path / "multi.csv")
    with pytest.raises(SystemExit) as e:
        cli.main(["eval-struct", pdb, multi, "--model-file", model, "--graph-parallel", "2",
                  "--device", "cpu"])
    assert e.value.code == 2 and "torchrun" in capsys.readouterr().err
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "nmrgnn_tpu_torch.cli", "eval-struct", pdb, multi, "--model-file", model,
         "--graph-parallel", "2", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "graph-parallel serving: mesh {'data': 1, 'graph': 2}" in r.stdout
    assert "backend gloo" in r.stderr
    assert cli.main(["eval-struct", pdb, single, "--model-file", model, "--device",
                     "cpu"]) == 0
    a, b = _read(single), _read(multi)
    assert len(a) == len(b) == 301
    for x, y in zip(a, b):
        assert x[:4] + x[5:] == y[:4] + y[5:]
    pa = np.array([float(x[4]) for x in a[1:]])
    pb = np.array([float(x[4]) for x in b[1:]])
    assert np.abs(pa - pb).max() <= 0.01 + 1e-6
