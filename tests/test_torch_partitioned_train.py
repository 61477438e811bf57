"""Partitioned and multi-GPU training of the port
(``nmrgnn_tpu_torch/parallel/halo.py``'s training half,
``parallel/sharding.py``, ``train/partitioned.py``, ``Trainer(mesh=)``) on
the CPU against the JAX package, at F = 32, H = 16 and 2 MP layers.

The port's ranks are gloo processes (``tests/_torch_parallel_worker.py``):
one spawn of 2 ranks and one of 4 carry every task (each task on its own
(data, graph) mesh), while this process computes the JAX references on
meshes of the 8 host devices ``tests/conftest.py`` forces (Pallas in
interpret mode). Graphs are synthetic banded ones (``nlist = i +
randint(-40, 40)``, padding slots naming row 0).

Tolerances are the JAX package's own for these paths: loss rtol 1e-5,
parameters and gradients rtol 2e-3 / atol 2e-5 (``tests/test_halo.py``);
the data- and tensor-parallel steps and the Trainer on a mesh loss rtol
1e-4, parameters rtol 1e-4 / atol 1e-5 (``tests/test_parallel.py``)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nmrgnn_tpu import ModelConfig as JModelConfig
from nmrgnn_tpu import init_params as jinit_params
from nmrgnn_tpu.config import TrainConfig as JTrainConfig
from nmrgnn_tpu.data.dataset import Sample as JSample
from nmrgnn_tpu.data.embeddings import load_embeddings, load_standards
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.models import gnn as jgnn
from nmrgnn_tpu.parallel import apply_partitioned_banded as japply_banded
from nmrgnn_tpu.parallel import make_banded_halo_plan as jmake_banded
from nmrgnn_tpu.parallel import make_mesh as jmake_mesh
from nmrgnn_tpu.parallel import make_parallel_train_step as jmake_parallel_step
from nmrgnn_tpu.parallel import make_partitioned_train_step as jmake_step
from nmrgnn_tpu.parallel import param_specs as jparam_specs
from nmrgnn_tpu.parallel import shard_batch as jshard_batch
from nmrgnn_tpu.train.losses import name_loss as jname_loss
from nmrgnn_tpu.train.metrics import type_mask
from nmrgnn_tpu.train.partitioned import PartitionedTrainer as JPartitionedTrainer
from nmrgnn_tpu.train.trainer import TrainState as JTrainState
from nmrgnn_tpu.train.trainer import Trainer as JTrainer
from nmrgnn_tpu.train.trainer import fold_sample_weight as jfold
from nmrgnn_tpu_torch import parallel as par
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import params_from_numpy
from nmrgnn_tpu_torch.models import gnn

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)
import _torch_parallel_worker as worker  # noqa: E402
from chip_smoke import write_synthetic_pdb  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(atom_feature_size=32, edge_hidden_size=16, mp_layers=2, fc_layers=3,
             edge_fc_layers=3, dropout=False, noise=0.0)
ATTN = dict(SMALL, mp_type="attention")
# the data-parallel Trainer's banded path takes F and pad_to multiples of 128
WIDE = dict(SMALL, atom_feature_size=128)
FIT = dict(SMALL, learning_rate=3e-3)
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
DP_LOSS_TOL = dict(rtol=1e-4)
DP_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
LOSS_IDX = tuple(type_mask(r".*", load_embeddings(), regex=True))


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


def labels(atoms, seed):
    r = np.random.default_rng(seed)
    n = atoms.shape[0]
    y = np.stack([r.normal(size=n).astype(np.float32) * 3,
                  r.integers(0, 6, n).astype(np.float32), np.ones(n, np.float32)], -1)
    return y, (atoms.sum(-1) > 0).astype(np.float32)


def frames(seed, n=296, k=8, count=3):
    """Same-topology frames of a banded structure (``tests/test_halo.py``'s
    ``_synthetic_frames``): (graph, y, w) each."""
    rng = np.random.default_rng(seed)
    nl = np.clip(np.arange(n)[:, None] + rng.integers(-25, 25, (n, k)), 0, n - 1)
    nl = nl.astype(np.int32)
    base = rng.uniform(0.02, 0.19, (n, k)).astype(np.float32)
    atoms = np.eye(10, dtype=np.float32)[rng.integers(2, 5, n)]
    inv = inv_degree_from_nlist(nl)
    out = []
    for f in range(count):
        y = np.stack([rng.normal(size=n).astype(np.float32) * 3,
                      rng.integers(0, 6, n).astype(np.float32), np.ones(n, np.float32)], -1)
        out.append((Graph(atoms, nl, base * (1.0 + 0.02 * f), inv), y, np.ones(n, np.float32)))
    return out


def fragment_batch(count=16, n=64, k=16, seed=3):
    """Padded fragments (graph, y, w) of banded graphs, ``count`` of them."""
    out = []
    for i in range(count):
        rng = np.random.default_rng(seed + i)
        m = int(rng.integers(40, n + 1))
        g = banded_graph(m, k, seed + i)
        y, w = labels(g.atoms, seed + 100 + i)
        p = n - m
        out.append((Graph(np.pad(g.atoms, ((0, p), (0, 0))), np.pad(g.nlist, ((0, p), (0, 0))),
                          np.pad(g.edges, ((0, p), (0, 0))), np.pad(g.inv_degree, (0, p))),
                    np.pad(y, ((0, p), (0, 0))), np.pad(w, (0, p))))
    return out


def jax_params(cfg_kw, seed=0):
    jp = jinit_params(jax.random.PRNGKey(seed), JModelConfig(**cfg_kw), load_standards())
    return jax.tree_util.tree_map(np.asarray, jp)


def flat(tree, prefix=""):
    """{path: array} of a params tree (dicts and lists), peak_* dropped."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() if k not in ("peak_std", "peak_avg")
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def assert_trees(got, want, tol):
    got, want = flat(got), flat(want)
    assert set(got) == set(want) and len(got) >= 10
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def jg(g):
    return JGraph(*[jnp.asarray(a) for a in g])


# -- host only ----------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("kw", [SMALL, ATTN])
def test_param_specs_equal_jax(tp, kw):
    """``param_specs``: the port's specs are the JAX package's, leaf for
    leaf (mp w on dim 0 and the square FC kernels with ``tp``)."""
    jp = jax_params(kw)
    jspecs = jparam_specs(jp, tp)
    specs = par.param_specs(params_from_numpy(jp, device="cpu"), tp)
    leaves = jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    n_split = 0
    for path, js in leaves:
        node = specs
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(node) == tuple(js), (jax.tree_util.keystr(path), node, js)
        n_split += bool(tuple(js))
    assert n_split == (0 if not tp else
                       (kw["mp_layers"] if kw.get("mp_type") != "attention" else 0)
                       + kw["fc_layers"] - 1)
    assert tuple(par.batch_spec()) == (("data",),) * 4


def test_trainer_refusals():
    """A PartitionedTrainer needs a mesh; a Trainer on a mesh refuses a
    batch that does not split over its data axis (as the JAX Trainer's
    fit) and the banded path with tensor parallelism."""
    from nmrgnn_tpu_torch.config import TrainConfig
    from nmrgnn_tpu_torch.train import PartitionedTrainer, Trainer

    cfg = ModelConfig(**SMALL)
    with pytest.raises(ValueError, match="requires a mesh"):
        PartitionedTrainer(cfg)
    mesh = par.Mesh(3, 1, {}, 0, torch.device("cpu"))
    tr = Trainer(cfg, TrainConfig(batch_size=8, pad_to=64, mp_path="gather"), device="cpu",
                 mesh=mesh)
    sample = [(g, y, w) for g, y, w in fragment_batch(2)]
    from nmrgnn_tpu_torch.data.dataset import Sample

    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        tr.fit([Sample(*x) for x in sample], [], verbose=False)
    with pytest.raises(ValueError, match="no tensor parallelism"):
        Trainer(ModelConfig(atom_feature_size=128), TrainConfig(mp_path="banded"),
                device="cpu", mesh=par.Mesh(1, 2, {}, 0, torch.device("cpu")),
                tensor_parallel=True)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_partitioned_trainer_defaults_to_the_card():
    """A PartitionedTrainer on a mesh without a card raises unless the
    caller asks for the CPU, as every entry point of the port."""
    from nmrgnn_tpu_torch.train import PartitionedTrainer

    cfg = ModelConfig(**SMALL)
    mesh = par.Mesh(1, 1, {}, 0, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartitionedTrainer(cfg, mesh=mesh)
    assert PartitionedTrainer(cfg, mesh=mesh, device="cpu").device == torch.device("cpu")


# -- spawned ranks against the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results on 2 and 4 ranks and the JAX references,
    computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("ptrain")
    jp = {"bilinear": jax_params(SMALL), "attention": jax_params(ATTN, seed=1),
          "fit": jax_params(FIT, seed=2), "noisy": jax_params(SMALL, seed=3),
          "wide": jax_params(WIDE, seed=4)}
    noisy_kw = dict(SMALL, noise=0.02, dropout=True, dropout_rate=0.2)
    g = par.pad_to_multiple(banded_graph(500), 512)  # 512 atoms: D = 2 and D = 4
    n = g.atoms.shape[0]
    y1, w1 = labels(g.atoms, 1)
    g2 = g._replace(edges=g.edges * 1.03)
    y2, w2 = labels(g.atoms, 2)
    fr = frames(7, count=4)
    fit_frames = frames(8, count=3)
    small = frames(11, n=256, count=1)[0][0]
    frags = fragment_batch()
    wide_frags = fragment_batch(n=128, seed=30)
    case = {
        "configs": {"bilinear": SMALL, "attention": ATTN, "fit": FIT, "noisy": noisy_kw,
                    "wide": WIDE},
        "params": jp,
        "graphs": {"g": tuple(g), "g2": tuple(g2), "small": tuple(small),
                   **{f"f{i}": tuple(f[0]) for i, f in enumerate(fr)},
                   **{f"fit{i}": tuple(f[0]) for i, f in enumerate(fit_frames)}},
        "y": {"g": y1, "g2": y2, **{f"f{i}": f[1] for i, f in enumerate(fr)},
              **{f"fit{i}": f[1] for i, f in enumerate(fit_frames)}},
        "w": {"g": w1, "g2": w2, **{f"f{i}": f[2] for i, f in enumerate(fr)},
              **{f"fit{i}": f[2] for i, f in enumerate(fit_frames)}},
        "target": np.sin(np.arange(n, dtype=np.float32) * 0.1),
        "loss_idx": LOSS_IDX,
        "batch": {"graph": tuple(np.stack([getattr(f[0], k) for f in frags[:8]])
                                 for k in Graph._fields),
                  "y": np.stack([f[1] for f in frags[:8]]),
                  "w": np.stack([f[2] for f in frags[:8]])},
        "fragments": frags,
        "wide_fragments": wide_frags,
        "timeout_s": 300,
    }
    four = [f"f{i}" for i in range(4)]
    fit_names = [f"fit{i}" for i in range(3)]
    trainer_tcfg = dict(epochs=1, batch_size=8, pad_to=64, seed=5, mp_path="gather")
    banded_tcfg = dict(trainer_tcfg, pad_to=128, mp_path="banded")
    tasks = {
        2: [dict(kind="grad", model="bilinear", graph=2, graph_name="g"),
            dict(kind="grad", model="attention", graph=2, graph_name="g"),
            dict(kind="step", model="bilinear", graph=2, frames=["g"], lr=LR),
            dict(kind="epoch", model="bilinear", graph=2, frames=four, order=[2, 0, 3, 1],
                 lr=SMALL.get("learning_rate", 1e-4)),
            dict(kind="fit", model="fit", graph=2, frames=fit_names,
                 tcfg=dict(epochs=2, seed=0)),
            dict(kind="dp_step", model="bilinear", data=2, graph=1, tp=False, lr=LR),
            dict(kind="dp_step", model="bilinear", data=1, graph=2, tp=True, lr=LR),
            dict(kind="trainer", model="bilinear", data=2, graph=1, tcfg=trainer_tcfg),
            dict(kind="noise", model="noisy", graph=2, graph_name="small", seeds=32),
            dict(kind="trainer", model="wide", data=2, graph=1, tcfg=banded_tcfg,
                 fragments="wide_fragments")],
        4: [dict(kind="grad", model="bilinear", graph=4, graph_name="g"),
            dict(kind="grad", model="attention", graph=4, graph_name="g"),
            dict(kind="step", model="bilinear", data=2, graph=2, frames=["g", "g2"], lr=LR),
            dict(kind="epoch", model="bilinear", data=2, graph=2, frames=four,
                 order=[2, 0, 3, 1], lr=1e-4),
            dict(kind="dp_step", model="bilinear", data=2, graph=2, tp=True, lr=LR),
            dict(kind="trainer", model="bilinear", data=2, graph=2, tp=True,
                 tcfg=trainer_tcfg)],
    }
    joins = {D: worker.spawn(D, dict(case, tasks=tasks[D]), tmp, timeout_s=600)[1]
             for D in (2, 4)}

    ref = {}
    tgt = jnp.asarray(case["target"])
    jgraph = jg(g)
    # (a) gradients through the JAX partitioned forward
    for name, kw in (("bilinear", SMALL), ("attention", ATTN)):
        jcfg = JModelConfig(**kw)
        for D in (2, 4):
            plan = jmake_banded(g.nlist, g.edges, D)
            mesh = jmake_mesh(data=8 // D, graph=D)

            def loss(p, jcfg=jcfg, plan=plan, mesh=mesh):
                peaks = japply_banded(p, jcfg, jgraph, plan, mesh, interpret=True,
                                      differentiable=True)
                return jnp.mean((peaks - tgt) ** 2)

            ref[("grad", name, D)] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
                jax.tree_util.tree_map(jnp.asarray, jp[name])))
    # (b) one step: JAX's partitioned step and the one-device step
    jcfg = JModelConfig(**SMALL)
    tx = optax.adam(LR)
    p0 = jax.tree_util.tree_map(jnp.asarray, jp["bilinear"])
    plan2 = jmake_banded(g.nlist, g.edges, 2)
    step = jmake_step(jcfg, tx, LOSS_IDX, plan2, jmake_mesh(data=4, graph=2), interpret=True)
    newp, _, loss = step(p0, tx.init(p0), jgraph, jnp.asarray(y1), jnp.asarray(w1))
    ref["step"] = (float(loss), jax.tree_util.tree_map(np.asarray, newp))

    def single(p, gg, y, w):
        return jname_loss(jfold(jnp.asarray(y), jnp.asarray(w)), jgnn.apply(p, jcfg, gg),
                          LOSS_IDX)

    sl, sgr = jax.value_and_grad(single)(p0, jgraph, y1, w1)
    upd, _ = tx.update(sgr, tx.init(p0), p0)
    ref["single"] = (float(sl), jax.tree_util.tree_map(np.asarray, optax.apply_updates(p0, upd)))
    # (c) the data-batched step on a 2 x 2 mesh
    bstep = jmake_step(jcfg, tx, LOSS_IDX, plan2, jmake_mesh(data=2, graph=2), interpret=True,
                       data_axis="data")
    graphs = JGraph(*[jnp.stack([jnp.asarray(a), jnp.asarray(b)]) for a, b in zip(g, g2)])
    newp, _, loss = bstep(p0, tx.init(p0), graphs, jnp.stack([y1, y2]), jnp.stack([w1, w2]))
    ref["batched"] = (float(loss), jax.tree_util.tree_map(np.asarray, newp))
    # (e) PartitionedTrainer.fit, 2 epochs, on a (1, 2) mesh
    jtr = JPartitionedTrainer(JModelConfig(**FIT), JTrainConfig(epochs=2, seed=0),
                              mesh=jmake_mesh(data=1, graph=2), interpret=True)
    jsamples = [JSample(JGraph(*f[0]), f[1], f[2]) for f in fit_frames]
    pf = jax.tree_util.tree_map(jnp.asarray, jp["fit"])
    state = JTrainState(params=pf, opt_state=jtr._tx.init(pf), lr=FIT["learning_rate"])
    state = jtr.fit(jsamples, jsamples[:1], state=state, verbose=False)
    ref["fit"] = (state.history, jax.tree_util.tree_map(np.asarray, state.params),
                  jtr.evaluate(jsamples, state.params))
    # (f) the DP and DP + TP steps
    bg = jg(case["batch"]["graph"])
    by, bw = jnp.asarray(case["batch"]["y"]), jnp.asarray(case["batch"]["w"])
    for tp in (False, True):
        mesh = jmake_mesh(data=4, graph=2)
        pstep, shard_init = jmake_parallel_step(jcfg, tx, LOSS_IDX, mesh, tp=tp)
        pp = jax.tree_util.tree_map(jnp.array, jp["bilinear"])
        sp, so = shard_init(pp, tx.init(pp))
        newp, _, loss = pstep(sp, so, *jshard_batch(mesh, bg, by, bw), jax.random.PRNGKey(9))
        ref[("dp", tp)] = (float(loss), jax.tree_util.tree_map(np.asarray, newp))
    # (g) the Trainer on a mesh, one epoch; the port's banded path against
    # the JAX Trainer's gather path
    for D, tp, model in ((1, False, "bilinear"), (2, True, "bilinear"), (1, False, "wide")):
        tcfg = JTrainConfig(**(trainer_tcfg if model == "bilinear" else
                               dict(banded_tcfg, mp_path="gather")))
        train_frags = frags if model == "bilinear" else wide_frags
        mcfg = JModelConfig(**case["configs"][model])
        jt = JTrainer(mcfg, tcfg, mesh=jmake_mesh(data=2, graph=D), tensor_parallel=tp)
        pt = jax.tree_util.tree_map(jnp.array, jp[model])
        st = JTrainState(params=pt, opt_state=jt._tx.init(pt), lr=mcfg.learning_rate)
        st = jt.fit([JSample(JGraph(*f[0]), f[1], f[2]) for f in train_frags], [], state=st,
                    verbose=False)
        ref[("trainer", tp, model)] = (st.history,
                                       jax.tree_util.tree_map(lambda a: np.asarray(a), st.params))
    # (h) the one-device training forward's draws (the port's), 32 keys
    ncfg = ModelConfig(**noisy_kw)
    tparams = params_from_numpy(jp["noisy"], device="cpu")
    tg = Graph(*[torch.as_tensor(a) for a in small])
    with torch.no_grad():
        ref["noise_single"] = np.stack([gnn.apply(
            tparams, ncfg, tg, training=True,
            generator=torch.Generator().manual_seed(5000 + s)).numpy() for s in range(32)])
        ref["noise_base"] = gnn.apply(tparams, ncfg, tg).numpy()
    out = {D: join() for D, join in joins.items()}
    return out, tasks, ref


def _same_on_every_rank(out, D, i, key):
    vals = [r[i][key] for r in out[D]]
    for v in vals[1:]:
        for a, b in zip(flat(v).values(), flat(vals[0]).values()):
            np.testing.assert_array_equal(a, b)
    return vals[0]


@pytest.mark.parametrize("D,i,family", [(2, 0, "bilinear"), (2, 1, "attention"),
                                        (4, 0, "bilinear"), (4, 1, "attention")])
def test_partitioned_gradients_match_jax(runs, D, i, family):
    """``apply_partitioned_banded(differentiable=True)``: the gradients of
    a squared error, summed over the graph group, equal JAX's through its
    partitioned forward (attention: identity order, padding slots naming
    row 0, where the two padding forms agree)."""
    out, _, ref = runs
    grads = _same_on_every_rank(out, D, i, "grads")
    assert_trees(grads, ref[("grad", family, D)], PARAM_TOL)


def test_partitioned_train_step_matches_jax_and_one_device(runs):
    out, _, ref = runs
    rec = out[2][0][2]
    for r in out[2][1:]:
        assert r[2]["loss"] == rec["loss"]
    for want in (ref["step"], ref["single"]):
        np.testing.assert_allclose(rec["loss"], want[0], **LOSS_TOL)
        assert_trees(rec["params"], want[1], PARAM_TOL)


def test_data_batched_step_matches_jax(runs):
    """(data=2, graph=2): two structures in one step, the mean of their
    losses and gradients, as JAX's ``data_axis`` step."""
    out, _, ref = runs
    rec = out[4][0][2]
    np.testing.assert_allclose(rec["loss"], ref["batched"][0], **LOSS_TOL)
    assert_trees(_same_on_every_rank(out, 4, 2, "params"), ref["batched"][1], PARAM_TOL)


@pytest.mark.parametrize("D,mode", [(2, "serial"), (4, "serial"), (4, "batched")])
def test_epoch_function_matches_serial_steps(runs, D, mode):
    """The epoch function over the frame table equals the steps one by one
    in the same order (``tests/test_halo.py``'s tolerance), unbatched and
    with 2 frames a step on a data axis of 2."""
    out, _, _ = runs
    rec = out[D][0][3]
    assert rec["keys"] == 1
    r = rec[mode]
    np.testing.assert_allclose(r["epoch_losses"], r["serial_losses"], rtol=1e-5, atol=1e-7)
    assert_trees(r["epoch_params"], r["serial_params"], dict(rtol=2e-4, atol=2e-6))


@pytest.mark.parametrize("D", [2, 4])
def test_eval_function_matches_per_frame_evaluation(runs, D):
    out, _, _ = runs
    ev = out[D][0][3]["eval"]
    np.testing.assert_allclose(ev["losses"], ev["one_losses"], rtol=1e-6)
    np.testing.assert_allclose(ev["moments"], ev["one_moments"], rtol=1e-6, atol=1e-6)


def test_partitioned_trainer_fit_matches_jax(runs):
    """``PartitionedTrainer.fit``, 2 epochs of 3 frames on a (1, 2) mesh
    with the JAX package's initial weights, seed and numpy shuffle (noise
    0, dropout off): the history, the weights and ``evaluate``."""
    out, _, ref = runs
    rec = out[2][0][4]
    hist, params, ev = ref["fit"]
    for k in ("loss", "val_loss", "lr"):
        np.testing.assert_allclose(rec["history"][k], hist[k], **LOSS_TOL, err_msg=k)
    assert rec["history"]["loss"][-1] < rec["history"]["loss"][0]
    assert_trees(rec["params"], params, PARAM_TOL)
    np.testing.assert_allclose(rec["eval"]["loss"], ev["loss"], **LOSS_TOL)


@pytest.mark.parametrize("D,i,tp", [(2, 5, False), (2, 6, True), (4, 4, True)])
def test_parallel_train_step_matches_jax(runs, D, i, tp):
    """``make_parallel_train_step``: DP (data=2), TP (graph=2) and DP + TP
    (2 x 2) against JAX's (4 x 2) step on the same batch, and the layouts
    of ``shard_init`` (w and the square FC kernel split on dim 0 with TP,
    the Adam moments like their parameters)."""
    out, _, ref = runs
    rec = out[D][0][i]
    loss, params = ref[("dp", tp)]
    np.testing.assert_allclose(rec["loss"], loss, **DP_LOSS_TOL)
    assert_trees(_same_on_every_rank(out, D, i, "params"), params, DP_PARAM_TOL)
    n = 2 if tp else 1
    lay = rec["layout"]
    assert lay["mp_w"] == (32 // n, 32, 3) and lay["fc0"] == (32 // n, 32)
    assert lay["out"] == (16, 10)
    shapes = [tuple(t.shape) for t in gnn.trainable_leaves(par.shard_params(
        params_from_numpy(jax_params(SMALL), "cpu"),
        par.Mesh(1, n, {}, 0, torch.device("cpu")), tp))]
    assert [lay["moments"][k] for k in sorted(lay["moments"])] == shapes


@pytest.mark.parametrize("D,i,tp,model", [(2, 7, False, "bilinear"), (4, 5, True, "bilinear"),
                                          (2, 9, False, "wide")])
def test_trainer_on_a_mesh_matches_jax(runs, D, i, tp, model):
    """``Trainer(mesh=)`` for one epoch (2 batches of 8 fragments) on a
    data axis of 2, with ``tensor_parallel`` on a 2 x 2 mesh, and at
    F = 128, pad_to 128 on the banded path (B2 + B1 at
    ``fragment_band_plan(4, 128)`` a data rank; the plain versions here),
    against the JAX Trainer (gather path) on the same meshes: loss history
    and weights (the whole weights handed back)."""
    out, _, ref = runs
    rec = out[D][0][i]
    hist, params = ref[("trainer", tp, model)]
    assert rec["banded"] == (model == "wide")
    np.testing.assert_allclose(rec["history"]["loss"], hist["loss"], **DP_LOSS_TOL)
    assert_trees(_same_on_every_rank(out, D, i, "params"), params, DP_PARAM_TOL)


def test_shard_local_noise_matches_one_device_distribution(runs):
    """Training-mode partitioned forwards (shard-local noise and dropout,
    32 keys) against the one-device training forward's draws: the per-atom
    means agree within sampling error, the spread within 0.7-1.4, and the
    shards' draws are independent (``tests/test_halo.py``'s check)."""
    out, _, ref = runs
    part = out[2][0][8]["peaks"][:, :256]
    single, base = ref["noise_single"], ref["noise_base"]
    scale = np.std(single - base[None])
    assert scale > 0
    diff = part.mean(0) - single.mean(0)
    assert np.abs(diff).mean() < 4 * scale / np.sqrt(32), (np.abs(diff).mean(), scale)
    s_part = np.std(part - base[None])
    assert 0.7 < s_part / scale < 1.4, (s_part, scale)
    c = np.corrcoef((part - base[None])[:, :128].mean(1), (part - base[None])[:, 128:].mean(1))
    assert abs(c[0, 1]) < 0.5, c


# -- the CLI ----------------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["--graph-parallel", "2"], ["--data-parallel", "2"],
                                   ["--data-parallel", "1", "--tensor-parallel"]])
def test_train_parallel_flags_under_torchrun(tmp_path, flags):
    """``train`` with each parallel flag under torchrun (2 gloo processes,
    ``--device cpu``): --graph-parallel on make-struct-records output,
    --data-parallel (and with --tensor-parallel, a (1, 2) mesh) on
    make-fragments output; rank 0 alone writes a model that JAX's
    ``load_model`` reads."""
    from nmrgnn_tpu_torch import cli

    pdb, records = str(tmp_path / "s.pdb"), str(tmp_path / "s.tfrecord")
    write_synthetic_pdb(pdb, n_atoms=300, seed=3, frames=2)
    whole = flags[0] == "--graph-parallel"
    if whole:
        assert cli.main(["make-struct-records", pdb, records]) == 0
    else:
        assert cli.main(["make-fragments", pdb, records, "--fragment-size", "64"]) == 0
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        f.write(ModelConfig(**SMALL).to_json())
    model = str(tmp_path / "model")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "nmrgnn_tpu_torch.cli", "train", records, model, "1", *flags, "--config",
         cfg, "--validation", "0.5" if whole else "0.2", "--batch-size", "4", "--pad-to",
         "64", "--device", "cpu", "--checkpoint-path", str(tmp_path / "ckpt")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    want = ("graph-parallel training: mesh {'data': 1, 'graph': 2}" if whole else
            "mesh: {'data': 2, 'graph': 1}" if flags[1] == "2" else
            "mesh: {'data': 1, 'graph': 2}")
    assert want in r.stdout
    assert r.stdout.count("Saved model to") == 1
    params, cfg_j = jload_model(model)
    assert cfg_j.atom_feature_size == 32
    assert np.isfinite(np.asarray(params["mp"][0]["w"])).all()
