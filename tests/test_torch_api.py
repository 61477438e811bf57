"""The port's public API against the JAX package's: the package and
subpackage exports, the library's remaining entry points
(``setup_optimizations``, ``load_baseline``, ``build_GNNModel``,
``load_data``), the Graph properties and ``inv_degree_np``, the TensorBoard
event writer byte for byte, the profiling helpers, ``sample_config``, and
``load_train_checkpoint`` of a directory the JAX package's Trainer wrote."""
import ast
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import nmrgnn_tpu
import nmrgnn_tpu_torch
from nmrgnn_tpu.config import ModelConfig as JModelConfig
from nmrgnn_tpu.config import TrainConfig as JTrainConfig
from nmrgnn_tpu.data.dataset import split_dataset as jsplit_dataset
from nmrgnn_tpu.data.parse import inv_degree_np as jinv_degree_np
from nmrgnn_tpu.models.gnn import count_params as jcount_params
from nmrgnn_tpu.models.gnn import init_params as jinit_params
from nmrgnn_tpu.train import hyper as jhyper
from nmrgnn_tpu.train import trainer as jtrainer
from nmrgnn_tpu.utils import tb_events as jtb_events
from nmrgnn_tpu_torch import library
from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
from nmrgnn_tpu_torch.data.fragment import write_structure_fragments
from nmrgnn_tpu_torch.data.parse import inv_degree_np
from nmrgnn_tpu_torch.data.pdb import read_structure
from nmrgnn_tpu_torch.data.tfrecord import read_tfrecord
from nmrgnn_tpu_torch.graph import Graph, ring_graph
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.train import hyper
from nmrgnn_tpu_torch.train.trainer import Trainer
from nmrgnn_tpu_torch.utils import TimingBuckets, device_time, trace
from nmrgnn_tpu_torch.utils import tb_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import write_synthetic_pdb  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(atom_feature_size=32, edge_hidden_size=16, mp_layers=2, fc_layers=2,
             edge_fc_layers=2, learning_rate=1e-3, dropout=False, noise=0.0)
# names of the JAX package not ported yet (none since the training across
# cards is)
MULTI_GPU = {}


@pytest.mark.parametrize("mod", ["", "data", "ops", "models", "train", "utils", "compat"])
def test_exports_match_jax(mod):
    """Every subpackage exports the JAX package's ``__all__``, less the
    multi-GPU names, and each name resolves."""
    jmod = nmrgnn_tpu if not mod else __import__(f"nmrgnn_tpu.{mod}", fromlist=["x"])
    tmod = nmrgnn_tpu_torch if not mod else __import__(f"nmrgnn_tpu_torch.{mod}",
                                                       fromlist=["x"])
    assert list(tmod.__all__) == [n for n in jmod.__all__ if n not in MULTI_GPU.get(mod, ())]
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None
    if not mod:
        assert len(tmod.__all__) == 25


def test_parallel_exports_hold_jax_names():
    """``parallel.__all__`` holds every name of the JAX package's (the
    port keeps its own serving names beside them: ``ring_exchange``,
    ``psum``, ``Mesh``, ...), and each resolves."""
    import nmrgnn_tpu.parallel as jpar
    import nmrgnn_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    assert len(tpar.__all__) == len(set(tpar.__all__))
    for name in tpar.__all__:
        assert getattr(tpar, name) is not None


def test_import_builds_nothing_and_loads_no_cli():
    """Importing the package and its subpackages loads neither the CLI,
    TensorFlow, JAX nor a kernel library, and starts no process group."""
    code = ("import sys, nmrgnn_tpu_torch, nmrgnn_tpu_torch.utils, nmrgnn_tpu_torch.compat, "
            "nmrgnn_tpu_torch.train, nmrgnn_tpu_torch.ops\n"
            "from nmrgnn_tpu_torch.ops import _cuda\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tensorflow', 'click',"
            " 'pandas', 'nmrgnn_tpu') or m == 'nmrgnn_tpu_torch.cli']\n"
            "assert not bad and not _cuda._libs, (bad, _cuda._libs)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    # TensorFlow appears in the package only inside the importer's reader
    for root, _, files in os.walk(os.path.join(REPO, "nmrgnn_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, f)).read())
                top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
                for n in top:
                    names = [a.name for a in n.names] if isinstance(n, ast.Import) else [n.module]
                    assert not any(x and x.split(".")[0] == "tensorflow" for x in names), f


def test_library_entry_points(tmp_path):
    assert library.load_baseline() == library.BASELINE_DIR
    assert os.path.exists(os.path.join(library.load_baseline(), "params.msgpack"))
    cfg = ModelConfig()
    params, trainer = library.build_GNNModel(cfg, loss_balance=0.5,
                                             rng=torch.Generator().manual_seed(3), device="cpu")
    jparams = jinit_params(jax.random.PRNGKey(0), JModelConfig(), None)
    assert gnn.count_params(params) == jcount_params(jparams) == 1_070_477
    assert isinstance(trainer, Trainer) and trainer.tcfg.loss_balance == 0.5
    assert params["embed"]["kernel"].device.type == "cpu"
    library.setup_optimizations(debug_nans=True, enable_x64=True)
    try:
        assert torch.is_anomaly_enabled() and torch.get_default_dtype() == torch.float32
    finally:
        torch.autograd.set_detect_anomaly(False)
    pdb = str(tmp_path / "s.pdb")
    write_synthetic_pdb(pdb, n_atoms=300, seed=4)
    rec = str(tmp_path / "f.tfrecord")
    write_structure_fragments(rec, read_structure(pdb), fragment_size=64)
    train, val = library.load_data([rec], 0.25)
    jtrain, jval = jsplit_dataset([rec], 0.25)
    assert (len(train), len(val)) == (len(jtrain), len(jval)) and len(val) > 0
    for a, b in zip(train, jtrain):
        np.testing.assert_array_equal(a.y, b.y)


def test_graph_properties_and_inv_degree():
    g = ring_graph(7, 3)
    assert (g.num_atoms, g.num_neighbors, g.num_elements) == (7, 3, 16)
    gb = Graph(*[np.stack([a, a]) for a in g])
    assert (gb.num_atoms, gb.num_neighbors, gb.num_elements) == (7, 3, 16)
    nlist = np.random.default_rng(0).integers(0, 4, (50, 6)).astype(np.int32)
    nlist[3] = 0
    np.testing.assert_array_equal(inv_degree_np(nlist), jinv_degree_np(nlist))


def test_event_writer_bytes_equal_jax(tmp_path, monkeypatch):
    """At a fixed wall time the two writers' event files are equal byte
    for byte, and the port's TFRecord reader reads the events back."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    logs = [({"loss": 1.5, "val_loss": 2.25, "lr": 1e-3, "note": "x"}, 1),
            ({"loss": 0.75}, 2)]
    files = []
    for mod, d in ((tb_events, tmp_path / "t"), (jtb_events, tmp_path / "j")):
        w = mod.EventWriter(str(d))
        for lg, step in logs:
            w.scalars(lg, step)
        w.close()
        (f,) = os.listdir(d)
        files.append(os.path.join(d, f))
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
    records = list(read_tfrecord(files[0], check_crc=True))
    assert len(records) == 1 + 3 + 1 and b"brain.Event:2" in records[0]
    assert b"val_loss" in records[1 + 1]


def test_profiling_helpers(tmp_path):
    with trace(str(tmp_path / "prof")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (f,) = os.listdir(d)
    assert f.endswith(".json") and os.path.getsize(os.path.join(d, f)) > 0
    tb = TimingBuckets("a", "b")
    with tb("a"):
        time.sleep(0.01)
    assert tb.ns["a"] >= 10_000_000 and tb.ns["b"] == 0 and "a:" in tb.summary()
    x = torch.ones(256, 256)
    assert 0 < device_time(lambda c: c @ x / 256, x, iters=6, repeats=2) < 1.0


@pytest.mark.parametrize("seed", range(8))
def test_sample_config_matches_jax(seed):
    """The same numpy draws give the same configurations."""
    assert hyper.SEARCH_SPACE == jhyper.SEARCH_SPACE
    r, jr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        assert hyper.sample_config(r).to_json() == jhyper.sample_config(jr).to_json()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A directory the JAX package's Trainer wrote after two epochs with
    its EMA on: the model, opt_state.msgpack, ema.msgpack, train_state.pkl."""
    d = tmp_path_factory.mktemp("jaxckpt")
    pdb = str(d / "s.pdb")
    write_synthetic_pdb(pdb, n_atoms=300, seed=5)
    rec = str(d / "f.tfrecord")
    write_structure_fragments(rec, read_structure(pdb), fragment_size=64)
    train, val = jsplit_dataset([rec], 0.25)
    jcfg = JModelConfig(**SMALL)
    tr = jtrainer.Trainer(jcfg, JTrainConfig(batch_size=2, pad_to=64, ema_decay=0.9))
    state = tr.fit(train, val, epochs=2, verbose=False)
    path = str(d / "ckpt")
    jtrainer.save_train_checkpoint(path, state, jcfg)
    return path, state, rec


def _trainer():
    return Trainer(ModelConfig(**SMALL), TrainConfig(batch_size=2, pad_to=64, ema_decay=0.9),
                   device="cpu")


def test_load_train_checkpoint_of_jax_directory(jax_checkpoint):
    """Adam's count and moments, the EMA and the schedule come back; the
    state trains on."""
    path, jstate, rec = jax_checkpoint
    assert {"opt_state.msgpack", "ema.msgpack", "train_state.pkl"} <= set(os.listdir(path))
    tr = _trainer()
    state = tr.load_checkpoint(path)
    assert (state.epoch, state.plateau) == (jstate.epoch, jstate.plateau) == (2, 0)
    assert state.lr == pytest.approx(float(jstate.lr))
    assert state.best_val == pytest.approx(float(jstate.best_val))
    assert state.history["val_loss"] == pytest.approx(jstate.history["val_loss"])
    adam = jstate.opt_state.inner_state[0]
    opt = tr.optimizer(state)
    leaves = gnn.trainable_leaves(state.params)
    mu = gnn.trainable_leaves(library.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, adam.mu), "cpu"))
    nu = gnn.trainable_leaves(library.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, adam.nu), "cpu"))
    assert len(opt.state) == len(leaves) > 0
    for t, m, v in zip(leaves, mu, nu):
        st = opt.state[t]
        assert int(st["step"]) == int(adam.count) > 0
        torch.testing.assert_close(st["exp_avg"], m, rtol=0, atol=0)
        torch.testing.assert_close(st["exp_avg_sq"], v, rtol=0, atol=0)
    ema = gnn.tree_leaves(library.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.ema_params), "cpu"))
    for a, b in zip(gnn.tree_leaves(state.ema_params), ema):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    from nmrgnn_tpu_torch.data.dataset import split_dataset

    train, val = split_dataset([rec], 0.25)
    state = tr.fit(train, val, epochs=1, state=state, verbose=False)
    assert state.epoch == 3 and np.isfinite(state.history["loss"][-1])


def test_load_train_checkpoint_raises_on_a_partial_jax_directory(jax_checkpoint, tmp_path):
    """A JAX directory without its schedule pickle, or whose optimizer state
    is not Adam's, raises; a model alone restarts with a warning."""
    import shutil

    path, _, _ = jax_checkpoint
    for drop, bad in (("train_state.pkl", None), (None, "opt_state.msgpack")):
        d = str(tmp_path / f"c-{drop}-{bad}")
        shutil.copytree(path, d)
        if drop:
            os.remove(os.path.join(d, drop))
        if bad:
            from nmrgnn_tpu_torch import _msgpack

            with open(os.path.join(d, bad), "wb") as f:
                f.write(_msgpack.packb({"count": 1}))
        with pytest.raises(ValueError):
            _trainer().load_checkpoint(d)
    d = str(tmp_path / "evil")
    shutil.copytree(path, d)
    with open(os.path.join(d, "train_state.pkl"), "wb") as f:
        pickle.dump({"epoch": subprocess.Popen}, f)  # a class the reader refuses
    with pytest.raises(pickle.UnpicklingError):
        _trainer().load_checkpoint(d)
    d = str(tmp_path / "model_only")
    library.save_model(d, _trainer().init_state().params, ModelConfig(**SMALL))
    with pytest.warns(UserWarning, match="no training state"):
        state = _trainer().load_checkpoint(d)
    assert state.epoch == 0 and state.opt_state == {}
