"""Serving, training and saving an attention-family model (AMPLayer) with
the port, against the JAX package on the CPU.

The JAX ``ServingModel(use_pallas=False)`` serves the family through its
gather forward; the port keeps the card's path rule on the CPU and serves
it through "banded_attn" (the plain versions of B2 and B6 here), so the
two are compared within the float32 tolerance, rtol/atol 2e-4, and the
fast precision within the JAX package's exact-vs-fast band (rtol 0.05,
atol 1.0 ppm). Small organic molecules (fewer than K + 1 atoms) have
padding slots, which after the RCM permutation name the old row 0's new
place: their peaks must equal the gather forward's."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu import ModelConfig as JModelConfig
from nmrgnn_tpu.config import TrainConfig as JTrainConfig
from nmrgnn_tpu.data.dataset import read_fragments as jread_fragments
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.library import save_model as jsave_model
from nmrgnn_tpu.models import gnn as jgnn
from nmrgnn_tpu.models.serving import ServingModel as JServingModel
from nmrgnn_tpu.train import trainer as jtrainer
from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
from nmrgnn_tpu_torch.data.dataset import read_fragments
from nmrgnn_tpu_torch.data.neighbors import neighbors_host
from nmrgnn_tpu_torch.data.organic import random_molecule, write_organic_fragments
from nmrgnn_tpu_torch.data.parse import ANGSTROM_TO_NM, structure2graph
from nmrgnn_tpu_torch.data.pdb import read_structure
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import load_model, params_from_numpy, save_model
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.train import trainer
from nmrgnn_tpu_torch.train.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_synthetic_pdb  # noqa: E402

torch.set_num_threads(2)

ATTN = dict(atom_feature_size=64, edge_hidden_size=16, mp_layers=2, fc_layers=2,
            edge_fc_layers=2, mp_type="attention")


def _model(seed=0, **kw):
    jcfg = JModelConfig(**dict(ATTN, **kw))
    jparams = jgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, ModelConfig(**dict(ATTN, **kw)), params


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("attn") / "s.pdb")
    write_synthetic_pdb(path, n_atoms=400, seed=3, frames=3)
    s = read_structure(path)
    return [structure2graph(s, frame=f) for f in range(3)]


def _molecule_graph(seed: int, k: int = 16) -> Graph:
    """A random organic molecule as a graph (the JAX package's neighbor
    rule: fewer than k + 1 atoms leave padding slots, index 0 distance 0)."""
    coords, elem = random_molecule(np.random.default_rng(seed))
    nlist, d = neighbors_host(coords, k)
    atoms = np.eye(10, dtype=np.float32)[elem]
    return Graph(atoms, nlist.astype(np.int32), (d * ANGSTROM_TO_NM).astype(np.float32),
                 inv_degree_from_nlist(nlist))


def test_serving_banded_attn_and_gather_match_jax(frames):
    jcfg, jparams, cfg, params = _model()
    jmodel = JServingModel(jparams, jcfg, use_pallas=False)
    want = [np.asarray(jmodel.predict(g)) for g in frames]
    assert jmodel._resolved == "gather"
    # an attention model ignores mode, as in the JAX package
    model = ServingModel(params, cfg, device="cpu", mode="blocksparse")
    got = [model.predict(g) for g in frames]
    assert model._resolved == "banded_attn"
    gather = ServingModel(params, cfg, device="cpu")
    gather._resolved = "gather"
    for g, p, w in zip(frames, got, want):
        assert p.shape == (400,) and np.all(np.isfinite(p))
        np.testing.assert_allclose(p, w, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(gather.predict(g), w, rtol=2e-4, atol=2e-4)
    assert not np.array_equal(got[0], got[1])
    batch = ServingModel(params, cfg, device="cpu").predict_frames(frames)
    np.testing.assert_allclose(batch, np.stack(got), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(batch, jmodel.predict_frames(frames), rtol=2e-4, atol=2e-4)


def test_serving_fast_attention_in_the_fast_band(frames):
    jcfg, jparams, cfg, params = _model(seed=1)
    want = JServingModel(jparams, jcfg, use_pallas=False).predict(frames[0])
    fast = ServingModel(params, cfg, device="cpu", precision="fast")
    got = fast.predict(frames[0])
    assert fast._resolved == "banded_attn" and fast.config.compute_dtype == "bfloat16"
    np.testing.assert_allclose(got, want, rtol=0.05, atol=1.0)
    assert np.abs(got - want).mean() < 0.05


def test_padding_row_of_small_molecules():
    """Molecules of fewer than 17 atoms, served with the RCM reorder: the
    padding slots name the old row 0's new place, and "banded_attn" equals
    the JAX package's gather forward, one molecule at a time and as
    frames of one molecule."""
    jcfg, jparams, cfg, params = _model(seed=2)
    graphs = [g for g in map(_molecule_graph, range(40)) if g.atoms.shape[0] < 17][:3]
    assert len(graphs) == 3
    for g in graphs:
        assert (g.edges == 0).any()
        model = ServingModel(params, cfg, device="cpu")
        got = model.predict(g)
        assert model._resolved == "banded_attn" and model._order[0] != 0
        want = np.asarray(jgnn.apply(jparams, jcfg, JGraph(*map(jnp.asarray, g))))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    g = graphs[0]
    shifted = Graph(g.atoms, g.nlist, np.where(g.edges > 0, g.edges * 1.01, 0.0).astype(
        np.float32), g.inv_degree)
    batch = ServingModel(params, cfg, device="cpu").predict_frames([g, shifted])
    for f, gf in enumerate((g, shifted)):
        want = np.asarray(jgnn.apply(jparams, jcfg, JGraph(*map(jnp.asarray, gf))))
        np.testing.assert_allclose(batch[f], want, rtol=2e-4, atol=2e-4)


def _banded_like(n, seed=0):
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, 16)), 0, n - 1)
    d = rng.uniform(0.05, 0.2, (n, 16)).astype(np.float32)
    return Graph(np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)], nlist.astype(np.int32),
                 d, inv_degree_from_nlist(nlist))


@pytest.mark.parametrize("n,f,mp_type", [(500, 64, "attention"), (13000, 256, "attention"),
                                          (500, 64, "other")])
def test_attention_path_rule_matches_jax(n, f, mp_type):
    """The JAX package's accelerator rule: "banded_attn" when the E=1 plan
    fits the node-table budget, else "gather" (also for another
    non-bilinear family); only plans are made."""
    kw = dict(ATTN, atom_feature_size=f, mp_type=mp_type)
    g = _banded_like(n)
    jm = JServingModel({}, JModelConfig(**kw), use_pallas=True, reorder=False)
    tm = ServingModel({}, ModelConfig(**kw), device="cpu", reorder=False)
    want = jm._resolve_mode(g)
    assert tm._resolve_mode(g) == want
    assert want == ("banded_attn" if n == 500 and mp_type == "attention" else "gather")
    if want == "banded_attn":
        np.testing.assert_array_equal(tm._plan.lo, jm._plan.lo)
        assert (tm._plan.window, tm._plan.block_rows) == (jm._plan.window, jm._plan.block_rows)


def test_msgpack_round_trips_both_ways(tmp_path):
    jcfg, jparams, cfg, params = _model(seed=3)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsave_model(jdir, jparams, jcfg)
    loaded, lcfg = load_model(jdir, device="cpu")
    assert lcfg == cfg
    for a, b in zip(gnn.tree_leaves(loaded), gnn.tree_leaves(params)):
        assert torch.equal(a, b)
    save_model(tdir, params, cfg)
    jloaded, jlcfg = jload_model(tdir)
    assert jlcfg == jcfg
    for a, b in zip(jax.tree_util.tree_leaves(jloaded), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def organic_records(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("organic") / "organic.tfrecord")
    write_organic_fragments(path, n_molecules=40, seed=0)
    return path


def test_trainer_fits_attention_on_the_gather_path(organic_records, tmp_path):
    """One epoch from the JAX Trainer's initial params equals the JAX
    Trainer's (noise and dropout off; params within 1e-4 but one, see
    below; the loss within rel 1e-5); further epochs lower the loss; the model saved by the
    port's checkpoint loads in the JAX package with the same peaks;
    mp_path="banded" refuses the family, as in the JAX package."""
    kw = dict(ATTN, learning_rate=1e-3, noise=0.0, dropout=False)
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    tkw = dict(epochs=1, batch_size=4, pad_to=64, seed=0)
    with pytest.raises(ValueError, match="bilinear"):
        Trainer(cfg, TrainConfig(mp_path="banded", **tkw), device="cpu")
    samples, jsamples = list(read_fragments(organic_records)), list(
        jread_fragments(organic_records))
    jt = jtrainer.Trainer(jcfg, JTrainConfig(mp_path="gather", **tkw))
    jstate = jt.init_state()
    start = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstate = jt.fit(jsamples[:24], jsamples[24:32], state=jstate, verbose=False)
    tt = Trainer(cfg, TrainConfig(**tkw), device="cpu")
    assert not tt.use_banded
    state = tt.fit(samples[:24], samples[24:32], verbose=False,
                   state=trainer.TrainState(params=params_from_numpy(start, "cpu"),
                                            opt_state={}, lr=cfg.learning_rate))
    # The last EdgeFC bias shifts every real slot's key of a row alike, to
    # which the softmax is blind: its gradient is rounding noise but for
    # the rows with padding slots, and Adam turns noise into steps of up to
    # lr each way. It is held to that bound (6 steps); every other leaf to
    # a tenth of one step.
    steps = 24 // 4
    for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(jstate.params),
                            gnn.tree_leaves(state.params)):
        shift_only = jax.tree_util.keystr(path) == "['edge_fc'][1]['bias']"
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=steps * 1e-3 if shift_only else 1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert state.history["loss"][0] == pytest.approx(jstate.history["loss"][0], rel=1e-5)
    ckpt = str(tmp_path / "ckpt")
    state = tt.fit(samples[:24], samples[24:32], epochs=4, state=state, verbose=False,
                   checkpoint_path=ckpt)
    losses = state.history["loss"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    jparams, jlcfg = jload_model(ckpt)
    assert jlcfg == jcfg and set(jparams["mp"][0]) == {"wq", "wk", "wv"}
    g = samples[0].graph
    want = jgnn.apply(jparams, jcfg, JGraph(*map(jnp.asarray, g)))
    with torch.no_grad():
        got = gnn.apply(state.params, cfg, Graph(*[torch.from_numpy(np.asarray(a)) for a in g]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
