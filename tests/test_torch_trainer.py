"""The port's losses, metrics and Trainer against the JAX package's: the
loss and the 15 metrics on the same labels, the path rule of
``mp_path``, one epoch of the port's banded Trainer against the JAX
Trainer on its gather path from the same params (noise and dropout off),
the schedules, EMA, best-restore, NaN recovery, checkpoint and resume,
and save_model read back by the JAX package's load_model."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu.config import ModelConfig as JModelConfig
from nmrgnn_tpu.config import TrainConfig as JTrainConfig
from nmrgnn_tpu.data.dataset import read_fragments as jread_fragments
from nmrgnn_tpu.data.embeddings import load_embeddings
from nmrgnn_tpu.library import load_model as jload_model
from nmrgnn_tpu.train import losses as jlosses
from nmrgnn_tpu.train import metrics as jmetrics
from nmrgnn_tpu.train import trainer as jtrainer
from nmrgnn_tpu_torch.config import ModelConfig, TrainConfig
from nmrgnn_tpu_torch.data.dataset import read_fragments
from nmrgnn_tpu_torch.data.fragment import write_structure_fragments
from nmrgnn_tpu_torch.data.pdb import read_structure
from nmrgnn_tpu_torch.library import load_model, params_from_numpy, save_model
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.train import losses, metrics, trainer
from nmrgnn_tpu_torch.train.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_synthetic_pdb  # noqa: E402

torch.set_num_threads(2)

# tests/test_trainer.py's configurations: SMALL for the loop's features,
# BANDED (F = 128, pad_to 128) for the banded path
SMALL = dict(atom_feature_size=32, edge_hidden_size=16, mp_layers=2, fc_layers=2,
             edge_fc_layers=2, learning_rate=1e-3, dropout=False, noise=0.0)
BANDED = dict(SMALL, atom_feature_size=128)


def _cfgs(kw):
    return ModelConfig(**kw), JModelConfig(**kw)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer")
    pdb = str(d / "s.pdb")
    write_synthetic_pdb(pdb, n_atoms=400, seed=2)
    path = str(d / "frags.tfrecord")
    write_structure_fragments(path, read_structure(pdb), fragment_size=64)
    return path


@pytest.fixture(scope="module")
def samples(records):
    return list(read_fragments(records))


def _labels(seed=0, n=300):
    """y [n, 3] (shift, name index, flag) over the vocabulary's names and
    a prediction."""
    rng = np.random.default_rng(seed)
    names = np.asarray(list(load_embeddings()["name"].values()))
    y = np.stack([rng.normal(50, 30, n), rng.choice(names, n),
                  (rng.uniform(size=n) < 0.8)], axis=1).astype(np.float32)
    return y, (y[:, 0] + rng.normal(0, 5, n)).astype(np.float32)


@pytest.mark.parametrize("s", [1.0, 0.5, 0.0])
def test_loss_matches_jax(s):
    y, pred = _labels()
    idx = jmetrics.type_mask(r".*\-H.*", load_embeddings(), regex=True)
    want = float(jlosses.name_loss(jnp.asarray(y), jnp.asarray(pred), idx, s=s))
    got = float(losses.name_loss(torch.from_numpy(y), torch.from_numpy(pred), idx, s=s))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    for clip in (True, False):
        a = float(jlosses.corr_coeff(jnp.asarray(pred), jnp.asarray(y[:, 0]), clip=clip))
        b = float(losses.corr_coeff(torch.from_numpy(pred), torch.from_numpy(y[:, 0]), clip=clip))
        assert b == pytest.approx(a, rel=1e-5)
    # no labels selected: L2 and r are 0, not NaN
    none = y.copy()
    none[:, 2] = 0
    assert float(losses.name_loss(torch.from_numpy(none), torch.from_numpy(pred), idx, s)) == \
        float(jlosses.name_loss(jnp.asarray(none), jnp.asarray(pred), idx, s=s)) == 1.0 - s


def test_metrics_match_jax():
    emb = load_embeddings()
    y, pred = _labels(seed=1)
    want = jmetrics.build_metric_fns(emb)
    got = metrics.build_metric_fns(emb)
    assert list(got) == list(want) and len(got) == 15
    for name in want:
        a = float(want[name](jnp.asarray(y), jnp.asarray(pred)))
        b = float(got[name](torch.from_numpy(y), torch.from_numpy(pred)))
        assert b == pytest.approx(a, rel=1e-5, abs=1e-6), name
    assert metrics.type_mask("ALA-CA", emb) == jmetrics.type_mask("ALA-CA", emb)
    with pytest.raises(ValueError):
        metrics.type_mask("nomatch$", emb, regex=True)


def test_moments_and_finalize_match_jax():
    y, pred = _labels(seed=2)
    kinds = trainer.metric_kinds()
    assert kinds == jtrainer.metric_kinds()
    w = np.random.default_rng(3).uniform(size=y.shape[0]).astype(np.float32)
    yt = trainer.fold_sample_weight(torch.from_numpy(y), torch.from_numpy(w))
    jyt = jtrainer.fold_sample_weight(jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(jyt))
    for name, kind, idx in kinds:
        m = trainer._moments(yt, torch.from_numpy(pred), idx).numpy()
        jm = np.asarray(jtrainer._moments(jyt, jnp.asarray(pred), idx))
        np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-3, err_msg=name)
        assert trainer.finalize_metric(kind, m) == pytest.approx(
            jtrainer.finalize_metric(kind, jm), rel=1e-4, abs=1e-6)


def test_mp_path_resolution_matches_jax():
    """The port's choices and errors are the JAX package's
    (tests/test_trainer.py:248-280); "auto" takes gather off a CUDA device."""
    cases = [
        (BANDED, dict(mp_path="auto", pad_to=128)),
        (BANDED, dict(mp_path="banded", pad_to=128)),
        (BANDED, dict(mp_path="gather", pad_to=128)),
        (SMALL, dict(mp_path="banded", pad_to=64)),
        (BANDED, dict(mp_path="nope")),
        (BANDED, dict(mp_path="banded", batch_size=64, pad_to=512)),
        (BANDED, dict(mp_path="auto", batch_size=64, pad_to=512)),
    ]
    for kw, tkw in cases:
        cfg, jcfg = _cfgs(kw)
        try:
            want = jtrainer.Trainer(jcfg, JTrainConfig(**tkw)).use_banded
        except ValueError as e:
            with pytest.raises(ValueError, match="VMEM" if "VMEM" in str(e) else "mp_path"):
                Trainer(cfg, TrainConfig(**tkw), device="cpu")
            continue
        assert Trainer(cfg, TrainConfig(**tkw), device="cpu").use_banded == want, (kw, tkw)
    assert trainer.banded_fragments_eligible(ModelConfig(), 8, 256) == (True, True)
    assert trainer.banded_fragments_eligible(ModelConfig(), 8, 256) == \
        jtrainer.banded_fragments_eligible(JModelConfig(), 8, 256)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(ModelConfig(**BANDED))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model()


def _leaves_with_path(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


def _port_tree(params):
    return gnn.tree_map(lambda t: t.detach().numpy(), params)


@pytest.mark.parametrize("mp_path", ["banded", "gather"])
def test_epoch_matches_jax_gather_trainer(records, samples, mp_path):
    """One epoch of the port's Trainer against the JAX Trainer's gather path
    from the same params: params within atol 1e-4 (a tenth of one Adam step
    at lr 1e-3), the loss history within rel 1e-5."""
    cfg, jcfg = _cfgs(BANDED)
    tkw = dict(epochs=1, batch_size=4, pad_to=128, seed=0)
    jsamples = list(jread_fragments(records))
    jt = jtrainer.Trainer(jcfg, JTrainConfig(mp_path="gather", **tkw))
    jstate = jt.init_state()
    start = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstate = jt.fit(jsamples[:10], jsamples[10:13], state=jstate, verbose=False)
    tt = Trainer(cfg, TrainConfig(mp_path=mp_path, **tkw), device="cpu")
    assert tt.use_banded == (mp_path == "banded")
    state = tt.fit(samples[:10], samples[10:13], verbose=False,
                   state=trainer.TrainState(params=params_from_numpy(start, "cpu"),
                                            opt_state={}, lr=cfg.learning_rate))
    got = dict(_leaves_with_path(_port_tree(state.params)))
    for name, want in _leaves_with_path(jstate.params):
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-4, err_msg=name)
    assert state.history["loss"][0] == pytest.approx(jstate.history["loss"][0], rel=1e-5)
    # the validation loss of params that agree within 1e-4
    assert state.history["val_loss"][0] == pytest.approx(jstate.history["val_loss"][0], rel=1e-4)


def test_compiled_and_loader_epochs_agree(samples):
    """The resident table's filler (zero-weight copies of the first
    fragment) and the loader's (zero-weight repeats of the batch's last)
    give the same training on a ragged epoch."""
    cfg = ModelConfig(**BANDED)
    runs = []
    for compiled in (True, False):
        tt = Trainer(cfg, TrainConfig(epochs=2, batch_size=4, pad_to=128, mp_path="banded",
                                      compiled_epochs=compiled), device="cpu")
        runs.append(tt.fit(samples[:10], samples[10:12], verbose=False))
    a, b = runs
    for x, y in zip(gnn.tree_leaves(a.params), gnn.tree_leaves(b.params)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.history["loss"], b.history["loss"], rtol=1e-5)


def test_loss_decreases_with_noise_and_dropout(samples):
    cfg = ModelConfig(**dict(BANDED, noise=0.025, dropout=True))
    tt = Trainer(cfg, TrainConfig(epochs=4, batch_size=4, pad_to=128, mp_path="banded"),
                 device="cpu")
    state = tt.fit(samples[:12], samples[12:14], verbose=False)
    losses_ = state.history["loss"]
    assert all(np.isfinite(losses_)) and losses_[-1] < losses_[0] * 0.9, losses_


def test_plateau_reduces_lr(samples):
    tcfg = TrainConfig(epochs=4, batch_size=4, pad_to=64, lr_patience=1, lr_reduce_factor=0.5,
                       min_lr=1e-6)
    state = Trainer(ModelConfig(**dict(SMALL, learning_rate=1e-2)), tcfg, device="cpu") \
        .fit(samples[:4], samples[4:6], verbose=False)
    assert tcfg.min_lr <= state.lr <= 1e-2
    assert state.history["lr"][0] == 1e-2
    st2 = Trainer(ModelConfig(**dict(SMALL, learning_rate=1e-6)), tcfg, device="cpu") \
        .fit(samples[:4], samples[4:6], verbose=False)
    assert st2.lr == pytest.approx(1e-6)


def test_cosine_ema_and_checkpoint(samples, tmp_path):
    tcfg = TrainConfig(epochs=6, batch_size=4, pad_to=64, lr_schedule="cosine",
                       warmup_epochs=2, cosine_final_lr=1e-5, ema_decay=0.9)
    tt = Trainer(ModelConfig(**SMALL), tcfg, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    state = tt.fit(samples[:12], samples[12:14], verbose=False, checkpoint_path=ckpt)
    lrs = state.history["lr"]
    assert lrs[0] < lrs[1] and lrs[-1] < lrs[2]
    assert state.eval_params is state.ema_params
    raw = state.params["out"]["kernel"].detach()
    ema = state.ema_params["out"]["kernel"]
    assert not torch.allclose(raw, ema)
    restored = tt.load_checkpoint(ckpt)
    assert restored.epoch == 6 and restored.history == state.history
    torch.testing.assert_close(restored.ema_params["out"]["kernel"], ema)
    # the JAX package reads the model the checkpoint holds
    jparams, jcfg = jload_model(ckpt)
    assert jcfg.to_json() == ModelConfig(**SMALL).to_json()
    np.testing.assert_array_equal(np.asarray(jparams["out"]["kernel"]), raw.numpy())


def test_checkpoint_resume_continues_adam(samples, tmp_path):
    """Two epochs, a checkpoint, one more epoch from it: equal to three
    epochs in one run (the optimizer's moments and step count restored)."""
    tkw = dict(batch_size=4, pad_to=64, compiled_epochs=True)
    ckpt = str(tmp_path / "ckpt")
    tt = Trainer(ModelConfig(**SMALL), TrainConfig(epochs=2, **tkw), device="cpu")
    tt.fit(samples[:8], samples[8:10], checkpoint_path=ckpt, verbose=False)
    restored = tt.load_checkpoint(ckpt)
    assert restored.epoch == 2 and restored.opt_state["state"]
    resumed = Trainer(ModelConfig(**SMALL), TrainConfig(epochs=1, **tkw), device="cpu").fit(
        samples[:8], samples[8:10], state=restored, verbose=False)
    assert resumed.epoch == 3
    assert all(np.isfinite(resumed.history["loss"]))
    step = next(iter(resumed.opt_state["state"].values()))["step"]
    assert int(step) == 3 * 2  # 8 fragments, batches of 4, three epochs


def test_restore_best(samples):
    seen = []
    tt = Trainer(ModelConfig(**SMALL), TrainConfig(epochs=5, batch_size=4, pad_to=64,
                                                   restore_best=True), device="cpu")
    state = tt.fit(samples[:12], samples[12:14], verbose=False,
                   callbacks=[lambda st, logs: seen.append(logs["val_loss"])])
    assert tt.evaluate(samples[12:14], state.eval_params)["loss"] == pytest.approx(
        min(seen), rel=1e-4)


def test_early_stop(samples):
    # learning rate 0: the validation loss never improves after epoch 1
    tt = Trainer(ModelConfig(**dict(SMALL, learning_rate=0.0)),
                 TrainConfig(epochs=6, batch_size=4, pad_to=64), device="cpu")
    state = tt.fit(samples[:4], samples[4:6], verbose=False, early_stop_patience=2)
    assert state.epoch == 3


def test_nan_loss_recovers(samples):
    """A diverging run restores the last finite epoch and halves the lr, or
    stops with FloatingPointError: never a silent NaN."""
    tt = Trainer(ModelConfig(**dict(SMALL, learning_rate=1e6)),
                 TrainConfig(epochs=6, batch_size=4, pad_to=64, min_lr=1e-8), device="cpu")
    try:
        state = tt.fit(samples[:8], samples[8:10], verbose=False)
        assert all(np.isfinite(v) for v in state.history["loss"])
    except FloatingPointError:
        pass


def test_evaluate_loader_matches_evaluate(samples):
    from nmrgnn_tpu_torch.data.dataset import FragmentLoader

    tt = Trainer(ModelConfig(**SMALL), TrainConfig(batch_size=4, pad_to=64), device="cpu")
    state = tt.init_state()
    a = tt.evaluate(samples[:8], state.params)
    b = tt.evaluate_loader(FragmentLoader(samples[:8], pad_to=64, batch_size=4, shuffle=False),
                           state=state)
    assert a.keys() == b.keys() and np.isfinite(a["loss"]) and a["avg_ha_count"] >= 0
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6), k


def test_head_decay(samples):
    kw = dict(epochs=1, batch_size=4, pad_to=64, head_decay=10.0, head_decay_elements="N, C")
    tt = Trainer(ModelConfig(**SMALL), TrainConfig(**kw), device="cpu")
    emb = load_embeddings()
    assert tt._head_idx.tolist() == [emb["atom"]["N"], emb["atom"]["C"]]
    state = tt.init_state()
    g, y, w = tt._to_device(*__import__("nmrgnn_tpu_torch.data.dataset", fromlist=["x"])
                            .batch_samples(samples[:4], 64))
    plain = Trainer(ModelConfig(**SMALL), TrainConfig(**dict(kw, head_decay=0.0)),
                    device="cpu")
    cols = state.params["out"]["kernel"][:, tt._head_idx]
    assert float(tt.loss_fn(state.params, g, y, w)) == pytest.approx(
        float(plain.loss_fn(state.params, g, y, w)) + 10.0 * float((cols * cols).sum()),
        rel=1e-6)


def test_save_model_read_by_jax(tmp_path):
    cfg = ModelConfig(**dict(BANDED, compute_dtype="bfloat16"))
    params = gnn.init_params(cfg, torch.Generator().manual_seed(4),
                             {1: ("H", 4.5, 2.0)}, device="cpu")
    save_model(str(tmp_path), params, cfg)
    jparams, jcfg = jload_model(str(tmp_path))
    assert jcfg.to_json() == cfg.to_json()
    got = _leaves_with_path(jparams)
    want = _leaves_with_path(_port_tree(params))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=name)
    back, cfg2 = load_model(str(tmp_path), device="cpu")
    assert cfg2 == cfg
    for a, b in zip(gnn.tree_leaves(back), gnn.tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_config_round_trips_with_jax():
    tc = TrainConfig(epochs=7, mp_path="banded", ema_decay=0.5, head_decay_elements="N,C")
    assert JTrainConfig.from_json(tc.to_json()).to_json() == tc.to_json()
    assert TrainConfig.from_json(JTrainConfig().to_json()) == TrainConfig()
    assert [f for f in TrainConfig.__dataclass_fields__] == \
        [f for f in JTrainConfig.__dataclass_fields__]
