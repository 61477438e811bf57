"""The port's banded training step against the JAX package's: the four
differentiable band wrappers (value and VJP against ``jax.vjp`` of the JAX
wrappers, Pallas in interpret mode), and the training forwards
(``gnn.apply(training=True)``, ``apply_batched``, ``apply_banded_fragments``,
``apply_banded_trainable``: value and ``jax.grad`` on every trainable leaf)
with noise and dropout off, and on with JAX's own draws, taken in JAX's
split order, handed to the port. On the CPU the kernel wrappers take their
plain versions; the CUDA kernels' gradients are held against the plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py phase 9)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu import ModelConfig as JModelConfig
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.models import gnn as jgnn
from nmrgnn_tpu.models import infer as jinfer
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.data.dataset import batch_samples, read_fragments
from nmrgnn_tpu_torch.data.fragment import write_structure_fragments
from nmrgnn_tpu_torch.data.pdb import read_structure
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import params_from_numpy
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models import infer
from nmrgnn_tpu_torch.ops import banded as tb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_synthetic_pdb  # noqa: E402

torch.set_num_threads(2)

# the JAX package's banded-training test sizes (tests/test_trainer.py:131-140)
SMALL = dict(atom_feature_size=128, edge_hidden_size=16, mp_layers=2, fc_layers=2,
             edge_fc_layers=2, learning_rate=1e-3, noise=0.025, dropout=True)
OFF = dict(noise=0.0, dropout=False)
B, PAD = 4, 128


def _rel_close(got, want, tol=2e-4, what=""):
    """|got - want| <= tol x max|want| elementwise (the JAX tests' gradient
    tolerance, tests/test_trainer.py:193)."""
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) + 1e-9
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=what)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Fragments of 100 atoms of a 400-atom synthetic structure, written
    and read back by the port."""
    d = tmp_path_factory.mktemp("train_step")
    pdb = str(d / "s.pdb")
    write_synthetic_pdb(pdb, n_atoms=400, seed=0)
    path = str(d / "frags.tfrecord")
    write_structure_fragments(path, read_structure(pdb), fragment_size=100)
    return list(read_fragments(path))


def _band_case(n=300, k=16, e=3, f=128, seed=0):
    """A graph with a band (tests/test_banded.py:187-192), its edge values
    masked by the distances, a node table and weights."""
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    dists[5, :] = 0.0
    efeat = (rng.normal(size=(n, k, e)) * (dists > 0)[..., None]).astype(np.float32)
    plan = jb.band_plan(nlist, dists)
    nodes = rng.normal(size=(plan.n_padded, f)).astype(np.float32)
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    inv = np.pad(inv_degree_from_nlist(nlist), (0, plan.n_padded - n))
    return rng, nlist, dists, efeat, plan, nodes, w, inv


def _torch_vjp(fn, inputs, cot):
    xs = [_t(x).requires_grad_(True) for x in inputs]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, _t(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def test_build_band_df_matches_jax():
    rng, nlist, dists, efeat, plan, *_ = _band_case()
    cot = rng.normal(size=(plan.num_tiles, 3, plan.block_rows, plan.window)).astype(np.float32)
    want, vjp = jax.vjp(lambda e: jb.build_band_df(jnp.asarray(nlist), e, plan, interpret=True),
                        jnp.asarray(efeat))
    (want_de,) = vjp(jnp.asarray(cot))
    got, (got_de,) = _torch_vjp(lambda e: tb.build_band_df(_t(nlist), e, plan), [efeat], cot)
    _rel_close(got, want, what="M")
    _rel_close(got_de, want_de, what="de")


def test_build_band_tracedlo_df_matches_jax():
    rng, nlist, dists, efeat, plan, *_ = _band_case(n=256)
    # indices shifted by -m against the plan's window starts, as the halo
    # band takes them: the shifted interior indices match no column
    m = 128
    nl = nlist - m
    lo = plan.lo.astype(np.int32)
    cot = rng.normal(size=(plan.num_tiles, 3, plan.block_rows, plan.window)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda e: jb.build_band_tracedlo_df(jnp.asarray(nl), e, jnp.asarray(lo), plan.window,
                                            interpret=True), jnp.asarray(efeat))
    (want_de,) = vjp(jnp.asarray(cot))
    got, (got_de,) = _torch_vjp(
        lambda e: tb.build_band_tracedlo_df(_t(nl), e, lo, plan.window), [efeat], cot)
    _rel_close(got, want, what="M")
    _rel_close(got_de, want_de, what="de")
    assert np.count_nonzero(got_de) and np.count_nonzero(got_de) < got_de.size


def test_mp_banded_df_matches_jax():
    rng, nlist, dists, efeat, plan, nodes, w, inv = _band_case()
    M = np.asarray(jb.build_band_xla(jnp.asarray(nlist), jnp.asarray(efeat), plan))
    cot = rng.normal(size=nodes.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda M_, x, w_, i: jb.mp_banded_df(M_, plan, x, w_, i, interpret=True),
                        *map(jnp.asarray, (M, nodes, w, inv)))
    want_grads = vjp(jnp.asarray(cot))
    got, got_grads = _torch_vjp(lambda M_, x, w_, i: tb.mp_banded_df(M_, plan, x, w_, i),
                                [M, nodes, w, inv], cot)
    _rel_close(got, want, what="out")
    for name, g, wg in zip(("M", "nodes", "w", "inv_degree"), got_grads, want_grads):
        _rel_close(g, wg, what=name)


def test_mp_banded_df_honours_needs_input_grad():
    _, nlist, dists, efeat, plan, nodes, w, inv = _band_case(n=200)
    M = tb.build_band_plain(_t(nlist), _t(efeat), plan)
    x = _t(nodes).requires_grad_(True)
    out = tb.mp_banded_df(M, plan, x, _t(w), _t(inv))
    (gx,) = torch.autograd.grad(out.sum(), [x])
    assert gx.shape == x.shape and torch.isfinite(gx).all()


def test_mp_banded_partial_df_matches_jax():
    rng, nlist, dists, efeat, plan, nodes, w, _ = _band_case()
    M = np.asarray(jb.build_band_xla(jnp.asarray(nlist), jnp.asarray(efeat), plan))
    cot = rng.normal(size=(plan.n_padded, nodes.shape[1])).astype(np.float32)
    lo = plan.lo.astype(np.int32)
    want, vjp = jax.vjp(
        lambda M_, x, w_: jb.mp_banded_partial_df(M_, jnp.asarray(lo), x, w_, interpret=True),
        *map(jnp.asarray, (M, nodes, w)))
    want_grads = vjp(jnp.asarray(cot))
    got, got_grads = _torch_vjp(lambda M_, x, w_: tb.mp_banded_partial_df(M_, lo, x, w_),
                                [M, nodes, w], cot)
    _rel_close(got, want, what="out")
    for name, g, wg in zip(("M", "table", "w"), got_grads, want_grads):
        _rel_close(g, wg, what=name)


# -- the training forwards ------------------------------------------------------


def _jax_draws(key, cfg, n, k):
    """(noise [n, k], keep [n, F/2]) as gnn.apply draws them from ``key``
    (nmrgnn_tpu/models/gnn.py:175-212), None where the config turns them
    off."""
    noise = keep = None
    if cfg.noise > 0:
        key, nk = jax.random.split(key)
        noise = jax.random.normal(nk, (n, k), jnp.float32)
    if cfg.dropout:
        key, dk = jax.random.split(key)
        keep = jax.random.bernoulli(dk, 1.0 - cfg.dropout_rate,
                                    (n, cfg.atom_feature_size // 2))
    return noise, keep


def _to_torch_draws(noise, keep):
    return (None if noise is None else _t(noise),
            None if keep is None else _t(keep).to(torch.bool))


def _value_and_grads_torch(fn, params):
    leaves = gnn.trainable_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = fn(params)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _check_value_and_grads(jfn, tfn, jparams):
    jl, jg = jax.value_and_grad(jfn)(jparams)
    tl, tg = _value_and_grads_torch(tfn, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    assert tl == pytest.approx(float(jl), rel=2e-4, abs=2e-4)
    jleaves = [(jax.tree_util.keystr(p), a) for p, a in jax.tree_util.tree_leaves_with_path(jg)
               if "peak_" not in jax.tree_util.keystr(p)]
    assert len(jleaves) == len(tg)
    for (name, a), b in zip(jleaves, tg):
        _rel_close(b, a, what=name)


def _setup(samples, training_kw):
    cfg_kw = dict(SMALL, **training_kw)
    jcfg, cfg = JModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jparams = jgnn.init_params(jax.random.PRNGKey(1), jcfg)
    g, y, w = batch_samples(samples[:B], PAD)
    return jcfg, cfg, jparams, g, w


@pytest.mark.parametrize("training_kw", [OFF, {}], ids=["draws_off", "draws_on"])
def test_apply_training_matches_jax(samples, training_kw):
    jcfg, cfg, jparams, _, _ = _setup(samples, training_kw)
    s = samples[0]
    g = s.graph
    key = jax.random.PRNGKey(7)
    noise, keep = _jax_draws(key, jcfg, *g.nlist.shape)
    jgraph = JGraph(*map(jnp.asarray, g))
    tgraph = Graph(_t(g.atoms), _t(g.nlist), _t(g.edges), _t(g.inv_degree))
    wj, wt = jnp.asarray(s.w), _t(s.w)
    tn, tk = _to_torch_draws(noise, keep)
    _check_value_and_grads(
        lambda p: jnp.sum(jgnn.apply(p, jcfg, jgraph, training=True, rng=key) * wj),
        lambda p: torch.sum(gnn.apply(p, cfg, tgraph, training=True, noise=tn,
                                      dropout_mask=tk) * wt),
        jparams)


def _batch_draws(jcfg, rngs, k):
    draws = [_jax_draws(r, jcfg, PAD, k) for r in rngs]
    stack = lambda i: None if draws[0][i] is None else np.stack(  # noqa: E731
        [np.asarray(d[i]) for d in draws])
    return _to_torch_draws(stack(0), stack(1))


@pytest.mark.parametrize("training_kw", [OFF, {}], ids=["draws_off", "draws_on"])
def test_apply_batched_matches_jax(samples, training_kw):
    jcfg, cfg, jparams, g, w = _setup(samples, training_kw)
    key = jax.random.PRNGKey(7)
    tn, tk = _batch_draws(jcfg, jax.random.split(key, B), g.nlist.shape[-1])
    jgraph = JGraph(*map(jnp.asarray, g))
    tgraph = Graph(_t(g.atoms), _t(g.nlist), _t(g.edges), _t(g.inv_degree))
    _check_value_and_grads(
        lambda p: jnp.sum(jgnn.apply_batched(p, jcfg, jgraph, training=True, rng=key)
                          * jnp.asarray(w)),
        lambda p: torch.sum(gnn.apply_batched(p, cfg, tgraph, training=True, noise=tn,
                                              dropout_mask=tk) * _t(w)),
        jparams)


@pytest.mark.parametrize("training_kw", [OFF, {}], ids=["draws_off", "draws_on"])
def test_apply_banded_fragments_matches_jax(samples, training_kw):
    jcfg, cfg, jparams, g, w = _setup(samples, training_kw)
    rngs = jax.random.split(jax.random.PRNGKey(7), B)
    tn, tk = _batch_draws(jcfg, rngs, g.nlist.shape[-1])
    jgraph = JGraph(*map(jnp.asarray, g))
    tgraph = Graph(_t(g.atoms), _t(g.nlist), _t(g.edges), _t(g.inv_degree))
    _check_value_and_grads(
        lambda p: jnp.sum(jinfer.apply_banded_fragments(p, jcfg, jgraph, training=True,
                                                        rngs=rngs, interpret=True)
                          * jnp.asarray(w)),
        lambda p: torch.sum(infer.apply_banded_fragments(p, cfg, tgraph, training=True,
                                                         noise=tn, dropout_mask=tk) * _t(w)),
        jparams)


@pytest.mark.parametrize("training_kw", [OFF, {}], ids=["draws_off", "draws_on"])
def test_apply_banded_trainable_matches_jax(samples, training_kw):
    jcfg, cfg, jparams, _, _ = _setup(samples, training_kw)
    # one graph of several fragments end to end: a band narrower than the graph
    frags = samples[:6]
    n = sum(s.n for s in frags)
    offs = np.cumsum([0] + [s.n for s in frags[:-1]])
    nlist = np.concatenate([s.graph.nlist + o for s, o in zip(frags, offs)]).astype(np.int32)
    cat = lambda f: np.concatenate([getattr(s.graph, f) for s in frags])  # noqa: E731
    g = (cat("atoms"), nlist, cat("edges"), inv_degree_from_nlist(nlist))
    plan = jb.band_plan(nlist, g[2])
    assert plan.num_tiles > 1 and plan.window < plan.n_padded
    w = np.concatenate([s.w for s in frags])
    key = jax.random.PRNGKey(11)
    noise, keep = _jax_draws(key, jcfg, n, nlist.shape[1])
    tn, tk = _to_torch_draws(noise, keep)
    jgraph = JGraph(*map(jnp.asarray, g))
    tgraph = Graph(*map(_t, g))
    tplan = tb.BandPlan(plan.lo, plan.window, plan.block_rows, plan.n_padded)
    _check_value_and_grads(
        lambda p: jnp.sum(jinfer.apply_banded_trainable(p, jcfg, jgraph, plan, training=True,
                                                        rng=key, interpret=True)
                          * jnp.asarray(w)),
        lambda p: torch.sum(infer.apply_banded_trainable(p, cfg, tgraph, tplan, training=True,
                                                         noise=tn, dropout_mask=tk) * _t(w)),
        jparams)


def test_noised_real_slot_keeps_its_message(samples):
    """A real slot whose noised distance is <= 0 still carries a message
    (the mask and the band's occupancy come from the distances before the
    noise): the kernel path equals the plain path and the gather forward."""
    cfg = ModelConfig(**dict(SMALL, dropout=False))
    params = gnn.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    g, _, _ = batch_samples(samples[:B], PAD)
    tgraph = Graph(_t(g.atoms), _t(g.nlist), _t(g.edges), _t(g.inv_degree))
    noise = torch.zeros(tuple(g.edges.shape))
    noise[0, 0, 0] = -(float(g.edges[0, 0, 0]) / cfg.noise) - 1.0
    assert g.edges[0, 0, 0] > 0 and g.edges[0, 0, 0] + cfg.noise * noise[0, 0, 0] < 0
    kw = dict(training=True, noise=noise)
    got = infer.apply_banded_fragments(params, cfg, tgraph, **kw)
    plain = infer.apply_banded_fragments(params, cfg, tgraph, use_kernels=False, **kw)
    gather = gnn.apply_batched(params, cfg, tgraph, **kw)
    clean = infer.apply_banded_fragments(params, cfg, tgraph)
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, gather, rtol=2e-4, atol=2e-4)
    assert not torch.allclose(got[0, 0], clean[0, 0])


def test_training_draws_from_generator(samples):
    """Without given draws, a training forward draws from the generator:
    the same seed gives the same peaks, and a forward with neither raises."""
    cfg = ModelConfig(**SMALL)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g, _, _ = batch_samples(samples[:B], PAD)
    tgraph = Graph(_t(g.atoms), _t(g.nlist), _t(g.edges), _t(g.inv_degree))
    run = lambda seed: infer.apply_banded_fragments(  # noqa: E731
        params, cfg, tgraph, training=True, generator=torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert not torch.allclose(run(5), run(6))
    with pytest.raises(ValueError, match="generator"):
        infer.apply_banded_fragments(params, cfg, tgraph, training=True)
    with pytest.raises(ValueError, match="shape"):
        gnn.apply_batched(params, cfg, tgraph, training=True, noise=torch.zeros(2, 2),
                          generator=torch.Generator())


def test_trainable_mask_matches_jax():
    jcfg = JModelConfig(**SMALL)
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    want = jgnn.trainable_mask(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got = gnn.trainable_mask(params)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert gnn.count_params(params) == jgnn.count_params(jparams)
    assert len(gnn.trainable_leaves(params)) == sum(jax.tree_util.tree_leaves(want))


def test_fragment_band_plan_matches_jax():
    for b, pad in ((4, 128), (8, 256), (3, 384)):
        want = jinfer.fragment_band_plan(b, pad)
        got = infer.fragment_band_plan(b, pad)
        np.testing.assert_array_equal(got.lo, want.lo)
        assert (got.window, got.block_rows, got.n_padded) == (
            want.window, want.block_rows, want.n_padded)
    with pytest.raises(ValueError):
        infer.fragment_band_plan(2, 100)
