"""The port's attention family (AMPLayer) against the JAX package's: the
layer ops, init_params, the gather forward (inference, and training with
JAX's own noise and dropout draws handed to the port) and the banded
forward ``apply_banded_attention`` (exact, Chebyshev, bfloat16, and its
gradients through the differentiable band wrappers). The JAX side runs on
the CPU with Pallas in interpret mode; on the CPU the port's kernel
wrappers take their plain versions. Tolerances: float32 rtol/atol 2e-4;
bfloat16 and the Chebyshev stage within the JAX package's exact-vs-fast
band (rtol 0.05, atol 1.0 ppm); gradients within 2e-4 of their max, as
tests/test_torch_train_step.py.

The padding row: the JAX package's banded forward adds the padding
slots' softmax mass at row 0 (``nmrgnn_tpu/models/infer.py:515-526``),
while ``gnn.apply`` sends it to the row each padding slot names, which
after the RCM permutation (``pin_zero=False``) is the old row 0's new
place. The port's banded forward computes what ``gnn.apply`` computes;
``test_banded_attention_on_a_reordered_padded_graph`` fails on a copy of
the JAX form."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrgnn_tpu import ModelConfig as JModelConfig
from nmrgnn_tpu.data.reorder import rcm_order as jrcm_order
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.models import gnn as jgnn
from nmrgnn_tpu.models import infer as jinfer
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.ops import message_passing as jmp
from nmrgnn_tpu.ops.edgefn import fit_edge_chebyshev as jfit_cheb
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.data.reorder import permute_graph
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import params_from_numpy
from nmrgnn_tpu_torch.models import gnn, infer
from nmrgnn_tpu_torch.ops import _cuda
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops import message_passing as tmp
from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev

torch.set_num_threads(2)

ATTN = dict(edge_hidden_size=16, mp_layers=2, fc_layers=2, edge_fc_layers=2,
            mp_type="attention", noise=0.025, dropout=True)
OFF = dict(noise=0.0, dropout=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(f=64, **kw):
    d = dict(ATTN, atom_feature_size=f, **kw)
    return JModelConfig(**d), ModelConfig(**d)


def _params(jcfg, seed=0):
    jparams = jgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _graph(n=256, k=16, seed=0, pad_share=0.2):
    """A banded graph (tests/test_banded.py:187-192) with a share of
    padding slots (index 0, distance 0) and one atom with no real
    neighbor."""
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    d = rng.uniform(0.05, 0.2, (n, k)).astype(np.float32)
    pad = rng.uniform(size=(n, k)) < pad_share
    pad[5] = True
    d[pad], nlist[pad] = 0.0, 0
    atoms = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return (atoms, nlist, d, inv_degree_from_nlist(nlist))


def _plans(nlist, d):
    plan = jb.band_plan(nlist, d)
    return plan, tb.BandPlan(plan.lo, plan.window, plan.block_rows, plan.n_padded)


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _in_fast_band(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0.05, atol=1.0)


def test_attention_ops_match_jax():
    rng = np.random.default_rng(1)
    n, k, f, e = 200, 16, 64, 3
    nodes = rng.normal(size=(n, f)).astype(np.float32)
    nlist = rng.integers(0, n, (n, k)).astype(np.int32)
    edges = rng.normal(size=(n, k, e)).astype(np.float32)
    inv = rng.uniform(0.05, 1.0, n).astype(np.float32)
    wq = rng.normal(size=(f, e)).astype(np.float32) / 8
    wk = rng.normal(size=(e, e)).astype(np.float32)
    wv = rng.normal(size=(f, f)).astype(np.float32) / 8
    want_a = jmp.attention_weights(*map(jnp.asarray, (wq, wk, nodes, edges, inv)))
    got_a = tmp.attention_weights(*map(_t, (wq, wk, nodes, edges, inv)))
    _close(got_a, want_a, 1e-5)
    np.testing.assert_allclose(got_a.sum(-1).numpy(), 1.0, rtol=1e-5)
    want = jmp.amp_layer(*map(jnp.asarray, (wq, wk, wv, nodes, nlist, edges, inv)))
    got = tmp.amp_layer(*map(_t, (wq, wk, wv, nodes, nlist, edges, inv)))
    _close(got, want)


@pytest.mark.parametrize("f", [64, 128])
def test_init_params_shapes_and_count_match_jax(f):
    jcfg, cfg = _cfgs(f)
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert gnn.tree_map(lambda t: tuple(t.shape), params) == shapes
    assert gnn.count_params(params) == jgnn.count_params(jparams)
    assert jax.tree_util.tree_leaves(gnn.trainable_mask(params)) == \
        jax.tree_util.tree_leaves(jgnn.trainable_mask(jparams))
    # glorot limits: sqrt(6 / (fan_in + fan_out)) of each leaf's own two dims
    for p in params["mp"]:
        for name, (a, b) in (("wq", (f, 3)), ("wk", (3, 3)), ("wv", (f, f))):
            assert float(p[name].abs().max()) <= np.sqrt(6.0 / (a + b))


def _jax_draws(key, cfg, n, k):
    """(noise [n, k], keep [n, F/2]) as gnn.apply draws them from ``key``."""
    noise = keep = None
    if cfg.noise > 0:
        key, nk = jax.random.split(key)
        noise = jax.random.normal(nk, (n, k), jnp.float32)
    if cfg.dropout:
        key, dk = jax.random.split(key)
        keep = jax.random.bernoulli(dk, 1.0 - cfg.dropout_rate, (n, cfg.atom_feature_size // 2))
    return (None if noise is None else _t(noise),
            None if keep is None else _t(keep).to(torch.bool))


def _check_value_and_grads(jfn, tfn, jparams, tol=2e-4):
    jl, jg = jax.value_and_grad(jfn)(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    leaves = gnn.trainable_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = tfn(params)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=tol, abs=tol)
    want = [a for p, a in jax.tree_util.tree_leaves_with_path(jg)
            if "peak_" not in jax.tree_util.keystr(p)]
    assert len(want) == len(grads) == 3 * 2 + 2 * 2 + 2 * 2 + 2 + 1
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * (np.abs(w).max() + 1e-9))


@pytest.mark.parametrize("training_kw", [OFF, {}], ids=["inference", "training"])
def test_gather_forward_matches_jax(training_kw):
    jcfg, cfg = _cfgs(**training_kw)
    jparams, params = _params(jcfg)
    g = _graph(n=200, seed=2)
    jg, tg = JGraph(*map(jnp.asarray, g)), Graph(*map(_t, g))
    _close(gnn.apply(params, cfg, tg), jgnn.apply(jparams, jcfg, jg))
    key = jax.random.PRNGKey(7)
    noise, keep = _jax_draws(key, jcfg, *g[1].shape)
    w = np.random.default_rng(0).uniform(size=200).astype(np.float32)
    _check_value_and_grads(
        lambda p: jnp.sum(jgnn.apply(p, jcfg, jg, training=True, rng=key) * w),
        lambda p: torch.sum(gnn.apply(p, cfg, tg, training=True, noise=noise,
                                      dropout_mask=keep) * _t(w)),
        jparams)


@pytest.mark.parametrize("f,precision", [(64, "exact"), (128, "exact"), (64, "cheb"),
                                         (64, "bfloat16")])
def test_banded_attention_matches_jax(f, precision):
    """On a graph whose padding slots name row 0: the JAX package's banded
    forward, and its gather forward in float32."""
    jcfg, cfg = _cfgs(f, **(dict(compute_dtype="bfloat16") if precision == "bfloat16" else {}))
    jparams, params = _params(jcfg, seed=1)
    g = _graph(seed=3)
    plan, tplan = _plans(g[1], g[2])
    jg, tg = JGraph(*map(jnp.asarray, g)), Graph(*map(_t, g))
    jcheb = cheb = None
    if precision == "cheb":
        kw = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, rbf_count=cfg.edge_hidden_size,
                  activation=cfg.fc_activation, degree=64)
        jcheb = jfit_cheb(jparams["edge_fc"], **kw)
        cheb = fit_edge_chebyshev(params["edge_fc"], **kw)
    want = jinfer.apply_banded_attention(jparams, jcfg, jg, plan, interpret=True, cheb=jcheb)
    _cuda.reset_launch_counts()
    got = infer.apply_banded_attention(params, cfg, tg, tplan, cheb=cheb)
    assert infer.padding_rows(g[1], g[2]).tolist() == [0]
    if precision == "exact":
        _close(got, want)
        _close(got, jgnn.apply(jparams, jcfg, jg))
    else:
        _in_fast_band(got, want)
        _in_fast_band(got, jgnn.apply(jparams, jcfg, jg))
        assert np.abs(got.numpy() - np.asarray(want)).mean() < 0.05
    plain = infer.apply_banded_attention(params, cfg, tg, tplan, cheb=cheb, use_kernels=False)
    _close(got, plain, 1e-5)


@pytest.mark.parametrize("training_kw", [OFF, {}], ids=["draws_off", "draws_on"])
def test_banded_attention_gradients_match_jax(training_kw):
    """``differentiable=True`` (build_band_df, mp_banded_partial_df): value
    and the gradient of every trainable leaf against ``jax.grad`` of the
    JAX package's differentiable banded forward, with its draws."""
    jcfg, cfg = _cfgs(**training_kw)
    jparams, _ = _params(jcfg, seed=2)
    g = _graph(n=200, seed=4)
    plan, tplan = _plans(g[1], g[2])
    jg, tg = JGraph(*map(jnp.asarray, g)), Graph(*map(_t, g))
    key = jax.random.PRNGKey(5)
    noise, keep = _jax_draws(key, jcfg, *g[1].shape)
    w = np.random.default_rng(1).uniform(size=200).astype(np.float32)
    _check_value_and_grads(
        lambda p: jnp.sum(jinfer.apply_banded_attention(
            p, jcfg, jg, plan, interpret=True, differentiable=True, training=True,
            rng=key) * w),
        lambda p: torch.sum(infer.apply_banded_attention(
            p, cfg, tg, tplan, differentiable=True, training=True, noise=noise,
            dropout_mask=keep) * _t(w)),
        jparams)


def test_banded_attention_on_a_reordered_padded_graph():
    """The RCM permutation sends row 0 elsewhere: the port's banded forward
    on the permuted graph, put back in the original order, equals the JAX
    package's gather forward on the original graph within 2e-4; the JAX
    package's banded forward (row 0's term) is off by far more."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, seed=3)
    g = _graph(seed=5)
    want = np.asarray(jgnn.apply(jparams, jcfg, JGraph(*map(jnp.asarray, g))))
    order = jrcm_order(g[1], g[2])
    assert order[0] != 0
    gp, inverse = permute_graph(Graph(*g), order, pin_zero=False)
    rows = infer.padding_rows(gp.nlist, gp.edges)
    assert rows.tolist() == [int(np.flatnonzero(order == 0)[0])]
    plan, tplan = _plans(gp.nlist, gp.edges)
    got = infer.apply_banded_attention(params, cfg, Graph(*map(_t, gp)), tplan).numpy()
    _close(got[inverse], want)
    jax_banded = np.asarray(jinfer.apply_banded_attention(
        jparams, jcfg, JGraph(*map(jnp.asarray, gp)), plan, interpret=True))[inverse]
    assert np.abs(jax_banded - want).max() > 0.05


def test_banded_attention_with_two_padding_rows():
    """Padding slots that name two rows (0 and 7) give two rank-1 terms:
    equal to the JAX package's gather forward. A negative index names no
    row."""
    g = _graph(n=256, seed=6)
    nl, d = g[1].copy(), g[2].copy()
    nl[10:40, :4], d[10:40, :4] = 7, 0.0
    assert infer.padding_rows(nl, d).tolist() == [0, 7]
    assert infer.padding_rows(_t(nl), _t(d)).tolist() == [0, 7]
    neg = nl.copy()
    neg[11, :2] = -1
    assert infer.padding_rows(neg, d).tolist() == [0, 7]
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, seed=4)
    g = (g[0], nl, d, inv_degree_from_nlist(nl))
    want = jgnn.apply(jparams, jcfg, JGraph(*map(jnp.asarray, g)))
    _, tplan = _plans(nl, d)
    _close(infer.apply_banded_attention(params, cfg, Graph(*map(_t, g)), tplan), want)
