"""The width helpers of the kernel wrappers (``nmrgnn_tpu_torch/ops/
mp.py`` and ``ops/banded.py``): a node table and its weights zero-padded to the MP kernel's
width, edge channels in groups, an EdgeFC zero-padded to the fused
build's width. Each padded or grouped plain computation against the
unpadded plain one (float32, within 1e-6 of the output's largest value:
the padded and grouped sums are the same sums, taken by the CPU's matrix
products in another blocking); and the path rule at the widths the
hyperparameter search samples, against the JAX package's."""
import jax
import numpy as np
import pytest
import torch

from nmrgnn_tpu import ModelConfig as JModelConfig
from nmrgnn_tpu import init_params as jinit_params
from nmrgnn_tpu.data.embeddings import load_standards
from nmrgnn_tpu.graph import Graph as JGraph
from nmrgnn_tpu.models.serving import ServingModel as JServingModel
from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu.train.trainer import banded_fragments_eligible as jeligible
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph, inv_degree_from_nlist
from nmrgnn_tpu_torch.library import params_from_numpy
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import banded as tb
from nmrgnn_tpu_torch.ops import blocksparse as tbs
from nmrgnn_tpu_torch.ops import mp as tmp
from nmrgnn_tpu_torch.ops.edge import edge_features
from nmrgnn_tpu_torch.train.trainer import banded_fragments_eligible

torch.set_num_threads(2)


def _close(got, want):
    """Within 1e-6 of the largest value of ``want`` (at least 1)."""
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * max(float(want.abs().max()), 1.0))


def _case(n, k, f, e, seed):
    rng = np.random.default_rng(seed)
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-40, 40, (n, k)), 0, n - 1)
    nlist = nlist.astype(np.int32)
    dists = rng.uniform(0.05, 0.2, (n, k)).astype(np.float32)
    dists[rng.uniform(size=(n, k)) < 0.15] = 0.0
    efeat = rng.normal(size=(n, k, e)).astype(np.float32) * (dists > 0)[..., None]
    plan = tb.band_plan(nlist, dists)
    pad = plan.n_padded - n
    nodes = np.pad(rng.normal(size=(n, f)).astype(np.float32), ((0, pad), (0, 0)))
    w = (rng.normal(size=(f, f, e)) / np.sqrt(f)).astype(np.float32)
    inv = np.pad(inv_degree_from_nlist(nlist), (0, pad))
    t = [torch.from_numpy(a) for a in (nlist, dists, efeat, nodes, w, inv)]
    return plan, t


def test_width_choices():
    assert [tmp.mp_width(f) for f in (1, 32, 64, 96, 128, 200, 256, 320, 512)] == [
        64, 64, 64, 128, 128, 256, 256, 512, 512]
    # past 512: a multiple of 256, in column blocks of 256 (the F-split)
    assert [tmp.mp_width(f) for f in (513, 768, 1701, 2407)] == [768, 768, 1792, 2560]
    assert tmp.mp_split(512) == (512, 1) and tmp.mp_split(768) == (256, 3)
    with pytest.raises(ValueError):
        tmp.mp_width(0)
    assert [tmp.mp_group_size(f) for f in (64, 256, 512, 768)] == [4, 4, 2, 4]
    assert tmp.channel_groups(9) == [(0, 4), (4, 8), (8, 9)]
    assert tmp.channel_groups(3) == [(0, 3)]
    assert tmp.channel_groups(5, 2) == [(0, 2), (2, 4), (4, 5)]
    assert [tb.fused_width(h) for h in (16, 64, 128, 200, 256, 300, 512, 1000, 2048)] == [
        128, 128, 128, 256, 256, 512, 512, 1024, 2048]
    with pytest.raises(NotImplementedError):
        tb.fused_width(2049)
    # atoms a fused block takes: a power of two dividing B whose slots fit
    # one EdgeFC pass, else one atom whose slots run in several passes
    assert tb.fused_rows(16, 128, 128) == 8 and tb.fused_rows(12, 128, 128) == 8
    assert tb.fused_rows(16, 256, 128) == 4 and tb.fused_rows(12, 256, 64) == 4
    assert tb.fused_rows(100, 128, 128) == 1 and tb.fused_rows(65, 256, 128) == 1
    assert tb.fused_rows(160, 128, 128) == 1 and tb.fused_rows(16, 512, 128) == 2
    with pytest.raises(NotImplementedError):
        tb.fused_rows(4097, 128, 128)
    assert [tb.fused_compute(False, 512, 16), tb.fused_compute(True, 128, 4096),
            tb.fused_compute(True, 256, 160), tb.fused_compute(True, 256, 2048),
            tb.fused_compute(True, 512, 16)] == [0, 1, 1, 2, 2]
    # band-build rows: fewer as K grows, so the staged slots stay small
    assert [tb.build_rows(128, k) for k in (16, 160, 1000, 3000)] == [4, 4, 2, 1]
    # each output block's chain: every input block, its own last
    assert tmp.mp_split_steps(3, [(0, 1)]) == [
        (0, [(1, (0, 1)), (2, (0, 1)), (0, (0, 1))]),
        (1, [(0, (0, 1)), (2, (0, 1)), (1, (0, 1))]),
        (2, [(0, (0, 1)), (1, (0, 1)), (2, (0, 1))])]
    assert tb.poly_group_size(64) == 4 and tb.poly_group_size(340) == 3
    with pytest.raises(NotImplementedError):
        tb.poly_group_size(1024)


@pytest.mark.parametrize("f,e", [(96, 3), (32, 8), (320, 2)])
def test_padded_node_table_equals_unpadded(f, e):
    """A layer on the node table and w zero-padded to the kernel's width,
    sliced back, equals the layer at the table's own width; the padded
    columns hold act(0) + 0."""
    plan, (nl, d, ef, x, w, iv) = _case(300, 12, f, e, seed=f)
    M = tb.build_band_plain(nl, ef, plan)
    fp = tmp.mp_width(f)
    got = tb.mp_banded_plain(M, plan, tmp.pad_columns(x, fp), tmp.pad_mp_weights(w, fp), iv)
    _close(got[:, :f], tb.mp_banded_plain(M, plan, x, w, iv))
    torch.testing.assert_close(got[:, f:], torch.full_like(got[:, f:], np.log(2.0)))
    part = tb.mp_banded_partial_plain(M, plan.lo, tmp.pad_columns(x, fp),
                                      tmp.pad_mp_weights(w, fp))
    _close(part[:, :f], tb.mp_banded_partial_plain(M, plan.lo, x, w))
    assert not part[:, f:].any()


@pytest.mark.parametrize("f,e", [(768, 1), (768, 3), (600, 2)])
def test_f_split_chains_sum_to_the_layer(f, e):
    """The F-split as the kernels run it, through the wrappers' ``mp.chain``
    with the plain partial sum and the epilogue as its steps: for each
    output block, the partial sums of every input block's columns against
    w's block and of every channel group, chained in ``mp_split_steps``'
    order, then the epilogue with the output block's residual columns,
    equal the layer at the table's own width; the chains without the
    epilogue equal the partial layer."""
    plan, (nl, d, ef, x, w, iv) = _case(300, 12, f, e, seed=f + e)
    M = tb.build_band_plain(nl, ef, plan)
    fp = tmp.mp_width(f)
    fb, nb = tmp.mp_split(fp)
    xp, wp = tmp.pad_columns(x, fp), tmp.pad_mp_weights(w, fp)
    tiles = torch.arange(plan.num_tiles)
    groups = tmp.channel_groups(e, tmp.mp_group_size(fp))

    def partial(i, j, c0, c1, acc):
        p = tb.mp_banded_partial_plain(M[:, c0:c1], plan.lo, xp[:, i * fb:(i + 1) * fb],
                                       wp[i * fb:(i + 1) * fb, j * fb:(j + 1) * fb, c0:c1])
        return p if acc is None else acc + p

    def final(i, j, c0, c1, acc):
        return tb._mp_epilogue(partial(i, j, c0, c1, acc), tiles, xp[:, j * fb:(j + 1) * fb],
                               iv, "softplus")

    _close(tmp.chain(nb, groups, f, partial, final), tb.mp_banded_plain(M, plan, x, w, iv))
    _close(tmp.chain(nb, groups, f, partial), tb.mp_banded_partial_plain(M, plan.lo, x, w))


@pytest.mark.parametrize("f,e", [(128, 3), (128, 8), (768, 3), (1024, 5)])
@pytest.mark.parametrize("with_final", [True, False])
def test_chain_launches_in_the_kernels_order(f, e, with_final):
    """``mp.chain``'s launches, as every MP wrapper makes them: each
    output block's chain takes every input block's channel groups in
    order, its own input block last, ends in one final launch (a partial
    one for a call with no epilogue), and hands each launch but the
    chain's first the sum before it; the blocks are joined in order and
    cut to F columns."""
    fp = tmp.mp_width(f)
    fb, nb = tmp.mp_split(fp)
    groups = tmp.channel_groups(e, tmp.mp_group_size(fp))
    seen = []

    def step(kind):
        def run(i, j, c0, c1, acc):
            out = torch.full((2, fb), float(len(seen)))
            seen.append((kind, i, j, (c0, c1), acc, out))
            return out
        return run

    got = tmp.chain(nb, groups, f, step("partial"), step("final") if with_final else None)
    assert len(seen) == nb * nb * len(groups)
    per = nb * len(groups)
    for j in range(nb):
        launches = seen[j * per:(j + 1) * per]
        assert {s[2] for s in launches} == {j}
        others = [i for i in range(nb) if i != j]
        assert [(s[1], s[3]) for s in launches] == [(i, g) for i in others + [j] for g in groups]
        kinds = [s[0] for s in launches]
        assert kinds == ["partial"] * (per - 1) + ["final" if with_final else "partial"]
        assert launches[0][4] is None
        assert all(b[4] is a[5] for a, b in zip(launches, launches[1:]))
    want = torch.cat([seen[(j + 1) * per - 1][5] for j in range(nb)], 1)[:, :f]
    assert torch.equal(got, want) and got.shape == (2, f)


@pytest.mark.parametrize("e,size", [(8, 4), (64, 4), (5, 2), (3, 4)])
def test_channel_groups_sum_to_the_layer(e, size):
    """The groups' partial sums, chained in order, then the epilogue, equal
    the layer over every channel; the builds' group bands are M's channels."""
    plan, (nl, d, ef, x, w, iv) = _case(260, 8, 64, e, seed=e)
    M = tb.build_band_plain(nl, ef, plan)
    acc = None
    for c0, c1 in tmp.channel_groups(e, size):
        assert torch.equal(tb.build_band_plain(nl, ef[..., c0:c1].contiguous(), plan),
                           M[:, c0:c1])
        part = tb.mp_banded_partial_plain(M[:, c0:c1], plan.lo, x, w[..., c0:c1])
        acc = part if acc is None else acc + part
    _close(acc, tb.mp_banded_partial_plain(M, plan.lo, x, w))
    got = tb._mp_epilogue(acc, torch.arange(plan.num_tiles), x, iv, "softplus")
    _close(got, tb.mp_banded_plain(M, plan, x, w, iv))


@pytest.mark.parametrize("h,hp,layers", [(16, 128, 3), (64, 128, 2), (200, 256, 3),
                                         (32, 128, 1)])
def test_padded_edge_fc_equals_unpadded(h, hp, layers):
    """The EdgeFC zero-padded to the fused kernel's width, over an RBF of
    the padded width at the true width's spacing (the kernel's centres),
    gives the unpadded edge features."""
    cfg = ModelConfig(edge_hidden_size=h, edge_fc_layers=layers, edge_feature_size=5)
    rng = np.random.default_rng(h)
    params = []
    for i in range(layers - 1):
        params.append({"kernel": torch.from_numpy(rng.normal(size=(h, h)).astype(np.float32)
                                                  / np.float32(np.sqrt(h))),
                       "bias": torch.from_numpy(rng.normal(size=h).astype(np.float32))})
    params.append({"kernel": torch.from_numpy(rng.normal(size=(h, 5)).astype(np.float32)),
                   "bias": torch.from_numpy(rng.normal(size=5).astype(np.float32))})
    d = torch.from_numpy(rng.uniform(0.0, 0.3, (200, 12)).astype(np.float32))
    d[:, -3:] = 0.0
    gap = (cfg.rbf_high - cfg.rbf_low) / (h - 1)
    want = edge_features(d, params, rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                         activation_name=cfg.fc_activation)
    got = edge_features(d, tb.pad_edge_fc(params, hp), rbf_low=cfg.rbf_low,
                        rbf_high=cfg.rbf_low + gap * (hp - 1), activation_name=cfg.fc_activation)
    _close(got, want)


def test_blocksparse_padded_and_grouped_equal_unpadded():
    """The block-sparse layer on a padded table, and its channels' partial
    sums chained, equal the layer at the table's own width."""
    plan, (nl, d, ef, x, w, iv) = _case(300, 8, 96, 6, seed=2)
    s = tbs.block_structure(nl.numpy(), d.numpy(), 128, pair_rounding=32, group=1)
    pad = s.n_padded - x.shape[0]
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    iv = torch.nn.functional.pad(iv, (0, pad))
    A = tbs.build_block_adjacency_plain(nl, ef, s)
    want = tbs.mp_blocksparse_plain(A, s, x, w, iv)
    fp = tmp.mp_width(96)
    got = tbs.mp_blocksparse_plain(A, s, tmp.pad_columns(x, fp), tmp.pad_mp_weights(w, fp), iv)
    _close(got[:, :96], want)
    for c0, c1 in tmp.channel_groups(6):
        assert torch.equal(tbs.build_block_adjacency_plain(nl, ef[..., c0:c1].contiguous(), s),
                           A[:, c0:c1])


SEARCH_WIDTHS = [
    dict(atom_feature_size=256, edge_feature_size=8, edge_hidden_size=64),
    dict(atom_feature_size=128, edge_feature_size=64, edge_hidden_size=256),
    dict(atom_feature_size=96, edge_feature_size=8, edge_hidden_size=64),
    dict(atom_feature_size=32, edge_feature_size=64, edge_hidden_size=256),
    dict(atom_feature_size=256, edge_feature_size=8, edge_hidden_size=128,
         neighbor_number=12),
    dict(atom_feature_size=64, edge_feature_size=2, edge_hidden_size=16, mp_layers=6),
]
# past the kernels' widths before fault C6 was repaired: F > 512, an
# EdgeFC wider than 256, K > 128
C6_WIDTHS = [
    dict(atom_feature_size=768, edge_feature_size=1, edge_hidden_size=128),
    dict(atom_feature_size=768, edge_feature_size=3, edge_hidden_size=128),
    dict(atom_feature_size=128, edge_feature_size=3, edge_hidden_size=512),
    dict(atom_feature_size=128, edge_feature_size=3, edge_hidden_size=128,
         neighbor_number=160),
]


@pytest.mark.parametrize("kw", SEARCH_WIDTHS + C6_WIDTHS)
def test_path_rule_at_other_widths_matches_jax(kw):
    """At the search space's widths both packages pick the same training
    path (banded_fragments_eligible) and serving path (_resolve_mode), and
    the fused-build choice (fused_build_ok), on a 600-atom and a
    12,288-atom banded graph."""
    for b, pad_to in ((8, 256), (4, 128), (32, 256)):
        assert banded_fragments_eligible(ModelConfig(**kw), b, pad_to) == \
            jeligible(JModelConfig(**kw), b, pad_to)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, load_standards())
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    k = cfg.neighbor_number
    for n, spread in ((600, 60), (12288, 100)):
        rng = np.random.default_rng(n)
        nlist = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread, (n, k)), 0,
                        n - 1).astype(np.int32)
        dists = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
        g = Graph(np.zeros((n, 10), np.float32), nlist, dists, inv_degree_from_nlist(nlist))
        for precision in ("exact", "fast"):
            jsm = JServingModel(jparams, jcfg, use_pallas=True, reorder=False,
                                precision=precision)
            sm = ServingModel(params, cfg, device="cpu", reorder=False, precision=precision)
            mode = sm._resolve_mode(g)
            assert mode == jsm._resolve_mode(JGraph(*g)), (n, precision)
            # the kernels of the path take the widths it sends them
            fp = tmp.mp_width(cfg.atom_feature_size)
            assert fp % tmp.mp_split(fp)[0] == 0
            if mode != "blocksparse":
                B = sm._plan.block_rows
                tb.build_rows(B, k, min(cfg.edge_feature_size, 4))
                if precision == "exact":
                    hp = tb.fused_width(cfg.edge_hidden_size)
                    tb.fused_rows(k, hp, B)
        plan = tb.band_plan(nlist, dists)
        for ob in (4, 2):
            assert tb.fused_build_ok(plan, cfg.edge_hidden_size, cfg.edge_feature_size, k, ob) \
                == jb.fused_build_ok(plan, cfg.edge_hidden_size, cfg.edge_feature_size, k, ob)
