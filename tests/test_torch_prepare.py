"""Serving's request preparation on the CPU: ``permute_tile_bounds_plain``
(the plain version of the preparation kernel) against ``permute_graph``,
the band planners computed from tile bounds against the JAX package's
planners, and ``ServingModel`` prepared that way against the same model
served without the reorder on frames permuted on the host, over a short
walk of frames with plan hits and misses, on every path that prepares on
the device; "blocksparse" keeps the host's permutation."""
import numpy as np
import pytest
import torch

from nmrgnn_tpu.ops import banded as jb
from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.models import gnn, serving
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import banded as tb

torch.set_num_threads(2)

SMALL = dict(atom_feature_size=32, edge_hidden_size=16, mp_layers=2, fc_layers=2,
             edge_fc_layers=2, dropout=False, noise=0.0)
K = 8


def _graph(n, spread=20, seed=0, empty=(), k=K) -> Graph:
    """A banded graph (nlist = i + randint(-spread, spread), as
    tests/test_banded.py:187-192 builds them) with one padding slot a row
    (index 0, distance 0) and the rows ``empty`` without a real neighbor."""
    rng = np.random.default_rng(seed)
    atoms = np.eye(10, dtype=np.float32)[rng.integers(2, 5, n)]
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread, (n, k)),
                    0, n - 1).astype(np.int32)
    edges = rng.uniform(0.09, 0.19, (n, k)).astype(np.float32)
    nlist[:, -1], edges[:, -1] = 0, 0.0
    edges[list(empty)] = 0.0
    inv = np.where((nlist > 0).sum(1) > 0, 1.0 / np.maximum((nlist > 0).sum(1), 1), 0.0)
    return Graph(atoms, nlist, edges, inv.astype(np.float32))


def _same_plan(got, want):
    np.testing.assert_array_equal(got.lo, want.lo)
    assert (got.window, got.block_rows, got.n_padded) == (want.window, want.block_rows,
                                                         want.n_padded)


def _same_classes(got, want):
    assert (got.block_rows, got.n_padded) == (want.block_rows, want.n_padded)
    assert len(got.classes) == len(want.classes)
    for c, w in zip(got.classes, want.classes):
        np.testing.assert_array_equal(c.ids, w.ids)
        np.testing.assert_array_equal(c.lo, w.lo)
        assert c.window == w.window


def _tensors(g: Graph):
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dt) for a, dt in zip(g, dtypes)]


@pytest.mark.parametrize("n,rows,negative", [(300, 64, False), (700, 64, True),
                                             (1024, 128, False), (50, 64, False)])
def test_plain_preparation_equals_permute_graph(n, rows, negative):
    g = _graph(n, empty=range(n // 3, min(n, n // 3 + 70)))
    order = rcm_order(g.nlist, g.edges)
    if negative:  # a negative index is counted from the end, as numpy counts it
        g.nlist[::7, 2] = -1
    want, inverse = permute_graph(g, order, pin_zero=False)
    order_t = torch.as_tensor(order.astype(np.int32))
    inv_t = torch.as_tensor(inverse.astype(np.int32))
    *got, bounds = tb.permute_tile_bounds(*_tensors(g), order_t, inv_t, rows)
    for name, a, b in zip(Graph._fields, got, want):
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert bounds.dtype == torch.int32
    np.testing.assert_array_equal(bounds.numpy(), tb.tile_bounds(want.nlist, want.edges, rows))
    # without an order: the graph as it is, and its own bounds
    *same, own = tb.permute_tile_bounds(*_tensors(g), None, None, rows)
    for a, b in zip(same, g):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(own.numpy(), tb.tile_bounds(g.nlist, g.edges, rows))


def _escape(nlist, edges, plan, below: bool):
    """nlist with one real neighbor of a tile moved just outside its
    window: one column below lo_t, or at lo_t + W."""
    nl = nlist.copy()
    lo = np.asarray(plan.lo)
    b = plan.block_rows
    real = (edges > 0).any(1)
    t = next(t for t in range(len(lo)) if real[t * b:(t + 1) * b].any()
             and (lo[t] > 0 if below else lo[t] + plan.window < len(nlist)))
    row = t * b + int(np.nonzero(real[t * b:(t + 1) * b])[0][0])
    slot = int(np.nonzero(edges[row] > 0)[0][0])
    nl[row, slot] = lo[t] - 1 if below else lo[t] + plan.window
    return nl


@pytest.mark.parametrize("n,block_rows,spread", [(1000, 128, 20), (1000, 64, 20),
                                                 (2048, 128, 150), (1500, 64, 150)])
def test_planners_from_bounds_equal_jax(n, block_rows, spread):
    g = _graph(n, spread=spread, seed=n + spread, empty=range(200, 400))
    nl, e = g.nlist, g.edges
    plan = tb.band_plan(nl, e, block_rows=block_rows)
    _same_plan(plan, jb.band_plan(nl, e, block_rows=block_rows))
    # from half-height bounds joined in pairs, as serving takes them from the device
    half = tb.permute_tile_bounds(*_tensors(g), None, None, block_rows // 2)[-1].numpy()
    fine = tb.coarsen_bounds(half, 2)
    np.testing.assert_array_equal(fine, tb.tile_bounds(nl, e, block_rows))
    _same_plan(tb.band_plan_from_bounds(fine, n, block_rows), plan)
    cls = tb.band_plan_classes(nl, e, block_rows=block_rows)
    _same_classes(cls, jb.band_plan_classes(nl, e, block_rows=block_rows))
    _same_classes(tb.band_plan_classes_from_bounds(fine, n, block_rows), cls)
    # the rows without a real neighbor leave a tile empty (no real bound)
    assert (fine[:, 0] > fine[:, 1]).any()
    frames = [g] + [_graph(n, spread=spread, seed=s, empty=range(200, 400)) for s in (1, 2)]
    stack_nl, stack_e = np.stack([f.nlist for f in frames]), np.stack([f.edges for f in frames])
    _same_plan(tb.band_plan_frames(stack_nl, stack_e, block_rows=block_rows),
               jb.band_plan_frames(stack_nl, stack_e, block_rows=block_rows))
    assert tb.plan_covers(plan, nl, e) and jb.plan_covers(plan, nl, e)
    for below in (True, False):
        far = _escape(nl, e, plan, below)
        assert tb.plan_covers(plan, far, e) is jb.plan_covers(plan, far, e) is False
        assert tb.class_plan_covers(cls, far, e) == jb.class_plan_covers(cls, far, e)
        _same_plan(tb.band_plan(far, e, block_rows=block_rows),
                   jb.band_plan(far, e, block_rows=block_rows))
    for other in frames[1:]:
        assert tb.plan_covers(plan, other.nlist, other.edges) == \
            jb.plan_covers(plan, other.nlist, other.edges)
        assert tb.class_plan_covers(cls, other.nlist, other.edges) == \
            jb.class_plan_covers(cls, other.nlist, other.edges)
    assert tb.class_plan_covers(cls, nl, e) and jb.class_plan_covers(cls, nl, e)
    # another size never covers
    assert not tb.plan_covers(plan, nl[:n - block_rows], e[:n - block_rows])


def _walk(n=700):
    """Frames of one structure with plan hits and misses: distances that
    move (hits) and neighbors that reach further (misses)."""
    f0 = _graph(n, seed=0)
    rng = np.random.default_rng(1)
    out = [f0, f0._replace(edges=np.where(f0.edges > 0, f0.edges * 1.01, 0.0)
                           .astype(np.float32))]
    wide = f0.nlist.copy()
    rows = rng.choice(n, 40, replace=False)
    wide[rows, 0] = np.clip(rows + rng.choice([-1, 1], 40) * 150, 0, n - 1)
    out += [f0._replace(nlist=wide), f0, _graph(n, seed=2)._replace(atoms=f0.atoms)]
    return out


@pytest.mark.parametrize("path,precision", [
    ("banded", "exact"), ("banded", "fast"), ("banded_hbm", "exact"),
    ("banded_hbm", "fast"), ("banded_attn", "exact"), ("gather", "exact")])
def test_serving_prepared_on_the_device_equals_host_permuted(path, precision):
    attention = path in ("banded_attn", "gather")
    cfg = ModelConfig(**SMALL, mp_type="attention" if attention else "bilinear")
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sm = ServingModel(params, cfg, device="cpu", precision=precision)
    host = ServingModel(params, cfg, device="cpu", precision=precision, reorder=False)
    if path in ("banded_hbm", "gather"):  # too large a graph to resolve there on the CPU
        sm._resolved = host._resolved = path
    plans = []
    for f in _walk():
        got = sm.predict(f)
        fp, inverse = permute_graph(f, sm._order, pin_zero=False)
        want = host.predict(fp)[inverse]
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert sm._resolved == host._resolved == path
        if path == "gather":
            assert sm._plan is None
            continue
        _same_plan(sm._plan, host._plan)
        if not plans or sm._plan is not plans[-1]:  # built on this frame
            _same_plan(sm._plan, jb.band_plan(fp.nlist, fp.edges,
                                              block_rows=sm._plan.block_rows))
        assert jb.plan_covers(sm._plan, fp.nlist, fp.edges)
        plans.append(sm._plan)
        if precision == "fast":
            for a, b in ((sm._cls_plan, host._cls_plan), (sm._cls_plan_vmem,
                                                          host._cls_plan_vmem)):
                assert (a is None) == (b is None)
                if a is not None:
                    _same_classes(a, b)
    if path != "gather":
        assert len({id(p) for p in plans}) > 1 and len(set(map(id, plans))) < len(plans), \
            "the walk has both plan hits and misses"


def test_blocksparse_keeps_the_host_permutation(monkeypatch):
    cfg = ModelConfig(**SMALL)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sm = ServingModel(params, cfg, device="cpu", mode="blocksparse")
    host = ServingModel(params, cfg, device="cpu", mode="blocksparse", reorder=False)
    frames = _walk(300)[:3]
    sm.predict(frames[0])
    host.predict(frames[0])
    assert sm._resolved == host._resolved == "blocksparse"
    calls = {"permute_graph": 0, "permute_tile_bounds": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    for name in calls:
        monkeypatch.setattr(serving, name, counted(name, getattr(serving, name)))
    for f in frames:
        fp, inverse = permute_graph(f, sm._order, pin_zero=False)
        assert np.array_equal(sm.predict(f), host.predict(fp)[inverse])
    assert calls == {"permute_graph": len(frames), "permute_tile_bounds": 0}
