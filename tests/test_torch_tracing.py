"""The port's program spans (``utils.profiling.span``) on the CPU: the null
context when no profiler records, the split of a profiled
``ServingModel.predict`` and its plan misses, one ``nmrgnn.mp`` a layer in
the forwards, bit-identical peaks with a profiler on, and a trajectory's
build spans on its worker threads (read from ``utils.profiling.trace``'s
Chrome trace, as ``eval-struct --profile`` writes it)."""
import contextlib
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.data.pdb import read_structure
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.utils.profiling import span, trace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import write_synthetic_pdb  # noqa: E402

SMALL = dict(atom_feature_size=32, edge_hidden_size=16, mp_layers=2, fc_layers=2,
             edge_fc_layers=2, dropout=False, noise=0.0)
N, K = 256, 8


def _model(**kw):
    cfg = ModelConfig(**SMALL, **kw)
    return gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg


def _frame(seed, n=N, spread=20):
    """A banded graph (nlist = i + randint(-spread, spread), as
    tests/test_banded.py:187-192 builds them) with one padding slot a row."""
    rng = np.random.default_rng(seed)
    atoms = np.eye(10, dtype=np.float32)[np.random.default_rng(0).integers(2, 5, n)]
    nlist = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread, (n, K)),
                    0, n - 1).astype(np.int32)
    dists = rng.uniform(0.09, 0.19, (n, K)).astype(np.float32)
    dists[:, -1] = 0.0
    return Graph(atoms, nlist, dists, np.full(n, 1.0 / (K - 1), np.float32))


def _profiled(tmp_path, fn):
    """(fn's result, the nmrgnn.* spans of its trace as dicts with
    ``children``, the outermost first, in start order)."""
    out = tmp_path / f"trace{len(list(tmp_path.iterdir()))}"
    with trace(str(out)):
        result = fn()
    (path,) = glob.glob(str(out / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(({"name": e["name"], "tid": e["tid"], "ts": float(e["ts"]),
                     "end": float(e["ts"]) + float(e["dur"]), "children": []}
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("nmrgnn.")),
                   key=lambda s: (s["tid"], s["ts"], -s["end"]))
    roots, stack = [], []
    for s in spans:
        while stack and (stack[-1]["tid"] != s["tid"] or s["ts"] >= stack[-1]["end"]):
            stack.pop()
        (stack[-1]["children"] if stack else roots).append(s)
        stack.append(s)
    return result, sorted(roots, key=lambda s: s["ts"])


def _names(spans):
    return [s["name"] for s in spans]


def _count(spans, name):
    return sum((s["name"] == name) + _count(s["children"], name) for s in spans)


def test_span_is_one_null_context_without_a_profiler(tmp_path):
    assert span("nmrgnn.a") is span("nmrgnn.b")
    assert isinstance(span("nmrgnn.a"), contextlib.nullcontext)
    with trace(str(tmp_path)):
        assert isinstance(span("nmrgnn.a"), torch.profiler.record_function)
    assert isinstance(span("nmrgnn.a"), contextlib.nullcontext)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A banded model served frame 0 unprofiled, then frame 1 (inside
    frame 0's plan) unprofiled and profiled."""
    params, cfg = _model()
    sm = ServingModel(params, cfg, device="cpu")
    f0 = _frame(0)
    sm.predict(f0)
    f1 = f0._replace(edges=np.where(f0.edges > 0, f0.edges * 1.01, 0.0).astype(np.float32))
    off = sm.predict(f1)
    on, roots = _profiled(tmp_path_factory.mktemp("served"), lambda: sm.predict(f1))
    return sm, cfg, off, on, roots


def test_predict_spans_split_the_request_in_order(served):
    sm, cfg, _, _, roots = served
    assert sm._resolved == "banded"
    assert _names(roots) == ["nmrgnn.predict"]
    steps = roots[0]["children"]
    # the graph goes to the device as given and is permuted there
    assert _names(steps) == ["nmrgnn.h2d", "nmrgnn.permute", "nmrgnn.plan", "nmrgnn.forward",
                             "nmrgnn.readback"]
    assert _names(steps[3]["children"]) == ["nmrgnn.mp"] * cfg.mp_layers
    # a frame inside the cached plan's window: a check, no build
    assert _count(roots, "nmrgnn.plan.build") == 0


def test_peaks_bit_identical_with_the_profiler_on(served):
    _, _, off, on, _ = served
    assert on.dtype == off.dtype and np.array_equal(on, off)


def test_a_frame_that_escapes_the_plan_builds_one(tmp_path):
    params, cfg = _model()
    sm = ServingModel(params, cfg, device="cpu")
    n = 512  # four tiles: a window narrower than the structure
    f0 = _frame(0, n)
    sm.predict(f0)
    first = sm._plan
    _, inside = _profiled(tmp_path, lambda: sm.predict(f0))
    far = f0.nlist.copy()
    far[::32, 0] = n - 1 - np.arange(0, n, 32)  # the mirror row: outside any tile's window
    _, escaped = _profiled(tmp_path, lambda: sm.predict(f0._replace(nlist=far)))
    assert _count(inside, "nmrgnn.plan.build") == 0
    assert _count(escaped, "nmrgnn.plan.build") == 1
    assert _count(escaped, "nmrgnn.plan") == 1 and sm._plan is not first
    plan = escaped[0]["children"][2]
    assert plan["name"] == "nmrgnn.plan" and _names(plan["children"]) == ["nmrgnn.plan.build"]
    # the graph, then the new plan, go to the device
    assert _count(escaped, "nmrgnn.h2d") == 2


@pytest.mark.parametrize("forward", ["gather_attention", "banded_attn", "blocksparse"])
def test_one_mp_span_a_layer(tmp_path, forward):
    attention = forward != "blocksparse"
    params, cfg = _model(mp_type="attention") if attention else _model()
    g = _frame(0)
    if forward == "gather_attention":
        gt = Graph(*[torch.as_tensor(a) for a in g])
        _, roots = _profiled(tmp_path, lambda: gnn.apply(params, cfg, gt))
        assert _names(roots) == ["nmrgnn.mp"] * cfg.mp_layers
        return
    sm = ServingModel(params, cfg, device="cpu", mode="auto" if attention else "blocksparse")
    sm.predict(g)
    assert sm._resolved == forward
    _, roots = _profiled(tmp_path, lambda: sm.predict(g))
    (fwd,) = [s for s in roots[0]["children"] if s["name"] == "nmrgnn.forward"]
    assert _names(fwd["children"]) == ["nmrgnn.mp"] * cfg.mp_layers


def test_trajectory_builds_on_worker_threads(tmp_path):
    path = str(tmp_path / "traj.pdb")
    write_synthetic_pdb(path, n_atoms=120, seed=2, frames=3)
    struct = read_structure(path)
    params, cfg = _model()
    sm = ServingModel(params, cfg, device="cpu")
    out, roots = _profiled(tmp_path, lambda: list(sm.predict_trajectory(
        struct, build_workers=2, prefetch=1)))
    assert [i for i, _ in out] == [0, 1, 2]
    builds = [s for s in roots if s["name"] == "nmrgnn.build"]
    waits = [s for s in roots if s["name"] == "nmrgnn.queue_wait"]
    consumer = {s["tid"] for s in waits}
    assert len(builds) == 3 and len(consumer) == 1 and len(waits) == 4  # 3 frames, the end
    assert not consumer & {s["tid"] for s in builds}
    on_consumer = [s["name"] for s in roots if s["tid"] in consumer]
    assert on_consumer.count("nmrgnn.predict") == 3
    assert on_consumer.count("nmrgnn.readback") == 3
