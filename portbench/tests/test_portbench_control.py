"""What decides ``correct`` fails where it should: the control (the
reference with TF32 products in the program's place) at a size a test run
holds, and a run driven with its timed path broken underneath (the
fault a serving cell can have: an answer altered where it is produced,
or a stale one)."""
import numpy as np
import pytest

from portbench import control
from portbench.harness.cell import load_json
from portbench.run import BENCH
from portbench.tests.tiny import SEED, bench, rehearse, tiny_size

# every cell whose traffic the predict loop serves, found from BENCHMARK.json
SERVING = sorted(w["name"] for w in bench()["workloads"]
                 if load_json(BENCH, "traffic", f"{w['traffic']}.json")["driver"] == "predict_loop")


@pytest.mark.parametrize("cell", SERVING)
def test_the_control_fails_and_the_program_passes(cell):
    r = control.readings(cell, SEED, 0.3, True, device="cpu", traffic=tiny_size(cell),
                         bench=bench())
    limits = load_json(BENCH, "limits", f"{cell}.json")
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.parametrize("cell", SERVING)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from nmrgnn_tpu_torch.models.serving import ServingModel

    finalize = ServingModel._finalize

    def altered(peaks, inverse):
        out = np.array(finalize(peaks, inverse))
        out[..., 0] += 0.01 * float(np.abs(out).max())
        return out

    monkeypatch.setattr(ServingModel, "_finalize", staticmethod(altered))
    out = rehearse(cell)
    assert not out["correct"] and out["failed"] == 1, out["check"]


@pytest.mark.parametrize("cell", SERVING)
def test_a_stale_answer_is_not_correct(cell, monkeypatch):
    from nmrgnn_tpu_torch.models.serving import ServingModel

    finalize = ServingModel._finalize
    first = []

    def stale(peaks, inverse):
        out = finalize(peaks, inverse)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(ServingModel, "_finalize", staticmethod(stale))
    assert not rehearse(cell)["correct"]
