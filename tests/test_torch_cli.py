"""The port's CLI (``python -m nmrgnn_tpu_torch.cli``) on the CPU against
the JAX package's click CLI (run in-process with click's CliRunner) on a
synthetic structure: make-fragments byte for byte, train (with
--tensorboard) and train --load, eval-tfrecords' CSV and markdown table
(and a merge into an existing table), eval-struct with and without --fast,
hyper at 2 trials and 1 epoch, the subcommands, and the multi-GPU flags'
usage error."""
import csv
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from nmrgnn_tpu import cli as jcli
from nmrgnn_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import write_synthetic_pdb  # noqa: E402

torch.set_num_threads(2)

SMALL_CFG = {"atom_feature_size": 32, "edge_hidden_size": 16, "mp_layers": 2,
             "fc_layers": 2, "edge_fc_layers": 2, "dropout": False, "noise": 0.0,
             "learning_rate": 1e-3}
FRAG = ["--batch-size", "2", "--pad-to", "64"]


def run_jax(*args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        r = CliRunner().invoke(jcli.main, list(args), catch_exceptions=False)
    finally:
        os.chdir(old)
    assert r.exit_code == 0, r.output
    return r.output


def run_port(*args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        assert cli.main([*args, "--device", "cpu"]) == 0
    finally:
        os.chdir(old)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def read_md(path):
    """{row label: [cells]} and the headers of a markdown table."""
    lines = [ln for ln in open(path).read().splitlines() if ln.strip()]
    split = [[c.strip() for c in ln.split("|")[1:-1]] for ln in lines]
    return split[0], {r[0]: r[1:] for r in split[2:]}


def close_cells(a, b):
    if a == b:
        return True
    try:
        return np.isclose(float(a), float(b), rtol=1e-4, atol=1e-6)
    except ValueError:
        return False


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    pdb = str(d / "s.pdb")
    write_synthetic_pdb(pdb, n_atoms=300, seed=3, frames=2)
    cfg = str(d / "config.json")
    with open(cfg, "w") as f:
        json.dump(SMALL_CFG, f)
    for sub in ("t", "j"):
        os.makedirs(d / sub)
    return d, pdb, cfg


@pytest.fixture(scope="module")
def frags(work):
    d, pdb, _ = work
    run_port("make-fragments", pdb, str(d / "t.tfrecord"), "--fragment-size", "64", cwd=d)
    run_jax("make-fragments", pdb, str(d / "j.tfrecord"), "--fragment-size", "64", cwd=d)
    return str(d / "t.tfrecord")


@pytest.fixture(scope="module")
def model(work, frags):
    d, _, cfg = work
    model_dir, ckpt, tb = str(d / "model"), str(d / "ckpt"), str(d / "tb")
    run_port("train", frags, model_dir, "1", "--config", cfg, "--checkpoint-path", ckpt,
             "--tensorboard", tb, *FRAG, cwd=d)
    return model_dir, ckpt, tb


def test_make_fragments_equal_jax(work, frags):
    d, _, _ = work
    assert open(frags, "rb").read() == open(d / "j.tfrecord", "rb").read()


def test_train_writes_model_history_events_and_resumes(work, frags, model):
    from nmrgnn_tpu.library import load_model as jload_model
    from nmrgnn_tpu_torch.data.tfrecord import read_tfrecord

    d, _, cfg = work
    model_dir, ckpt, tb = model
    assert os.path.exists(model_dir + "-history-0.pb")
    jload_model(model_dir)  # the JAX package reads the port's model
    (events,) = [f for f in os.listdir(tb) if f.startswith("events.out.tfevents")]
    recs = list(read_tfrecord(os.path.join(tb, events), check_crc=True))
    assert len(recs) > 2 and any(b"val_loss" in r for r in recs)
    assert len(open(os.path.join(tb, "scalars.jsonl")).readlines()) == 1
    run_port("train", frags, str(d / "model2"), "1", "--config", cfg, "--checkpoint-path",
             ckpt, "--load", *FRAG, cwd=d)
    import pickle

    hist = pickle.load(open(str(d / "model2") + "-history-0.pb", "rb"))
    assert len(hist["loss"]) == 2  # the checkpoint's epoch, then one more


def test_eval_tfrecords_matches_jax(work, frags, model):
    d, _, _ = work
    model_dir = model[0]
    args = (frags, "--model-file", model_dir, "--data-name", "syn", *FRAG)
    run_port("eval-tfrecords", *args, cwd=d / "t")
    run_jax("eval-tfrecords", *args, cwd=d / "j")
    h_t, rows_t = read_csv(d / "t" / "model.csv")
    h_j, rows_j = read_csv(d / "j" / "model.csv")
    assert h_t == h_j == ["element", "y", "yhat", "class", "name"]
    assert len(rows_t) == len(rows_j) > 0
    for a, b in zip(rows_t, rows_j):
        assert (a[0], a[3], a[4]) == (b[0], b[3], b[4])
        assert float(a[1]) == float(b[1])
        assert abs(float(a[2]) - float(b[2])) <= 2e-4
    md_t, md_j = d / "t" / "model.md", d / "j" / "model.md"
    (ht, tt), (hj, tj) = read_md(md_t), read_md(md_j)
    assert ht == hj and list(tt) == list(tj)
    for k in tt:
        assert all(close_cells(a, b) for a, b in zip(tt[k], tj[k])), k
    # merge a second evaluation into the JAX CLI's table, in both CLIs
    for sub in ("t", "j"):
        shutil.copy(md_j, d / sub / "merged.md")
    args = (frags, "--model-file", model_dir, "--data-name", "two", "--merge", "merged.md",
            *FRAG)
    run_port("eval-tfrecords", *args, cwd=d / "t")
    run_jax("eval-tfrecords", *args, cwd=d / "j")
    (ht, tt), (hj, tj) = read_md(d / "t" / "merged.md"), read_md(d / "j" / "merged.md")
    assert ht == hj and list(tt) == list(tj) and len(tt) == 2 * len(read_md(md_j)[1])
    for k in tt:
        assert all(close_cells(a, b) for a, b in zip(tt[k], tj[k])), k


@pytest.mark.parametrize("flags", [(), ("--fast", "--precision", "exact")])
def test_eval_struct_matches_jax(work, model, flags, capsys):
    """The same rows; peaks, rounded to 0.01 as both write them, equal
    except where the two forwards (within 2e-4) straddle a rounding
    boundary. Each frame prints its timing line, the buckets in order."""
    d, pdb, _ = work
    name = "fast" if flags else "plain"
    capsys.readouterr()
    run_port("eval-struct", pdb, str(d / "t" / f"{name}.csv"), "--model-file", model[0],
             *flags, cwd=d)
    timing = [line for line in capsys.readouterr().out.splitlines() if line.startswith("graph:")]
    assert len(timing) == 2 and all(
        re.fullmatch(r"graph: *\d+\.\d\ds\|inference: *\d+\.\d\ds\|output: *\d+\.\d\ds"
                     r"\|read: *\d+\.\d\ds", line) for line in timing), timing
    run_jax("eval-struct", pdb, str(d / "j" / f"{name}.csv"), "--model-file", model[0],
            *flags, cwd=d)
    h_t, rows_t = read_csv(d / "t" / f"{name}.csv")
    h_j, rows_j = read_csv(d / "j" / f"{name}.csv")
    assert h_t == h_j == ["index", "residues", "resids", "names", "peaks", "confident", "time",
                          "frame"]
    assert len(rows_t) == len(rows_j) == 600  # two frames
    peaks_t = np.array([float(r[4]) for r in rows_t])
    peaks_j = np.array([float(r[4]) for r in rows_j])
    assert np.abs(peaks_t - peaks_j).max() <= 0.01 + 1e-6
    assert np.mean(peaks_t == peaks_j) > 0.97
    for a, b in zip(rows_t, rows_j):
        assert [a[i] for i in (0, 1, 2, 3, 6, 7)] == [b[i] for i in (0, 1, 2, 3, 6, 7)]
    assert np.mean([a[5] == b[5] for a, b in zip(rows_t, rows_j)]) > 0.97


def test_subcommands_and_multi_gpu_flags(work, frags):
    d, pdb, _ = work
    names = set(cli.build_parser()._subparsers._group_actions[0].choices)
    assert names == set(jcli.main.commands) and len(names) == 8
    r = subprocess.run([sys.executable, "-m", "nmrgnn_tpu_torch.cli", "--help"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0 and all(n in r.stdout for n in names)
    # in one process: N past the world of 1, and --graph-parallel with the
    # other two (the JAX CLI's usage errors)
    for args in (["train", frags, "m", "1", "--data-parallel", "2"],
                 ["train", frags, "m", "1", "--graph-parallel", "2"],
                 ["train", frags, "m", "1", "--graph-parallel", "2", "--data-parallel", "2"],
                 ["train", frags, "m", "1", "--graph-parallel", "2", "--tensor-parallel"],
                 ["eval-struct", pdb, "o.csv", "--graph-parallel", "2"]):
        with pytest.raises(SystemExit) as e:
            cli.main(args + ["--device", "cpu"])
        assert e.value.code == 2


def test_hyper_two_trials(work, frags, capsys):
    d, _, _ = work
    tune = str(d / "tuning")
    run_port("hyper", frags, "1", "--trials", "2", "--tuning_path", tune, *FRAG, cwd=d)
    out = capsys.readouterr().out
    assert "trial 0: F=256 E=8 H=64" in out and "path=gather" in out  # the CPU: gather
    results = json.load(open(os.path.join(tune, "results.json")))
    assert len(results) == 2 and all(np.isfinite(r["val_loss"]) for r in results)
    assert os.path.exists(os.path.join(tune, "best_config.json"))
    assert os.path.exists(os.path.join(tune, "best_model", "params.msgpack"))
