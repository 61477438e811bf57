#!/usr/bin/env python3
"""Time the 2,482-atom forwards and one training step of one checkout of
this repository on the card, to compare two checkouts in one call.

    python3 tools/ab_forwards.py [--tree DIR] [--seed 0] [--out FILE]

DIR is the root of the checkout whose ``nmrgnn_tpu_torch`` is timed
(default: this one); the inputs (chip_smoke.py's synthetic 2,482-atom
structure in RCM order, the bundled weights, the Chebyshev fit the fast
precision serves with, a batch of 8 fragments of 256 atoms) and the
timing helper are this checkout's chip_smoke.py's. The public signatures
are the same in both trees, so run it once per tree, in turns (A, B, B,
A), in one call. It times (CUDA events, median of 10 runs of 10 calls)
the exact, fast-uniform and fast-classes forwards (``apply_banded``,
``apply_banded_classes``: host-bound at this size, so they measure the
wrappers' host work too) and one banded Trainer step (forward, backward,
Adam), and prints one JSON object (also written to FILE).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    cs = _smoke()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_forwards: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import nmrgnn_tpu_torch
    from nmrgnn_tpu_torch.config import TrainConfig
    from nmrgnn_tpu_torch.data.dataset import batch_samples, split_dataset
    from nmrgnn_tpu_torch.data.fragment import write_structure_fragments
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.library import load_model, universe2graph
    from nmrgnn_tpu_torch.models.infer import apply_banded, apply_banded_classes
    from nmrgnn_tpu_torch.models.serving import CHEB_DEGREE
    from nmrgnn_tpu_torch.ops import banded
    from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev
    from nmrgnn_tpu_torch.train.trainer import Trainer

    if not os.path.abspath(nmrgnn_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f"ab_forwards: imported {nmrgnn_tpu_torch.__file__}, not {tree}'s")
    dev = torch.device("cuda")
    params, cfg = load_model(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "synthetic.pdb")
        cs.write_synthetic_pdb(pdb, n_atoms=cs.N_ATOMS, seed=args.seed, frames=1)
        g = universe2graph(pdb)
        recs = os.path.join(tmp, "f.tfrecord")
        write_structure_fragments(recs, read_structure(pdb), fragment_size=256)
        train, _ = split_dataset([recs], 0.0)
    g, _ = permute_graph(g, rcm_order(g.nlist, g.edges), pin_zero=False)
    gt = cs._on_card(g, dev)
    plan_d = banded.plan_on_device(banded.band_plan(g.nlist, g.edges), dev)
    cls_d = banded.plan_on_device(banded.band_plan_classes(g.nlist, g.edges), dev)
    cheb = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                              rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation,
                              degree=CHEB_DEGREE)
    cheb_d = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    trainer = Trainer(cfg.replace(learning_rate=1e-3),
                      TrainConfig(batch_size=8, pad_to=256, mp_path="banded"), device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    opt = trainer.optimizer(state)
    graph, y, w = trainer._to_device(*batch_samples(train[:8], 256))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    fns = {
        "exact": lambda: apply_banded(params, cfg, gt, plan_d),
        "fast_uniform": lambda: apply_banded(params, cfg16, gt, plan_d, cheb=cheb_d),
        "fast_classes": lambda: apply_banded_classes(params, cfg16, gt, cls_d, cheb_d),
        "train_step": lambda: trainer.train_step(state, opt, graph, y, w, gen),
    }
    with torch.no_grad():
        ms = {k: cs._time_ms(f, 10) for k, f in fns.items() if k != "train_step"}
    ms["train_step"] = cs._time_ms(fns["train_step"], 10, inner=2)
    out = {"tree": tree, "ms": ms}
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
