#!/usr/bin/env python3
"""Time the band builds of one checkout of this repository on the card, to
compare two checkouts in one call.

    python3 tools/ab_band_builds.py [--tree DIR] [--seed 0] [--out FILE]

DIR is the root of the checkout whose ``nmrgnn_tpu_torch`` is timed
(default: this one); the inputs (chip_smoke.py's synthetic 2,482-atom
structure and its 44,676-atom supercell, the bundled weights, the
Chebyshev fit the fast precision serves with) and the timing helpers are
this checkout's chip_smoke.py's. The wrappers' public signatures are the
same in both trees, so run it once per tree, in turns (A, B, B, A), in one
call. At each size it times, a call (CUDA events) and alone
(torch.profiler): B2 (build_band, float32 and bfloat16), B4 (build_band_poly, bfloat16
and float32), B8 (build_band_poly_cls, bfloat16, every window class), at
2,482 atoms B7a / B7b (the *_tracedlo builds with the plan's window
starts), B3 (build_band_fused, float32 and, at 2,482 atoms, bfloat16),
torch.zeros of each band (the write alone) and each build's byte bound;
at 44,676 atoms the fast uniform and fast class forwards (CUDA events,
and the builds' device time inside them). One JSON object per size is
printed and all are written to FILE.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _forward_build_ms(cs, fn, keys, runs=5):
    """Device time a forward spends in the kernels named by ``keys``."""
    return {k: cs._kernel_device_ms(fn, k, runs) for k in keys}


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
    import torch.nn.functional as nnf

    if not torch.cuda.is_available():
        raise SystemExit("ab_band_builds: needs a CUDA GPU")
    from nmrgnn_tpu_torch.data.parse import structure2graph
    from nmrgnn_tpu_torch.data.pdb import read_structure
    from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order
    from nmrgnn_tpu_torch.library import load_model
    from nmrgnn_tpu_torch.models.infer import (_edge_features, apply_banded,
                                               apply_banded_hbm_classes)
    from nmrgnn_tpu_torch.models.serving import CHEB_DEGREE
    from nmrgnn_tpu_torch.ops import _cuda, banded
    from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev

    if not banded.__file__.startswith(tree):
        raise SystemExit(f"ab_band_builds: imported {banded.__file__}, not from {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _cuda.build(["banded", "poly", "hbm"])
    params, cfg = load_model(device=dev)
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    cheb = fit_edge_chebyshev(params["edge_fc"], rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high,
                              rbf_count=cfg.edge_hidden_size, activation=cfg.fc_activation,
                              degree=CHEB_DEGREE)
    cheb = cheb._replace(coeffs=torch.as_tensor(cheb.coeffs, device=dev))
    fc = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, activation_name=cfg.fc_activation)
    bf16, f32 = torch.bfloat16, torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        small, large = os.path.join(tmp, "small.pdb"), os.path.join(tmp, "large.pdb")
        cs.write_synthetic_pdb(small, seed=args.seed)
        cs.write_supercell_pdb(large, seed=args.seed)
        graphs = {"2482": structure2graph(read_structure(small)),
                  "44676": structure2graph(read_structure(large))}
    results = {"card": card, "tree": tree}
    for size, g in graphs.items():
        gp, _ = permute_graph(g, rcm_order(g.nlist, g.edges), pin_zero=False)
        plan = banded.band_plan(gp.nlist, gp.edges)
        cls_plan = banded.band_plan_classes(gp.nlist, gp.edges)
        gt = cs._on_card(gp, dev)
        pd = banded.plan_on_device(plan, dev)
        cd = banded.plan_on_device(cls_plan, dev)
        T, B, W, npad = plan.num_tiles, plan.block_rows, plan.window, plan.n_padded
        N, K = gp.nlist.shape
        E = cfg.edge_feature_size
        e_feat = _edge_features(params, cfg, gt.edges)
        shapes = [(T, E, B, W)]
        cls_shapes = [(len(c.ids), E, B, c.window) for c in cls_plan.classes]
        nl_p = nnf.pad(gt.nlist, (0, 0, 0, npad - N), value=-1)
        d_p = nnf.pad(gt.edges, (0, 0, 0, npad - N))
        e_p = nnf.pad(e_feat, (0, 0, 0, 0, 0, npad - N))
        runs = {
            "build_band": (f32, lambda: banded.build_band(gt.nlist, e_feat, pd),
                           "build_band_kernel", shapes, N * K * 16),
            "build_band_bf16": (bf16, lambda: banded.build_band(gt.nlist, e_feat, pd, bf16),
                                "build_band_kernel", shapes, N * K * 16),
            "build_band_poly": (bf16, lambda: banded.build_band_poly(gt.nlist, gt.edges, cheb,
                                                                     pd, bf16),
                                "build_band_poly_kernel", shapes, N * K * 8),
            "build_band_poly_f32": (f32, lambda: banded.build_band_poly(gt.nlist, gt.edges,
                                                                        cheb, pd, f32),
                                    "build_band_poly_kernel", shapes, N * K * 8),
            "build_band_poly_cls": (bf16, lambda: [banded.build_band_poly_cls(
                gt.nlist, gt.edges, cheb, c, B, npad, bf16) for c in cd.classes],
                "build_band_poly_kernel", cls_shapes, N * K * 8),
            "build_band_fused": (f32, lambda: banded.build_band_fused(gt.nlist, gt.edges,
                                                                      params["edge_fc"], pd,
                                                                      **fc),
                                 "fused_edge_band_kernel", shapes, None),
        }
        if size == "2482":
            runs.update({
                "build_band_tracedlo": (f32, lambda: banded.build_band_tracedlo(
                    nl_p, e_p, pd.lo, W, B), "build_band_kernel", shapes, N * K * 16),
                "build_band_poly_tracedlo": (bf16, lambda: banded.build_band_poly_tracedlo(
                    nl_p, d_p, cheb, pd.lo, W, B, bf16), "build_band_poly_kernel", shapes,
                    N * K * 8),
                "build_band_fused_bf16": (bf16, lambda: banded.build_band_fused(
                    gt.nlist, gt.edges, params["edge_fc"], pd, **fc, out_dtype=bf16,
                    compute_dtype=bf16), "fused_edge_band_kernel", shapes, None),
            })
        res = {"N": N, "T": T, "W": W, "classes": [list(s[::3]) for s in cls_shapes]}
        for name, (dt, fn, key, shp, in_bytes) in runs.items():
            eb = 2 if dt == bf16 else 4
            out_bytes = sum(int(np.prod(s)) * eb for s in shp)

            def zeros(shp=shp, dt=dt):
                return [torch.zeros(s, dtype=dt, device=dev) for s in shp]

            row = {"ms": cs._time_ms(fn, 10, 10), "alone_ms": cs._kernel_device_ms(fn, key, 20),
                   "zeros_alone_ms": cs._kernel_device_ms(zeros, "Fill", 20)}
            if in_bytes is not None:
                row["bound_ms"] = (in_bytes + out_bytes) / cs.PEAK_HBM_BYTES * 1e3
            res[name] = row
        del e_feat, e_p
        if size == "44676":
            fwd = {
                "fast_hbm_uniform": lambda: apply_banded(params, cfg16, gt, pd, cheb=cheb,
                                                         hbm_table=True),
                "fast_hbm_classes": lambda: apply_banded_hbm_classes(params, cfg16, gt, cd,
                                                                     cheb),
            }
            for k, f in fwd.items():
                res[k] = {"ms": cs._time_ms(f, 10, 3),
                          "builds_inside_ms": _forward_build_ms(
                              cs, f, ["build_band_poly_kernel"])["build_band_poly_kernel"]}
        print(json.dumps({size: res}))
        results[size] = res
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
