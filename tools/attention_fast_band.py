#!/usr/bin/env python3
"""How far bfloat16 moves the attention family's peaks, in the JAX package
and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/attention_fast_band.py [--atoms 400] [--seed 0]

Builds a synthetic protein-like structure (``chip_smoke.write_synthetic_pdb``)
in RCM order and an attention model (``ModelConfig(mp_type="attention")``:
the baseline's width and depth) with random weights from ``--seed``, then
runs the banded attention forward of both packages (the JAX package's with
Pallas in interpret mode) in float32, in bfloat16 (``compute_dtype``) and
"fast" (bfloat16 and the degree-64 Chebyshev edge stage), and prints each
one's distance from the port's float32 peaks: max and mean |diff|, Pearson
r, and the atoms outside the JAX package's exact-vs-fast band (rtol 0.05,
atol 1.0 ppm, tests/test_banded.py:457-458). Every number it prints is a
CPU number, no device's.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import write_synthetic_pdb  # noqa: E402
from nmrgnn_tpu import ModelConfig as JModelConfig  # noqa: E402
from nmrgnn_tpu.graph import Graph as JGraph  # noqa: E402
from nmrgnn_tpu.models import infer as jinfer  # noqa: E402
from nmrgnn_tpu.ops import banded as jbanded  # noqa: E402
from nmrgnn_tpu.ops.edgefn import fit_edge_chebyshev as jfit  # noqa: E402
from nmrgnn_tpu_torch.config import ModelConfig  # noqa: E402
from nmrgnn_tpu_torch.data.embeddings import load_standards  # noqa: E402
from nmrgnn_tpu_torch.data.parse import structure2graph  # noqa: E402
from nmrgnn_tpu_torch.data.pdb import read_structure  # noqa: E402
from nmrgnn_tpu_torch.data.reorder import permute_graph, rcm_order  # noqa: E402
from nmrgnn_tpu_torch.graph import Graph  # noqa: E402
from nmrgnn_tpu_torch.models import gnn, infer  # noqa: E402
from nmrgnn_tpu_torch.ops import banded  # noqa: E402
from nmrgnn_tpu_torch.ops.edgefn import fit_edge_chebyshev  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--atoms", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        pdb = os.path.join(tmp, "s.pdb")
        write_synthetic_pdb(pdb, n_atoms=args.atoms, seed=args.seed)
        g = structure2graph(read_structure(pdb))
    g, _ = permute_graph(g, rcm_order(g.nlist, g.edges), pin_zero=False)
    cfg, jcfg = ModelConfig(mp_type="attention"), JModelConfig(mp_type="attention")
    cfg16, jcfg16 = (c.replace(compute_dtype="bfloat16") for c in (cfg, jcfg))
    params = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed), load_standards(),
                             device="cpu")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    plan = banded.band_plan(g.nlist, g.edges)
    jplan = jbanded.BandPlan(plan.lo, plan.window, plan.block_rows, plan.n_padded)
    tg, jg = Graph(*[torch.from_numpy(np.asarray(a)) for a in g]), JGraph(*map(jnp.asarray, g))
    fit = dict(rbf_low=cfg.rbf_low, rbf_high=cfg.rbf_high, rbf_count=cfg.edge_hidden_size,
               activation=cfg.fc_activation, degree=64)
    cheb = fit_edge_chebyshev(params["edge_fc"], **fit)
    jcheb = jfit(jax.tree_util.tree_map(np.asarray, jparams)["edge_fc"], **fit)
    with torch.no_grad():
        port = lambda c, **kw: infer.apply_banded_attention(params, c, tg, plan, **kw).numpy()  # noqa: E731
        exact = port(cfg)
        runs = {"port bfloat16": port(cfg16), "port fast": port(cfg16, cheb=cheb),
                "port Chebyshev float32": port(cfg, cheb=cheb)}
    jax_run = lambda c, **kw: np.asarray(jinfer.apply_banded_attention(  # noqa: E731
        jparams, c, jg, jplan, interpret=True, **kw))
    runs.update({"JAX float32": jax_run(jcfg), "JAX bfloat16": jax_run(jcfg16),
                 "JAX fast": jax_run(jcfg16, cheb=jcheb)})
    print(f"{args.atoms} atoms, attention model F={cfg.atom_feature_size}, "
          f"{cfg.mp_layers} MP layers, seed {args.seed} (CPU); port float32 peaks from "
          f"{exact.min():.2f} to {exact.max():.2f} ppm, mean |peak| {np.abs(exact).mean():.2f}")
    for name, got in runs.items():
        d = np.abs(got - exact)
        out = int((d > 1.0 + 0.05 * np.abs(exact)).sum())
        print(f"{name:24s} vs port float32: max |diff| {d.max():.4f} ppm (at a peak of "
              f"{exact[d.argmax()]:.2f}), mean {d.mean():.4f}, r "
              f"{np.corrcoef(got, exact)[0, 1]:.7f}, {out} atoms outside rtol 0.05 / atol 1.0")
    d = np.abs(runs["port fast"] - runs["JAX fast"])
    print(f"port fast vs JAX fast: max |diff| {d.max():.4f} ppm, mean {d.mean():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
