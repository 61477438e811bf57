"""The least work of the attention family's inference forward (AMPLayer),
counted as ``flops/bilinear.py`` counts it. A linear map that commutes
with the neighbor gather counts once an atom: the values x @ wv are
2 N F^2, not 2 N K F^2. The softmax runs over all K slots of an atom.

    an MP layer, an atom:  2 F E (query) + 2 F^2 (values)
                 a slot:   2 E^2 (keys) + 2 E (logits) + 2 F (weighted sum)
The edge stage and the readout are the bilinear family's.
"""
from __future__ import annotations

import importlib.util
import os

B = 4  # bytes of a float32


def _bilinear():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bilinear.py")
    spec = importlib.util.spec_from_file_location("portbench_flops_bilinear", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work(cfg: dict, n_atoms: int, n_edges: int, n_slots: int = None) -> dict:
    """As ``bilinear.work``; ``n_slots`` is N K (every slot, padding
    included), by default ``n_edges``."""
    F, E = cfg["atom_feature_size"], cfg["edge_feature_size"]
    n_slots = n_edges if n_slots is None else n_slots
    out = _bilinear().work(cfg, n_atoms, n_edges)
    layer_flops = (2 * F * E + 2 * F * F) * n_atoms + (2 * E * E + 2 * E + 2 * F) * n_slots
    layer_bytes = B * (2 * n_atoms * F + n_slots * (E + 1) + n_atoms + F * E + E * E + F * F)
    out["mp"] = (cfg["mp_layers"] * layer_flops, cfg["mp_layers"] * layer_bytes)
    out["forward"] = out["edge"][0] + out["mp"][0] + out["readout"][0]
    return out
