"""User-facing entry points (``nmrgnn_tpu/library.py:79-149``): save and
load a model, turn a structure into a graph, sanity-check peaks.

The bundled weights are read by path from the JAX package's directory
(``nmrgnn_tpu/models/baseline/``: ``config.json`` and flax-msgpack
``params.msgpack``) with the port's own msgpack reader; nothing of the
JAX package is imported. They were trained on synthetic labels and are
not the published nmrgnn weights.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import _msgpack
from ._device import resolve_device
from .config import ModelConfig
from .data.embeddings import load_standards
from .data.parse import structure2graph
from .graph import Graph
from .models.gnn import init_params, tree_map

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_DIR = os.path.join(_REPO_DIR, "nmrgnn_tpu", "models", "baseline")


def params_from_numpy(tree, device="cuda"):
    """The JAX package's params (a tree of numpy arrays, JAX layout) as the
    port's params: the same tree of float32 tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), tree
    )


def _shapes(tree):
    return tree_map(lambda t: tuple(t.shape), tree)


def save_model(path: str, params, config: ModelConfig) -> None:
    """Write ``params.msgpack`` (flax's msgpack layout, so the JAX
    package's ``load_model`` reads it) and ``config.json`` into the
    directory ``path``. The peak standards are saved with the params."""
    os.makedirs(path, exist_ok=True)
    tree = tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), params)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(_msgpack.packb(_msgpack.state_dict(tree)))
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config.to_json())


def load_model(model_file: Optional[str] = None, device="cuda") -> Tuple[dict, ModelConfig]:
    """(params on ``device``, config). With no argument, the bundled
    baseline. The file's tree must match the config's parameter shapes."""
    dev = resolve_device(device)
    path = model_file or BASELINE_DIR
    params_file = os.path.join(path, "params.msgpack")
    if not os.path.exists(params_file):
        raise FileNotFoundError(f"no model found at {path}")
    with open(os.path.join(path, "config.json")) as f:
        config = ModelConfig.from_json(f.read())
    with open(params_file, "rb") as f:
        tree = _msgpack.restore_arrays(_msgpack.unpackb(f.read()))
    template = init_params(config, torch.Generator().manual_seed(0), load_standards(),
                           device="cpu")
    if _shapes(tree) != _shapes(template):
        raise ValueError(f"{params_file} does not match the parameter shapes of its config")
    return params_from_numpy(tree, dev), config


def universe2graph(struct_or_path, neighbor_number: int = 16) -> Graph:
    """Structure (file path or parsed Structure) -> numpy-backed graph."""
    return structure2graph(struct_or_path, neighbor_number)


def check_peaks(atoms, peaks, cutoff_sigma: float = 4, warn_sigma: float = 2.5):
    """bool[N] 'confident' from the training shift statistics; raises
    ``Warning`` (as an exception, like the reference) when fewer than 75%
    of atoms look plausible. ``cutoff_sigma`` is accepted for signature
    parity and unused, as in the reference."""
    standards = load_standards()
    atoms = np.asarray(atoms)
    peaks = np.asarray(peaks)
    elem_idx = np.argmax(atoms, axis=-1)
    avg = np.asarray([standards[int(i)][1] for i in range(atoms.shape[-1])])
    std = np.asarray([standards[int(i)][2] for i in range(atoms.shape[-1])])
    a = avg[elem_idx]
    s = std[elem_idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        z2 = np.where(s > 0, ((peaks - a) ** 2) / np.maximum(s, 1e-30) ** 2, np.inf)
    confident = (s > 0) & (z2 <= warn_sigma**2)
    if np.sum(confident) / max(len(confident), 1) < 0.75:
        raise Warning(
            "Your peaks look awful. Likely solvent or missing hydrogens or "
            "bad units. Check README for suggestions"
        )
    return confident
