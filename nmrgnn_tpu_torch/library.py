"""User-facing entry points (``nmrgnn_tpu/library.py``): runtime checks,
the bundled model, a model and trainer factory, the data split, save and
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


def setup_optimizations(debug_nans: bool = False, enable_x64: bool = False) -> None:
    """Runtime switches (``nmrgnn_tpu/library.py:24-35``).

    ``debug_nans`` turns on ``torch.autograd.set_detect_anomaly``: a
    backward pass that produces NaN raises and names the forward operation
    that made it (the counterpart of ``jax_debug_nans``; forward values are
    not checked). ``enable_x64`` is accepted and changes nothing: PyTorch
    has float64 without a switch, and the port makes every tensor in the
    type it names, as the JAX package's typed arrays keep theirs under x64
    (setting float64 as the default type would change the port's
    numerics, and the kernels take float32 and bfloat16 only)."""
    if debug_nans:
        torch.autograd.set_detect_anomaly(True)


def load_baseline() -> str:
    """Path of the bundled model directory (``nmrgnn_tpu/library.py:38``)."""
    return BASELINE_DIR


def build_GNNModel(
    config: Optional[ModelConfig] = None,
    metrics: bool = True,
    loss_balance: float = 1.0,
    rng: Optional[torch.Generator] = None,
    device="cuda",
):
    """(params, Trainer): initial weights drawn from ``rng`` (a
    ``torch.Generator``, default seeded with 0) with the element standards,
    and a ``Trainer`` with Adam, ``name_loss(loss_balance)`` and the
    standard metric suite, both on ``device`` (``nmrgnn_tpu/library.py:
    45-65``). ``metrics`` is accepted for signature parity: the Trainer
    always computes the suite."""
    from .config import TrainConfig
    from .train.trainer import Trainer

    config = config or ModelConfig()
    trainer = Trainer(config, TrainConfig(loss_balance=loss_balance), device=device)
    rng = rng if rng is not None else torch.Generator().manual_seed(0)
    params = init_params(config, rng, load_standards(), device=device)
    return params, trainer


def load_data(tfrecords, validation: float, embeddings=None, scale: bool = False):
    """(train samples, validation samples) with the reference's per-file
    take/skip split (``nmrgnn_tpu/library.py:68-76``). ``embeddings`` and
    ``scale`` are accepted for signature parity: the labels are already in
    ppm (the reference's scaling branch is dead code)."""
    from .data.dataset import split_dataset

    return split_dataset(list(tfrecords), validation)


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
