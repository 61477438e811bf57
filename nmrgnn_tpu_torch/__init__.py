"""nmrgnn_tpu_torch — the PyTorch/CUDA port of ``nmrgnn_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The port keeps the JAX package's function names and array layouts at its
public functions, so the same inputs can be run through both and compared.
Plain tensor code is PyTorch; every Pallas kernel of the ported paths is a
CUDA C++ kernel written for Hopper (``csrc/``), built with ``nvcc`` on first
use and bound with ``ctypes`` (``ops/_cuda.py``). Importing the package
builds no kernel and imports neither the CLI (``python -m
nmrgnn_tpu_torch.cli``) nor TensorFlow.

This package never imports JAX, flax or ``nmrgnn_tpu``.
"""
from .config import ModelConfig, TrainConfig
from .graph import Graph, inv_degree_from_nlist, pad_graph, ring_graph
from .library import (
    build_GNNModel,
    check_peaks,
    load_baseline,
    load_data,
    load_model,
    save_model,
    setup_optimizations,
    universe2graph,
)
from .models.gnn import apply, apply_batched, count_params, init_params
from .models.serving import ServingModel
from .train.losses import name_loss
from .train.metrics import name_corr, name_count, name_rmsd, type_mask

__version__ = "0.1.0"

# the JAX package's public names (nmrgnn_tpu/__init__.py:40-66)
__all__ = [
    "ModelConfig",
    "TrainConfig",
    "Graph",
    "inv_degree_from_nlist",
    "pad_graph",
    "ring_graph",
    "build_GNNModel",
    "check_peaks",
    "load_baseline",
    "load_data",
    "load_model",
    "save_model",
    "setup_optimizations",
    "universe2graph",
    "apply",
    "apply_batched",
    "count_params",
    "init_params",
    "ServingModel",
    "name_loss",
    "name_corr",
    "name_count",
    "name_rmsd",
    "type_mask",
    "__version__",
]
