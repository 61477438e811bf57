"""nmrgnn_tpu_torch — the PyTorch/CUDA port of ``nmrgnn_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The port keeps the JAX package's function names and array layouts at its
public functions, so the same inputs can be run through both and compared.
Plain tensor code is PyTorch; every Pallas kernel of the ported paths is a
CUDA C++ kernel written for Hopper (``csrc/``), built with ``nvcc`` on first
use and bound with ``ctypes`` (``ops/_cuda.py``).

This package never imports JAX, flax or ``nmrgnn_tpu``.
"""
from .config import ModelConfig, TrainConfig
from .graph import Graph, inv_degree_from_nlist, pad_graph

__version__ = "0.1.0"

__all__ = ["ModelConfig", "TrainConfig", "Graph", "inv_degree_from_nlist", "pad_graph", "__version__"]
