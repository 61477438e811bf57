"""Tensor ops of the port: activations, RBF, gather message passing, and
the banded and block-sparse operators with their hand-written CUDA
kernels."""
from . import banded, painn  # noqa: F401 (their kernel wrappers join _cuda.KERNEL_WRAPPERS)
from .activations import get_activation
from .blocksparse import (
    BlockStructure,
    block_structure,
    build_block_adjacency,
    build_block_adjacency_plain,
    mp_blocksparse,
    mp_blocksparse_plain,
)
from .message_passing import amp_layer, mp_aggregate, mp_layer
from .rbf import rbf_centers, rbf_expand

# The JAX package's names: ``*_pallas`` for the kernel, ``*_xla`` for the
# plain version. Here the kernel's wrapper (plain on a CPU tensor) and the
# plain PyTorch version.
build_block_adjacency_pallas = build_block_adjacency
mp_blocksparse_xla = mp_blocksparse_plain

__all__ = [
    "get_activation",
    "BlockStructure",
    "block_structure",
    "build_block_adjacency",
    "build_block_adjacency_pallas",
    "mp_blocksparse",
    "mp_blocksparse_xla",
    "amp_layer",
    "mp_aggregate",
    "mp_layer",
    "rbf_centers",
    "rbf_expand",
]
