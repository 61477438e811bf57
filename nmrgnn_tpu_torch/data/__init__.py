"""Host-side data layer: vocabularies, PDB reading, kNN, graph building,
RCM reordering (numpy and scipy only), TFRecords and fragments."""
from .embeddings import ELEMENTS, element_to_index, load_embeddings, load_standards
from .neighbors import neighbors_device, neighbors_host
from .parse import parse_structure, structure2graph
from .pdb import Structure, read_pdb, read_structure

__all__ = [
    "ELEMENTS",
    "element_to_index",
    "load_embeddings",
    "load_standards",
    "neighbors_device",
    "neighbors_host",
    "parse_structure",
    "structure2graph",
    "Structure",
    "read_pdb",
    "read_structure",
]
