"""Readers of the reference's own checkpoint formats."""
from .keras_import import import_reference_checkpoint

__all__ = ["import_reference_checkpoint"]
