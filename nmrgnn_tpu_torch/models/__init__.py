"""Model forwards: the plain gather forward (gnn), the banded forward
(infer) and the serving wrapper (serving)."""
from .gnn import apply, apply_batched, count_params, init_params, trainable_mask

__all__ = ["apply", "apply_batched", "count_params", "init_params", "trainable_mask"]
