"""Training: losses, metrics, the fragment Trainer (one card, or data- and
tensor-parallel on a mesh), the whole-structure PartitionedTrainer and the
hyperparameter search."""
from .losses import corr_coeff, label_mask, name_loss
from .metrics import METRIC_SPECS, build_metric_fns, name_corr, name_count, name_rmsd, type_mask
from .partitioned import PartitionedTrainer
from .trainer import TrainState, Trainer

__all__ = [
    "PartitionedTrainer", "corr_coeff", "label_mask", "name_loss", "METRIC_SPECS",
    "build_metric_fns", "name_corr", "name_count", "name_rmsd", "type_mask", "TrainState",
    "Trainer",
]
