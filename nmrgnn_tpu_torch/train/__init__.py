"""Training on one device: losses, metrics, the Trainer and the
hyperparameter search. The JAX package's ``PartitionedTrainer`` (training
across cards) is not ported yet."""
from .losses import corr_coeff, label_mask, name_loss
from .metrics import METRIC_SPECS, build_metric_fns, name_corr, name_count, name_rmsd, type_mask
from .trainer import TrainState, Trainer

__all__ = [
    "corr_coeff", "label_mask", "name_loss", "METRIC_SPECS", "build_metric_fns", "name_corr",
    "name_count", "name_rmsd", "type_mask", "TrainState", "Trainer",
]
