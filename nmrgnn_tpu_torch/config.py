"""Model and training configuration, field for field the JAX package's
``ModelConfig`` and ``TrainConfig`` (``nmrgnn_tpu/config.py``), so one JSON
file loads in both."""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the GNN chemical-shift model. Defaults are the
    bundled baseline model's."""

    atom_feature_size: int = 256
    edge_feature_size: int = 3
    edge_hidden_size: int = 128
    mp_layers: int = 4
    fc_layers: int = 4
    edge_fc_layers: int = 4
    noise: float = 0.025
    dropout: bool = True
    rbf_low: float = 0.005
    rbf_high: float = 0.20
    mp_activation: str = "softplus"
    fc_activation: str = "softplus"
    learning_rate: float = 1e-4
    num_elements: int = 10
    neighbor_number: int = 16
    dropout_rate: float = 0.2
    compute_dtype: str = "float32"
    mp_impl: str = "gather"
    mp_type: str = "bilinear"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        d = json.loads(s)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (``nmrgnn_tpu/config.py:74-145``): Adam,
    ReduceLROnPlateau(factor 0.99, patience 4, min_lr 1e-4) or a cosine
    schedule, EMA, best-restore, a 10% validation split, fragments padded
    to ``pad_to`` and batched by ``batch_size``.

    ``mp_path`` picks the message passing of the train and eval steps:
    "banded" (``models/infer.apply_banded_fragments``: the band build and
    MP kernels forward, their backward in plain PyTorch), "gather"
    (``models/gnn.apply_batched``) or "auto" (banded on a CUDA device when
    eligible, else gather). ``compiled_epochs`` keeps the epoch's fragments
    resident on the device and gathers each batch there, with one loss
    readback an epoch."""

    epochs: int = 3
    validation: float = 0.1
    loss_balance: float = 1.0
    checkpoint_path: str = "/tmp/checkpoint"
    lr_reduce_factor: float = 0.99
    lr_patience: int = 4
    min_lr: float = 1e-4
    lr_schedule: str = "plateau"
    warmup_epochs: int = 0
    cosine_final_lr: float = 1e-6
    ema_decay: float = 0.0
    restore_best: bool = False
    pad_to: int = 256
    batch_size: int = 8
    shuffle_buffer: int = 500
    seed: int = 0
    mp_path: str = "auto"
    head_decay: float = 0.0
    head_decay_elements: str = "N"
    compiled_epochs: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        d = json.loads(s)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
