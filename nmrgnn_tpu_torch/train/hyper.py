"""Hyperparameter search (``nmrgnn_tpu/train/hyper.py``): random samples of
the reference's space, narrowed by successive halving.

``sample_config`` makes the same numpy draws as the JAX package's, so a
seed gives the same configurations. Its widths reach past what the CUDA
kernels are instantiated for (F = 32, E = 8 or 64, H = 16 to 256): the
kernel wrappers pad and group them (``ops/banded.py``), so every trial
runs the path the JAX package's rule gives it ("auto": the banded step on
the card when ``banded_fragments_eligible``, else gather).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..config import ModelConfig, TrainConfig
from ..data.dataset import split_dataset
from ..data.embeddings import load_embeddings
from .trainer import Trainer

SEARCH_SPACE = {
    "atom_feature_size": [32, 64, 128, 256],
    "edge_feature_size": [1, 2, 3, 8, 64],
    "edge_hidden_size": [16, 32, 64, 128, 256],
    "mp_layers": [1, 2, 3, 4, 5, 6],
    "fc_layers": [2, 3, 4, 5, 6],
    "edge_fc_layers": [2, 3, 4, 5, 6],
    "noise": [0.0, 0.025, 0.05, 0.1],
    "dropout": [True, False],
    "mp_activation": ["relu", "softplus", "tanh"],
    "fc_activation": ["relu", "softplus"],
    "learning_rate": [1e-3, 5e-4, 1e-4, 1e-5],
}


def sample_config(rng: np.random.Generator) -> ModelConfig:
    """One configuration: a uniform choice per hyperparameter, in the
    order of SEARCH_SPACE."""
    kw = {k: v[rng.integers(len(v))] for k, v in SEARCH_SPACE.items()}
    kw = {k: (bool(v) if isinstance(v, np.bool_) else
              int(v) if isinstance(v, np.integer) else
              float(v) if isinstance(v, np.floating) else v)
          for k, v in kw.items()}
    return ModelConfig(**kw)


def _describe(cfg: ModelConfig, trainer: Trainer) -> str:
    return (f"F={cfg.atom_feature_size} E={cfg.edge_feature_size} H={cfg.edge_hidden_size} "
            f"mp={cfg.mp_layers} lr={cfg.learning_rate} "
            f"path={'banded' if trainer.use_banded else 'gather'}")


def run_hyper(
    tfrecords: List[str],
    epochs: int = 3,
    validation: float = 0.1,
    trials: int = 8,
    tuning_path: str = "tuning",
    seed: int = 0,
    embeddings_path: Optional[str] = None,
    pad_to: int = 256,
    batch_size: int = 8,
    verbose: bool = True,
    device="cuda",
) -> ModelConfig:
    """Successive halving: train every sampled config for a rung of
    ``max(1, epochs // 3)`` epochs, keep the best half by validation loss,
    repeat until one is left, then train it for ``epochs`` more. Writes
    ``results.json`` (every rung's losses), ``best_config.json`` and the
    best model (``best_model/``) into ``tuning_path``; returns the best
    config."""
    from ..library import save_model

    os.makedirs(tuning_path, exist_ok=True)
    emb = load_embeddings(embeddings_path)
    rng = np.random.default_rng(seed)
    train_s, val_s = split_dataset(tfrecords, validation)
    if not val_s:
        split = max(1, len(train_s) // 10)
        val_s, train_s = train_s[:split], train_s[split:]

    candidates = []
    for t in range(trials):
        cfg = sample_config(rng)
        tcfg = TrainConfig(validation=validation, pad_to=pad_to, batch_size=batch_size)
        trainer = Trainer(cfg, tcfg, emb, device=device)
        if verbose:
            print(f"trial {t}: {_describe(cfg, trainer)}", flush=True)
        candidates.append([cfg, None, trainer])

    results = []
    rung = 0
    rung_epochs = max(1, epochs // 3)
    while len(candidates) > 1:
        scored = []
        for entry in candidates:
            cfg, state, trainer = entry
            state = trainer.fit(train_s, val_s, epochs=rung_epochs, state=state, verbose=False,
                                early_stop_patience=5)
            entry[1] = state
            vl = state.history["val_loss"][-1]
            scored.append((vl, entry))
            results.append({"rung": rung, "val_loss": float(vl),
                            "config": json.loads(cfg.to_json())})
            if verbose:
                print(f"rung {rung}: val_loss={vl:.4g} {_describe(cfg, trainer)}", flush=True)
        scored.sort(key=lambda t: (np.isnan(t[0]), t[0]))
        candidates = [e for _, e in scored[:max(1, len(scored) // 2)]]
        rung += 1

    best_cfg, best_state, best_trainer = candidates[0]
    best_state = best_trainer.fit(train_s, val_s, epochs=epochs, state=best_state,
                                  verbose=False, early_stop_patience=5)
    with open(os.path.join(tuning_path, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    with open(os.path.join(tuning_path, "best_config.json"), "w") as f:
        f.write(best_cfg.to_json())
    save_model(os.path.join(tuning_path, "best_model"), best_state.eval_params, best_cfg)
    return best_cfg
