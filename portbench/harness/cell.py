"""One run of one cell: its configuration and traffic as read from their
files, the seed, the device, and the record that the drivers fill and the
metric readers read.

``record`` keys the drivers set:
  t_window      host clock at the window's start (set-up ends there)
  window_s      the window's length
  units         what the window completed: {"requests", "latencies_s"}
  attempted     requests the window started
  work          per request: the least work of one forward,
                ``flops/<mp_type>.py``'s dict
  phases        host seconds of each step of set-up and check (``mark``)
  detail        what a driver adds for diagnosis (printed to standard error)
and the harness adds ``setup_s``, ``peaks`` (the device's table) and
``slice`` (the traced slice's summary, ``harness/trace.py``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import torch


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file path (metric and flop files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    root: str          # the benchmark's folder
    config: dict       # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json
    seed: int
    device: torch.device
    record: dict = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Record the host seconds since the last mark under ``phase``
        (``record["phases"]``: where set-up and check go)."""
        now = time.perf_counter()
        last = self.record.get("_mark", now)
        self.record.setdefault("phases", {})[phase] = now - last
        self.record["_mark"] = now

    def rng(self, stream: int) -> np.random.Generator:
        """The numpy generator of one stream of this run's inputs."""
        return np.random.default_rng([int(self.seed) % (1 << 64), stream])

    def model_config(self):
        """The program's ModelConfig of this cell's configuration."""
        from nmrgnn_tpu_torch.config import ModelConfig

        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        return ModelConfig(**{k: v for k, v in self.config.items() if k in fields})

    def work(self, n_atoms: int, n_edges: int, n_slots: int) -> dict:
        """The least work of one forward (``flops/<mp_type>.py``)."""
        mod = load_module(os.path.join(self.root, "flops", f"{self.config['mp_type']}.py"),
                          f"portbench_flops_{self.config['mp_type']}")
        if self.config["mp_type"] == "attention":
            return mod.work(self.config, n_atoms, n_edges, n_slots)
        return mod.work(self.config, n_atoms, n_edges)
