"""Training loop on one device (``nmrgnn_tpu/train/trainer.py``): Adam, the
plateau or cosine learning-rate schedule, EMA, best-restore, early stop,
NaN recovery, metric moments summed over an epoch, checkpoint and resume.

  * Adam is ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8): optax's
    ``adam`` in exact arithmetic. The learning rate is set in its
    ``param_groups`` each epoch (the counterpart of optax's
    ``inject_hyperparams``).
  * The step's forward is ``models/infer.apply_banded_fragments`` (the band
    build and MP kernels forward, plain PyTorch backward) on the "banded"
    path, or ``models/gnn.apply_batched`` on "gather"
    (``TrainConfig.mp_path``; "auto" takes banded on a CUDA device when the
    shapes are eligible). Noise and dropout are drawn from a
    ``torch.Generator`` on the device seeded with ``seed + 1``.
  * ``compiled_epochs`` (the default) stages the padded fragments on the
    device once and gathers each batch there in the loader's seeded order:
    no host copy and no host sync a step, one loss readback an epoch.
    Otherwise the loader's batches are copied in one by one.
  * Checkpoints: the model through ``library.save_model`` (readable by
    both packages), the optimizer, EMA and schedule state in the port's own
    ``train_state.pt`` (``torch.save``). ``load_train_checkpoint`` also
    resumes a directory the JAX package's Trainer wrote: its optax Adam
    state (``opt_state.msgpack``), EMA (``ema.msgpack``) and schedule
    (``train_state.pkl``).

Entry points run on ``device`` ("cuda" by default, raising without a
card); the CPU runs the kernels' plain versions.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import ModelConfig, TrainConfig
from ..data.dataset import FragmentLoader, Sample, pad_sample
from ..data.embeddings import load_embeddings, load_standards
from ..graph import Graph
from .. import _msgpack
from ..library import load_model, params_from_numpy, save_model
from ..models import gnn
from ..models.gnn import training_draws
from ..models.infer import apply_banded_fragments, fragment_band_plan
from ..ops.banded import plan_fits_vmem, plan_on_device
from ..parallel import sharding
from ..parallel.halo import psum_grads
from .losses import label_mask, name_loss
from .metrics import METRIC_SPECS, type_mask

# metric moments: enough to finalize rmsd / corr / count over an epoch
_MOMENT_NAMES = ("w", "wx", "wy", "wx2", "wy2", "wxy", "wd2")
_STATE_FILE = "train_state.pt"
# what the JAX package's Trainer writes beside the model
# (nmrgnn_tpu/train/trainer.py:123-175)
_JAX_OPT_FILE = "opt_state.msgpack"
_JAX_EMA_FILE = "ema.msgpack"
_JAX_META_FILE = "train_state.pkl"
_META_KEYS = ("epoch", "lr", "best_val", "plateau", "history")


def _moments(y_true, y_pred, label_idx) -> torch.Tensor:
    w = label_mask(y_true, label_idx)
    x = y_true[..., 0]
    y = y_pred
    return torch.stack([w.sum(), (w * x).sum(), (w * y).sum(), (w * x * x).sum(),
                        (w * y * y).sum(), (w * x * y).sum(), (w * (x - y) ** 2).sum()])


def finalize_metric(kind: str, m) -> float:
    w, wx, wy, wx2, wy2, wxy, wd2 = [float(v) for v in m]
    if kind == "count":
        return w
    if w == 0:
        return 0.0
    if kind == "rmsd":
        return float(np.sqrt(wd2 / w))
    if kind == "corr":
        xm, ym = wx / w, wy / w
        cov = wxy / w - xm * ym
        vx = wx2 / w - xm * xm
        vy = wy2 / w - ym * ym
        den = np.sqrt(max(vx * vy, 0.0))
        return float(cov / den) if den > 0 else 0.0
    raise ValueError(kind)


def metric_kinds() -> List[Tuple[str, str, tuple]]:
    """(metric name, kind, label indices) of the standard suite."""
    emb = load_embeddings()
    out = []
    for name, _, pattern in METRIC_SPECS:
        kind = "rmsd" if "rmsd" in name else ("count" if "count" in name else "corr")
        try:
            idx = tuple(type_mask(pattern, emb, regex=True))
        except ValueError:
            continue
        out.append((name, kind, idx))
    return out


def fold_sample_weight(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y with the per-atom sample weight multiplied into its flag channel."""
    return torch.cat([y[..., :2], (y[..., 2] * w)[..., None]], dim=-1)


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict  # torch.optim.Adam's state_dict ({} before the first step)
    epoch: int = 0
    lr: float = 1e-4
    best_val: float = float("inf")
    plateau: int = 0
    history: dict = dataclasses.field(default_factory=dict)
    # moving average of the params (None when ema_decay is 0), evaluated
    # and exported while the raw params keep training
    ema_params: Optional[dict] = None

    @property
    def eval_params(self) -> dict:
        """Weights to evaluate and export: the EMA when on, else the raw."""
        return self.ema_params if self.ema_params is not None else self.params


def _detached_copy(tree):
    return gnn.tree_map(lambda t: t.detach().clone(), tree)


def save_train_checkpoint(path: str, state: TrainState, config: ModelConfig) -> None:
    """The model (``save_model``: ``load_model`` of either package reads
    it) and ``train_state.pt``: the optimizer, EMA and schedule state."""
    os.makedirs(path, exist_ok=True)
    save_model(path, state.params, config)
    torch.save({
        "opt_state": state.opt_state,
        "ema_params": None if state.ema_params is None else _detached_copy(state.ema_params),
        "epoch": state.epoch, "lr": state.lr, "best_val": state.best_val,
        "plateau": state.plateau, "history": state.history,
    }, os.path.join(path, _STATE_FILE))


def load_train_checkpoint(path: str, state: TrainState, device) -> TrainState:
    """Inverse of ``save_train_checkpoint``, into ``state`` (a fresh one).

    A directory the JAX package's Trainer wrote (``opt_state.msgpack``,
    ``train_state.pkl``, ``ema.msgpack`` when its EMA was on) is read too:
    optax's Adam count and moments become ``torch.optim.Adam``'s step,
    ``exp_avg`` and ``exp_avg_sq`` (the same update), the EMA and the
    schedule state are restored; a file of it that is missing or not in
    that layout raises. A directory with the model alone (``save_model``)
    restarts the optimizer and schedule, with a warning."""
    state.params, _ = load_model(path, device=device)
    meta_file = os.path.join(path, _STATE_FILE)
    if os.path.exists(meta_file):
        meta = torch.load(meta_file, map_location=device, weights_only=True)
        state.opt_state = meta["opt_state"]
        state.ema_params = meta["ema_params"]
        for k in _META_KEYS:
            setattr(state, k, meta[k])
        return state
    jax_files = [f for f in (_JAX_OPT_FILE, _JAX_META_FILE, _JAX_EMA_FILE)
                 if os.path.exists(os.path.join(path, f))]
    if not jax_files:
        warnings.warn(f"{path} holds a model and no training state: the optimizer, EMA and "
                      "schedule start afresh", stacklevel=2)
        return state
    for f in (_JAX_OPT_FILE, _JAX_META_FILE):
        if f not in jax_files:
            raise ValueError(f"{path}: a JAX training checkpoint without {f}")
    with open(os.path.join(path, _JAX_OPT_FILE), "rb") as f:
        opt_tree = _msgpack.restore_arrays(_msgpack.unpackb(f.read()))
    with open(os.path.join(path, _JAX_META_FILE), "rb") as f:
        meta = _MetaUnpickler(f).load()
    if not isinstance(meta, dict) or any(k not in meta for k in _META_KEYS):
        raise ValueError(f"{path}/{_JAX_META_FILE} lacks the schedule keys {_META_KEYS}")
    state.opt_state = _adam_state_from_optax(opt_tree, state.params, device)
    for k in _META_KEYS:
        setattr(state, k, meta[k])
    state.epoch, state.plateau = int(state.epoch), int(state.plateau)
    state.lr, state.best_val = float(state.lr), float(state.best_val)
    if _JAX_EMA_FILE in jax_files:
        with open(os.path.join(path, _JAX_EMA_FILE), "rb") as f:
            ema = params_from_numpy(_msgpack.restore_arrays(_msgpack.unpackb(f.read())), device)
        if [tuple(t.shape) for t in gnn.tree_leaves(ema)] != [
                tuple(t.shape) for t in gnn.tree_leaves(state.params)]:
            raise ValueError(f"{path}/{_JAX_EMA_FILE} does not match the model's parameters")
        state.ema_params = ema
    return state


class _MetaUnpickler(pickle.Unpickler):
    """Reads the JAX package's schedule pickle, whose values are Python
    numbers, lists and dicts, and numpy scalars; any other class raises."""

    _ALLOWED = {("numpy", "dtype"), ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a schedule pickle")


def _adam_state_from_optax(opt_tree, params, device) -> dict:
    """``torch.optim.Adam``'s state dict over ``params``' trainable leaves
    from the JAX package's optax state (``inject_hyperparams(adam)``:
    ``inner_state[0]`` holds Adam's count, mu and nu over the whole params
    tree). optax's mu, nu and count are Adam's exp_avg, exp_avg_sq and
    step, with the same bias corrections."""
    try:
        adam = opt_tree["inner_state"][0]
        count, mu, nu = adam["count"], adam["mu"], adam["nu"]
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError("opt_state.msgpack is not the JAX package's Adam state") from e
    leaves = gnn.trainable_leaves(params)
    exp_avg = gnn.trainable_leaves(params_from_numpy(mu, device))
    exp_avg_sq = gnn.trainable_leaves(params_from_numpy(nu, device))
    shapes = [tuple(t.shape) for t in leaves]
    if ([tuple(t.shape) for t in exp_avg] != shapes
            or [tuple(t.shape) for t in exp_avg_sq] != shapes):
        raise ValueError("opt_state.msgpack's Adam moments do not match the model's parameters")
    sd = torch.optim.Adam([t.detach() for t in leaves]).state_dict()
    step = int(np.asarray(count))
    if step > 0:
        sd["state"] = {i: {"step": torch.tensor(float(step)), "exp_avg": m, "exp_avg_sq": v}
                       for i, (m, v) in enumerate(zip(exp_avg, exp_avg_sq))}
    return sd


def adam(state: TrainState) -> torch.optim.Adam:
    """Adam over ``state.params``' trainable leaves (made to require grad),
    holding ``state.opt_state`` and ``state.lr`` (optax's ``adam``: betas
    0.9 / 0.999, eps 1e-8)."""
    leaves = gnn.trainable_leaves(state.params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=state.lr, betas=(0.9, 0.999), eps=1e-8)
    if state.opt_state:
        opt.load_state_dict(state.opt_state)
    set_lr(opt, state.lr)
    return opt


def set_lr(opt: torch.optim.Adam, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def banded_fragments_eligible(config: ModelConfig, batch_size: int, pad_to: int, dp: int = 1,
                              tensor_parallel: bool = False) -> Tuple[bool, bool]:
    """(shape_ok, vmem_fits) of the banded fragment path: the bilinear MP
    family with pad_to and F multiples of 128, no tensor parallelism, and a
    flattened [batch / dp * pad_to, F] table (one data rank's) within the
    JAX package's node-table budget (``plan_fits_vmem``), so that both
    packages take the same path for the same configuration."""
    shape_ok = (config.mp_type == "bilinear" and pad_to % 128 == 0
                and config.atom_feature_size % 128 == 0 and not tensor_parallel)
    fits = shape_ok and plan_fits_vmem(
        fragment_band_plan(max(batch_size // dp, 1), pad_to), config.atom_feature_size,
        n_edge_channels=config.edge_feature_size)
    return shape_ok, fits


def fit_epochs(trainer, state: TrainState, opt: torch.optim.Adam, epochs: int,
               train_epoch: Callable[[], Tuple[float, int]], val_samples, checkpoint_path,
               verbose: bool, callbacks, early_stop_patience) -> TrainState:
    """The epoch loop of ``Trainer.fit`` and ``PartitionedTrainer.fit``:
    the cosine learning rate, ``train_epoch()`` (the sum of the steps'
    losses and the step count), NaN recovery (the last finite epoch
    restored, lr halved, 3 retries), the validation through
    ``trainer.evaluate``, the plateau schedule, best-restore, history,
    checkpoints, callbacks and early stop."""
    # the last finite epoch, restored on a non-finite loss
    snapshot = None
    nan_retries = stall = 0
    best_seen = best_restore = float("inf")
    best_weights = None
    total_epochs = state.epoch + epochs
    for _ in range(epochs):
        if trainer.tcfg.lr_schedule == "cosine":
            peak, lo, wu = (trainer.config.learning_rate, trainer.tcfg.cosine_final_lr,
                            trainer.tcfg.warmup_epochs)
            if state.epoch < wu:
                state.lr = peak * (state.epoch + 1) / wu
            else:
                t = (state.epoch - wu) / max(total_epochs - wu, 1)
                state.lr = float(lo + 0.5 * (peak - lo) * (1.0 + np.cos(np.pi * t)))
        set_lr(opt, state.lr)
        epoch_loss, nb = train_epoch()
        if not np.isfinite(epoch_loss):
            if snapshot is None or nan_retries >= 3:
                raise FloatingPointError(
                    f"non-finite training loss at epoch {state.epoch + 1}")
            nan_retries += 1
            params, opt_state, ema = snapshot
            with torch.no_grad():
                for t, s in zip(gnn.tree_leaves(state.params), params):
                    t.copy_(s)
                if ema is not None:
                    for t, s in zip(gnn.tree_leaves(state.ema_params), ema):
                        t.copy_(s)
            opt.load_state_dict(copy.deepcopy(opt_state))
            state.lr = max(state.lr * 0.5, trainer.tcfg.min_lr)
            if verbose:
                print(f"non-finite loss; restored last epoch snapshot, lr -> "
                      f"{state.lr:g} (retry {nan_retries}/3)", flush=True)
            continue
        snapshot = ([t.detach().clone() for t in gnn.tree_leaves(state.params)],
                    copy.deepcopy(opt.state_dict()),
                    None if state.ema_params is None else
                    [t.clone() for t in gnn.tree_leaves(state.ema_params)])
        state.opt_state = opt.state_dict()
        state.epoch += 1
        logs = {"loss": epoch_loss / max(nb, 1), "lr": state.lr}
        if val_samples:
            val = trainer.evaluate(val_samples, state.eval_params)
            logs.update({f"val_{k}": v for k, v in val.items()})
            if trainer.tcfg.lr_schedule == "plateau":  # ReduceLROnPlateau
                if logs["val_loss"] < state.best_val - 1e-12:
                    state.best_val = logs["val_loss"]
                    state.plateau = 0
                else:
                    state.plateau += 1
                    if state.plateau >= trainer.tcfg.lr_patience:
                        if state.lr > trainer.tcfg.min_lr:
                            state.lr = max(state.lr * trainer.tcfg.lr_reduce_factor,
                                           trainer.tcfg.min_lr)
                        state.plateau = 0
            if trainer.tcfg.restore_best and logs["val_loss"] < best_restore:
                best_restore = logs["val_loss"]
                best_weights = _detached_copy(state.eval_params)
        for k, v in logs.items():
            state.history.setdefault(k, []).append(v)
        if verbose:
            msg = " ".join(f"{k}={v:.4g}" for k, v in logs.items() if isinstance(v, float))
            print(f"epoch {state.epoch}: {msg}", flush=True)
        if checkpoint_path:
            trainer.save_checkpoint(checkpoint_path, state)
        for cb in callbacks:
            cb(state, logs)
        if early_stop_patience and "val_loss" in logs:
            if logs["val_loss"] < best_seen - 1e-12:
                best_seen = logs["val_loss"]
                stall = 0
            else:
                stall += 1
                if stall >= early_stop_patience:
                    if verbose:
                        print(f"early stop: no val improvement in {early_stop_patience} "
                              "epochs", flush=True)
                    break
    state.opt_state = opt.state_dict()
    if best_weights is not None:
        # the best-validation weights, through the EMA slot when it is on
        if state.ema_params is not None:
            state.ema_params = best_weights
        else:
            state.params = best_weights
    return state


class Trainer:
    def __init__(
        self,
        config: Optional[ModelConfig] = None,
        train_config: Optional[TrainConfig] = None,
        embeddings: Optional[dict] = None,
        device="cuda",
        mesh=None,
        tensor_parallel: bool = False,
    ):
        """``mesh`` (``parallel.make_mesh``) trains data-parallel over its
        ``data`` axis: each data rank runs its ``batch_size / data`` rows of
        every batch (the banded path through B2 and B1 at
        ``fragment_band_plan(batch_size / data, pad_to)``), the peaks are
        gathered, every rank computes the batch's loss and the gradients are
        summed over the data group (``parallel/sharding.py``); the draws are
        the whole batch's, alike on every rank, so a step equals the
        one-device step. With ``tensor_parallel`` the MP and square FC
        kernels are also split over the ``graph`` axis (the gather path);
        ``fit`` hands back the whole params. Every rank of the mesh runs
        the same calls."""
        self.config = config or ModelConfig()
        if self.config.mp_type in gnn.POSITIONS_FAMILIES:
            raise ValueError(f"Trainer does not train mp_type={self.config.mp_type!r}: the "
                             "family serves inference only")
        self.tcfg = train_config or TrainConfig()
        self.mesh = mesh
        self.tensor_parallel = tensor_parallel
        self.device = resolve_device(device)
        self.embeddings = embeddings or load_embeddings()
        self.metric_specs = metric_kinds()
        dev = self.device
        self.loss_idx = torch.as_tensor(type_mask(r".*", self.embeddings, regex=True),
                                        dtype=torch.int64, device=dev)
        self._spec_idx = [torch.as_tensor(idx, dtype=torch.int64, device=dev)
                          for _, _, idx in self.metric_specs]
        self._head_idx = None
        if self.tcfg.head_decay > 0:
            elems = [e.strip().upper() for e in self.tcfg.head_decay_elements.split(",")
                     if e.strip()]
            if elems:
                self._head_idx = torch.as_tensor(
                    [self.embeddings["atom"][e] for e in elems], dtype=torch.int64, device=dev)
        self._dp = mesh.shape["data"] if mesh is not None else 1
        self.use_banded = self._resolve_mp_path()
        self._plan = (plan_on_device(fragment_band_plan(self.tcfg.batch_size // self._dp,
                                                        self.tcfg.pad_to), dev)
                      if self.use_banded else None)
        self._specs = None
        if mesh is not None and tensor_parallel:
            self._specs = sharding.param_specs(
                gnn.init_params(self.config, torch.Generator().manual_seed(0), device="cpu"),
                True)
        self._resident: dict = {}

    def _resolve_mp_path(self) -> bool:
        """Whether the train and eval steps run the banded path
        (``TrainConfig.mp_path``): "auto" takes it on a CUDA device when
        eligible, as the JAX package takes it on a TPU."""
        path = self.tcfg.mp_path
        if path == "gather":
            return False
        shape_ok, fits = banded_fragments_eligible(self.config, self.tcfg.batch_size,
                                                   self.tcfg.pad_to, self._dp,
                                                   self.tensor_parallel)
        eligible = shape_ok and fits
        if path == "banded":
            if not eligible:
                raise ValueError(
                    "mp_path='banded' requires the bilinear MP family, pad_to and "
                    "atom_feature_size multiples of 128, no tensor parallelism, and a "
                    "per-shard batch_size*pad_to*F working set that fits VMEM (the JAX "
                    f"package's budget) (got mp_type={self.config.mp_type}, "
                    f"batch_size={self.tcfg.batch_size}, pad_to={self.tcfg.pad_to}, "
                    f"F={self.config.atom_feature_size}, "
                    f"tensor_parallel={self.tensor_parallel}, vmem_fit={fits})")
            return True
        if path != "auto":
            raise ValueError(f"unknown mp_path {path!r}")
        return eligible and self.device.type == "cuda"

    # -- forwards and steps ------------------------------------------------
    def _local_forward(self, params, graph: Graph, training: bool, noise=None,
                       dropout_mask=None) -> torch.Tensor:
        """Peaks f32[b, N] of ``graph`` (one data rank's rows under a mesh)
        on the resolved path, with the given draws."""
        kw = dict(training=training, noise=noise, dropout_mask=dropout_mask)
        if self.use_banded:
            return apply_banded_fragments(params, self.config, graph, plan=self._plan, **kw)
        if self._specs is not None:
            kw.update(sharding.tp_products(params, self._specs, self.mesh.group("graph")))
        return gnn.apply_batched(params, self.config, graph, **kw)

    def train_forward(self, params, graph: Graph, generator=None, noise=None,
                      dropout_mask=None) -> torch.Tensor:
        """Training-mode peaks f32[B, N] of a batch on the resolved path:
        the whole batch's draws (given, or from ``generator``), under a
        mesh this data rank's rows of them and the peaks gathered."""
        B, N = graph.nlist.shape[:2]
        noise, dropout_mask = training_draws(self.config, graph.edges,
                                             (B, N, self.config.atom_feature_size // 2), noise,
                                             dropout_mask, generator)
        if self.mesh is None:
            return self._local_forward(params, graph, True, noise, dropout_mask)
        return sharding.data_parallel_peaks(
            lambda g, nz, dm: self._local_forward(params, g, True, nz, dm), self.mesh, graph,
            noise, dropout_mask)

    def eval_forward(self, params, graph: Graph) -> torch.Tensor:
        if self.mesh is None:
            return self._local_forward(params, graph, False)
        return sharding.data_parallel_peaks(
            lambda g, nz, dm: self._local_forward(params, g, False), self.mesh, graph)

    def loss_fn(self, params, graph: Graph, y, w, generator=None, noise=None,
                dropout_mask=None) -> torch.Tensor:
        peaks = self.train_forward(params, graph, generator, noise, dropout_mask)
        yt = fold_sample_weight(y, w)
        loss = name_loss(yt.reshape(-1, 3), peaks.reshape(-1), self.loss_idx,
                         s=self.tcfg.loss_balance)
        if self._head_idx is not None:
            # L2 on the selected element columns of the out head; under a
            # mesh its gradient counts once in the sum over the data group
            cols = params["out"]["kernel"][:, self._head_idx]
            term = self.tcfg.head_decay * torch.sum(cols * cols)
            if self.mesh is not None and self.mesh.index("data") != 0:
                term = term.detach()
            loss = loss + term
        return loss

    def optimizer(self, state: TrainState) -> torch.optim.Adam:
        return adam(state)

    def train_step(self, state: TrainState, opt: torch.optim.Adam, graph: Graph, y, w,
                   generator=None, noise=None, dropout_mask=None) -> torch.Tensor:
        """One step: loss, gradients, Adam, EMA. Returns the loss as a
        device tensor (no host sync)."""
        leaves = gnn.trainable_leaves(state.params)
        loss = self.loss_fn(state.params, graph, y, w, generator, noise, dropout_mask)
        grads = torch.autograd.grad(loss, leaves)
        if self._dp > 1:  # the data ranks' shares of the batch's gradient
            grads = psum_grads(grads, self.mesh.group("data"))
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
        decay = self.tcfg.ema_decay
        if decay > 0 and state.ema_params is not None:
            with torch.no_grad():
                for e, p in zip(gnn.tree_leaves(state.ema_params),
                                gnn.tree_leaves(state.params)):
                    e.mul_(decay).add_(p, alpha=1.0 - decay)
        return loss.detach()

    def eval_step(self, params, graph: Graph, y, w):
        """(loss, metric moments [specs, 7]) of a batch, as device tensors."""
        with torch.no_grad():
            peaks = self.eval_forward(params, graph)
            yt = fold_sample_weight(y, w).reshape(-1, 3)
            yp = peaks.reshape(-1)
            loss = name_loss(yt, yp, self.loss_idx, s=self.tcfg.loss_balance)
            moments = torch.stack([_moments(yt, yp, idx) for idx in self._spec_idx])
        return loss, moments

    def _to_device(self, g, y, w):
        dev = self.device
        dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
        graph = Graph(*[torch.as_tensor(np.asarray(a)).to(dev, dt) for a, dt in zip(g, dtypes)])
        return (graph, torch.as_tensor(np.asarray(y), dtype=torch.float32, device=dev),
                torch.as_tensor(np.asarray(w), dtype=torch.float32, device=dev))

    def _resident_dataset(self, samples: Sequence[Sample]):
        """The padded fragments on the device, staged once per sample list
        (the count rounded up to whole batches with zero-weight copies of
        the first); the cache holds the list, so its id cannot be reused."""
        key = (id(samples), len(samples))
        hit = self._resident.get(key)
        if hit is not None:
            return hit[1]
        padded = [pad_sample(s, self.tcfg.pad_to) for s in samples]
        s_pad = (-len(padded)) % self.tcfg.batch_size
        if s_pad:
            filler = padded[0]
            dead = Sample(graph=filler.graph, y=np.array(filler.y, np.float32),
                          w=np.zeros_like(filler.w))
            dead.y[:, 2] = 0.0
            padded = padded + [dead] * s_pad
        g = Graph(*[np.stack([getattr(s.graph, f) for s in padded]) for f in Graph._fields])
        table = self._to_device(g, np.stack([s.y for s in padded]),
                                np.stack([s.w for s in padded]))
        if len(self._resident) >= 4:  # bound the device memory of stale tables
            self._resident.pop(next(iter(self._resident)))
        self._resident[key] = (samples, table)
        return table

    def _batch_rows(self, order: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(order.reshape(-1, self.tcfg.batch_size).astype(np.int64),
                               device=self.device)

    # -- state and checkpoints ---------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh state: Keras-default initial weights drawn from
        ``generator`` (default seeded with ``seed``), the element
        standards, no optimizer state."""
        gen = generator or torch.Generator().manual_seed(self.tcfg.seed)
        params = gnn.init_params(self.config, gen, load_standards(), device=self.device)
        return TrainState(params=params, opt_state={}, lr=self.config.learning_rate)

    def save_checkpoint(self, path: str, state: TrainState) -> None:
        """Under a mesh every rank calls it (the whole params are gathered
        from the tensor-parallel slices) and rank 0 writes."""
        if self._specs is not None:
            state = self._whole(state)
        if self.mesh is None or self.mesh.rank == 0:
            save_train_checkpoint(path, state, self.config)

    def load_checkpoint(self, path: str) -> TrainState:
        return load_train_checkpoint(path, self.init_state(), self.device)

    # -- tensor-parallel layout ------------------------------------------------
    def _local(self, params):
        """This rank's slices of ``params`` under tensor parallelism (as
        given when they are slices already, or without it)."""
        if self._specs is None:
            return params
        leaf = sharding._spec_leaves(params, self._specs)
        for t, sp in zip(gnn.trainable_leaves(params), leaf):
            if sp and sp[0] is not None:
                if t.shape[0] != self.config.atom_feature_size:
                    return params  # already this rank's slices
                break
        return sharding.shard_params(params, self.mesh, True)

    def _whole(self, state: TrainState) -> TrainState:
        """A copy of ``state`` with the whole params, EMA and Adam moments
        gathered from the ranks' slices."""
        full = lambda t: None if t is None else sharding.unshard_params(  # noqa: E731
            t, self._specs, self.mesh)
        return dataclasses.replace(
            state, params=full(state.params), ema_params=full(state.ema_params),
            opt_state=sharding.shard_opt_state(state.opt_state, state.params, self._specs,
                                               self.mesh, full=True))

    # -- epochs ------------------------------------------------------------
    def _finalize(self, loss: float, nb: int, acc: np.ndarray) -> Dict[str, float]:
        out = {"loss": loss / max(nb, 1)}
        for (name, kind, _), m in zip(self.metric_specs, acc):
            out[name] = finalize_metric(kind, m)
        return out

    def evaluate(self, samples: Sequence[Sample], params) -> Dict[str, float]:
        """Loss and metrics over ``samples``: the resident table, the
        batches' losses and moments summed on the device in float64 (as
        ``evaluate_loader`` sums them on the host), one readback."""
        params = self._local(params)
        dg, dy, dw = self._resident_dataset(samples)
        idx = self._batch_rows(np.arange(dy.shape[0]))
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        acc = torch.zeros((len(self.metric_specs), len(_MOMENT_NAMES)), dtype=torch.float64,
                          device=self.device)
        for ib in idx:
            loss, moments = self.eval_step(params, Graph(*[a[ib] for a in dg]), dy[ib], dw[ib])
            total += loss
            acc += moments
        return self._finalize(float(total), idx.shape[0], acc.cpu().numpy())

    def evaluate_loader(self, loader: FragmentLoader, params=None,
                        state: Optional[TrainState] = None) -> Dict[str, float]:
        params = params if params is not None else state.params
        total, nb = 0.0, 0
        acc = np.zeros((len(self.metric_specs), len(_MOMENT_NAMES)))
        for g, y, w in loader.batches():
            loss, moments = self.eval_step(params, *self._to_device(g, y, w))
            total += float(loss)
            nb += 1
            acc += moments.cpu().numpy()
        return self._finalize(total, nb, acc)

    def _train_epoch(self, state, opt, loader, train_samples, generator) -> Tuple[float, int]:
        """(sum of the step losses, steps) of one epoch."""
        if self.tcfg.compiled_epochs:
            dg, dy, dw = self._resident_dataset(train_samples)
            order = loader._epoch_order()  # the loader's seeded stream
            if dy.shape[0] > len(order):
                order = np.concatenate([order, np.arange(len(order), dy.shape[0])])
            idx = self._batch_rows(order)
            losses = [self.train_step(state, opt, Graph(*[a[ib] for a in dg]), dy[ib], dw[ib],
                                      generator) for ib in idx]
            return float(torch.stack(losses).sum()), len(losses)
        total, nb = 0.0, 0
        for g, y, w in loader.batches():
            total += float(self.train_step(state, opt, *self._to_device(g, y, w), generator))
            nb += 1
        return total, nb

    def fit(
        self,
        train_samples: Sequence[Sample],
        val_samples: Sequence[Sample],
        epochs: Optional[int] = None,
        state: Optional[TrainState] = None,
        checkpoint_path: Optional[str] = None,
        verbose: bool = True,
        callbacks: Sequence[Callable] = (),
        early_stop_patience: Optional[int] = None,
    ) -> TrainState:
        """Train for ``epochs`` (default ``TrainConfig.epochs``) from
        ``state`` (default ``init_state()``), whose params are updated in
        place. ``early_stop_patience``: stop when the validation loss has not
        improved for that many epochs."""
        epochs = epochs or self.tcfg.epochs
        state = state or self.init_state()
        if self.mesh is not None and self.tcfg.batch_size % self._dp:
            raise ValueError(f"batch_size {self.tcfg.batch_size} not divisible by data axis "
                             f"{self._dp}")
        if self._specs is not None:  # this rank's slices while training
            whole_params = state.params
            state.params = self._local(state.params)
            state.ema_params = None if state.ema_params is None else self._local(
                state.ema_params)
            state.opt_state = sharding.shard_opt_state(state.opt_state, whole_params,
                                                       self._specs, self.mesh)
        generator = torch.Generator(device=self.device).manual_seed(self.tcfg.seed + 1)
        loader = FragmentLoader(train_samples, pad_to=self.tcfg.pad_to,
                                batch_size=self.tcfg.batch_size, shuffle=True,
                                seed=self.tcfg.seed)
        if self.tcfg.ema_decay > 0 and state.ema_params is None:
            state.ema_params = _detached_copy(state.params)
        opt = self.optimizer(state)
        state = fit_epochs(
            self, state, opt, epochs,
            lambda: self._train_epoch(state, opt, loader, train_samples, generator),
            val_samples, checkpoint_path, verbose, callbacks, early_stop_patience)
        if self._specs is not None:
            state = self._whole(state)
        return state
