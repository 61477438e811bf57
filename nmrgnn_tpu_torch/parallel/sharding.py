"""Parameter and batch sharding for mesh-parallel training
(``nmrgnn_tpu/parallel/sharding.py``).

Data parallelism: each rank of the ``data`` axis runs its rows of the
batch, the peaks are gathered over the data group (each rank then computes
the loss of the whole batch, as the JAX package's GSPMD step does) and the
gradients are summed over it. A mean of the ranks' local losses would not
equal the JAX step: ``name_loss`` is a masked mean and a Pearson r over the
whole batch, which do not split over fragments.

Tensor parallelism (the gather path, no kernel, as in the JAX package): the
bilinear MP weights w[F, F, E] shard on their contraction dim and the square
FC kernels on their input dim over the ``graph`` axis (``param_specs``). A
sharded product takes this rank's columns of its input (``_TPSlice``) times
its rows of the weight, then sums over the graph group (``_TPReduce``). Each
has its own backward: the reduce's is the identity, because every graph
rank consumes the same replicated sum; the slice's is an all-gather of the
input cotangent, because every rank holds the whole replicated input. These
are the opposite of ``halo.psum``'s, which is why they are separate
Functions.

A spec is a tuple of axis names and None, one per dim (JAX's
``PartitionSpec``): ``()`` replicated, ``("graph", None, None)`` dim 0
split over ``graph``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..graph import Graph
from ..models import gnn
from ..models.gnn import training_draws
from ..ops.edge import as_operand
from ..ops.message_passing import mp_layer
from .halo import _all_gather, _psum, all_gather_rows, psum_grads
from .mesh import Mesh


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a params tree, keeping its structure (path:
    the dict keys and list indices down to the leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaf_paths(tree, path=()):
    """The paths of a params tree's leaves in ``gnn.tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (i,))
    else:
        yield path


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec_leaves(params, specs) -> list:
    """The specs of ``gnn.trainable_leaves(params)``, in that order."""
    trainable = {k: v for k, v in params.items() if k not in ("peak_std", "peak_avg")}
    return [_at(specs, p) for p in _leaf_paths(trainable)]


def param_specs(params, tp: bool = False, axis: str = "graph"):
    """The spec tree of ``params``: everything replicated, or with ``tp``
    the MP layers' w [F, F, E] split on dim 0 (their contraction dim) and
    the FC block's square kernels on their input dim."""

    def spec_for(path, leaf):
        if not tp:
            return ()
        if "mp" in path and path[-1] == "w":
            return (axis, None, None)
        if ("fc" in path and path[-1] == "kernel" and leaf.dim() == 2
                and leaf.shape[0] == leaf.shape[1]):
            return (axis, None)
        return ()

    return _map(spec_for, params)


def _shard_leaf(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    if not spec or spec[0] is None:
        return x
    n, i = mesh.shape[spec[0]], mesh.index(spec[0])
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows].detach().clone()


def shard_params(params, mesh: Mesh, tp: bool = False, axis: str = "graph"):
    """This rank's params: its slices of the sharded leaves (copies, so an
    optimizer owns them), the replicated leaves as given."""
    specs = param_specs(params, tp, axis)
    return _map(lambda path, x: _shard_leaf(x, _at(specs, path), mesh), params)


def unshard_params(params, specs, mesh: Mesh):
    """The whole params from every rank's slices (``all_gather`` over each
    sharded leaf's axis group): the inverse of ``shard_params``, for saving."""

    def full(path, x):
        spec = _at(specs, path)
        if not spec or spec[0] is None or mesh.shape[spec[0]] == 1:
            return x
        return _all_gather(x.detach().contiguous(), mesh.group(spec[0]))

    return _map(full, params)


def batch_spec() -> Graph:
    """Every batch field split over ``data`` on its leading dim."""
    return Graph(*[("data",)] * 4)


def data_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` split over the data axis."""
    dp = mesh.shape["data"]
    if n % dp:
        raise ValueError(f"batch of {n} not divisible by data axis {dp}")
    d = mesh.index("data")
    return slice(d * (n // dp), (d + 1) * (n // dp))


def shard_batch(mesh: Mesh, graph: Graph, y, w):
    """This data rank's rows of a batch (``graph``, ``y``, ``w``)."""
    rows = data_rows(mesh, len(y))
    return Graph(*[a[rows] for a in graph]), y[rows], w[rows]


# -- tensor-parallel products ----------------------------------------------------


class _TPSlice(torch.autograd.Function):
    """This rank's columns (last dim) of a replicated input; backward: the
    all-gather of the ranks' column cotangents into the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.n = group, n
        c = x.shape[-1] // n
        return x[..., i * c:(i + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = _all_gather(g.movedim(-1, 0).contiguous(), ctx.group)  # [n * c, ...]
        return parts.movedim(0, -1).contiguous(), None


class _TPReduce(torch.autograd.Function):
    """The sum over the group of the ranks' partial products; backward the
    identity (each rank consumes the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp(spec, group) -> bool:
    return bool(spec) and spec[0] is not None and group is not None and \
        dist.get_world_size(group) > 1


def tp_products(params, specs, group) -> dict:
    """``gnn.apply``'s product functions for this rank's params: a dense
    kernel or MP w that ``specs`` splits over ``group`` takes this rank's
    columns of its input times its rows of the weight, summed over the
    group (as GSPMD splits the contraction dim); every other leaf the plain
    product. {} (the plain products) when nothing is split."""
    split = {id(t) for t, sp in zip(gnn.trainable_leaves(params), _spec_leaves(params, specs))
             if _tp(sp, group)}
    if not split:
        return {}

    def dense_fn(p, x, activation=None, cd=torch.float32):
        if id(p["kernel"]) not in split:
            return gnn.dense(p, x, activation, cd)
        y = _TPReduce.apply(as_operand(_TPSlice.apply(x, group), cd)
                            @ as_operand(p["kernel"], cd), group)
        if "bias" in p:
            y = y + p["bias"]
        return activation(y) if activation is not None else y

    def mp_fn(w, nodes, nlist, e, inv_degree, act, cd):
        if id(w) not in split:
            return mp_layer(w, nodes, nlist, e, inv_degree, act, cd)
        op = lambda a: as_operand(a, cd)  # noqa: E731
        # h is whole on every rank (its cotangent too); w [F / n, F, E]
        h = op(torch.einsum("ijn,ijl->inl", op(e), op(nodes[nlist.long()])))  # [N, E, F]
        part = torch.einsum("inl,lmn->im", _TPSlice.apply(h, group), op(w))  # [N, F]
        return act(_TPReduce.apply(part, group) * inv_degree[:, None])

    return {"dense_fn": dense_fn, "mp_fn": mp_fn}


def data_parallel_peaks(local_forward, mesh: Mesh, graph: Graph, noise=None,
                        dropout_mask=None) -> torch.Tensor:
    """Peaks f32[B, N] of the whole batch on every rank: this data rank's
    rows (and their rows of the whole-batch draws) through
    ``local_forward(graph, noise, dropout_mask)``, gathered over the data
    group (``all_gather_rows``: differentiable, each rank's slice of the
    cotangent back)."""
    rows = data_rows(mesh, graph.atoms.shape[0])
    local = Graph(*[a[rows] for a in graph])
    pick = lambda a: None if a is None else a[rows]  # noqa: E731
    peaks = local_forward(local, pick(noise), pick(dropout_mask))
    return all_gather_rows(peaks, mesh.group("data") if mesh.shape["data"] > 1 else None)


def shard_opt_state(opt_state: dict, params, specs, mesh: Mesh, full: bool = False) -> dict:
    """``torch.optim.Adam``'s state dict with its moments laid out like the
    trainable leaves they belong to (``_spec_leaves``): this rank's slices
    (``full=False``) or the whole ones gathered from the ranks'
    (``full=True``); the step count and hyperparameters as they are."""
    if not opt_state or not opt_state.get("state"):
        return opt_state
    leaf_specs = _spec_leaves(params, specs)
    out = {"param_groups": opt_state["param_groups"], "state": {}}
    for i, st in opt_state["state"].items():
        spec = leaf_specs[i]
        move = (lambda x: _all_gather(x.contiguous(), mesh.group(spec[0]))) if full else \
            (lambda x: _shard_leaf(x, spec, mesh))
        sharded = spec and spec[0] is not None and mesh.shape[spec[0]] > 1
        out["state"][i] = {k: (move(v) if sharded and k in ("exp_avg", "exp_avg_sq") else v)
                           for k, v in st.items()}
    return out


def make_parallel_train_step(
    config: ModelConfig,
    loss_idx,
    mesh: Mesh,
    loss_balance: float = 1.0,
    tp: bool = False,
    axis: str = "graph",
):
    """The data-parallel (and with ``tp`` tensor-parallel) training step
    on the gather path. Returns ``(step, shard_init)``:

    ``shard_init(params, opt_state) -> (params, opt_state)`` lays this
    rank's params out by ``param_specs`` and the Adam moments of
    ``opt_state`` (a ``torch.optim.Adam`` state dict, or {}) like the
    parameters they belong to.

    ``step(params, opt, graph, y, w, rng=None, noise=None, dropout_mask=None)
    -> loss`` takes the whole batch (Graph [B, N, ...], y [B, N, 3], w
    [B, N]), as the JAX step takes its global arrays: this data rank's rows
    run ``gnn.apply_batched(training=True)`` (with ``tp`` through the
    sharded products, ``tp_products``), the peaks are gathered over the data group, every rank
    computes the batch's NameLoss, the gradients are summed over the data
    group and ``opt`` (Adam over this rank's ``gnn.trainable_leaves``) steps.
    The training draws are the whole batch's: ``noise`` [B, N, K] and
    ``dropout_mask`` [B, N, F // 2], else drawn from a generator seeded with
    ``rng`` on every rank alike, so the step equals the one-device step on
    the same draws."""
    from ..train.losses import name_loss
    from ..train.trainer import fold_sample_weight

    group = mesh.group(axis)
    specs_of = {}

    def shard_init(params, opt_state):
        specs = param_specs(params, tp, axis)
        specs_of["specs"] = specs
        return (shard_params(params, mesh, tp, axis),
                shard_opt_state(opt_state, params, specs, mesh))

    def step(params, opt, graph, y, w, rng=None, noise=None, dropout_mask=None):
        specs = specs_of.get("specs") or param_specs(params, False, axis)
        leaves = gnn.trainable_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        dev = params["embed"]["kernel"].device
        B, N = graph.nlist.shape[:2]
        gen = None if rng is None else torch.Generator(device=dev).manual_seed(int(rng))
        noise, dropout_mask = training_draws(config, graph.edges, (B, N, config.atom_feature_size
                                                                   // 2), noise, dropout_mask,
                                             gen)
        products = tp_products(params, specs, group)
        peaks = data_parallel_peaks(
            lambda g, nz, dm: gnn.apply_batched(params, config, g, training=True, noise=nz,
                                                dropout_mask=dm, **products),
            mesh, graph, noise, dropout_mask)
        yt = fold_sample_weight(y, w)
        loss = name_loss(yt.reshape(-1, 3), peaks.reshape(-1), loss_idx, s=loss_balance)
        grads = psum_grads(torch.autograd.grad(loss, leaves),
                           mesh.group("data") if mesh.shape["data"] > 1 else None)
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
        return loss.detach()

    return step, shard_init
