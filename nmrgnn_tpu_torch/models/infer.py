"""Banded and block-sparse inference forwards (``nmrgnn_tpu/models/infer.py``).

``apply_banded`` builds the band once per forward and runs one banded MP
layer per ``params["mp"]`` entry, then the readout. The edge stage is the
exact one (fused RBF + EdgeFC + build by default) or, given ``cheb``, its
Chebyshev compression, the "fast" precision's. With ``fused_first`` the
Chebyshev build and MP layer 1 are one kernel (``mp_banded_poly_fused``).

``apply_banded_classes`` is the class-bucketed forward of the fast
precision: one Chebyshev band per window class, and per MP layer one
partial product per class, whose rows are put back in place before the
activation and residual. ``apply_banded_hbm_classes`` is its twin for
structures past the node-table budget: per class and layer the whole MP
layer (epilogue included) with the table in device memory, and the table
kept in the compute type between layers.

``apply_banded_frames`` runs ``apply_banded`` over a stack of frames at
once: the frames are concatenated along the rows, so each kernel is
launched once per forward for the whole batch.

With the kernels on, each banded forward makes its band's chunk occupancy
once (``band_occupancy``, from nlist, the distances and the window starts)
and hands it to every MP layer that reads the band, so the MP kernel
stages only the chunks that hold a nonzero.

``apply_banded_attention`` (``nmrgnn_tpu/models/infer.py:444-533``) serves
the attention family (AMPLayer) on the band: per MP layer the softmax
weights of the real slots make a one-channel band (``build_band``, E=1),
``mp_banded_partial`` multiplies it with the node table and wv, and the
padding slots' softmax mass comes back as one rank-1 term per distinct
row that padding slots name, as ``gnn.apply`` sends it.
``apply_banded_attention_frames`` runs it over a stack of frames laid end
to end, as ``apply_banded_frames`` does.

``apply_banded_fragments`` and ``apply_banded_trainable``
(``nmrgnn_tpu/models/infer.py:536-686``) are the differentiable banded
forwards of training: a batch of padded fragments laid end to end
(``fragment_band_plan``: the window is the fragment, so the plan is
static), or one graph with its band plan. The band build and the MP layers
go through the ``*_df`` wrappers of ``ops/banded.py`` (the kernels
forward, plain PyTorch backward), the band and the MP layers in float32
whatever the compute type; the occupancy comes from the distances before
the training noise, which mask the band.

``apply_blocksparse`` (``nmrgnn_tpu/models/infer.py:51-124``) serves a
structure whose band is too wide for the banded paths: it builds the
block-sparse adjacency of the active (row block, col block) pairs once per
forward and runs one block-sparse MP layer per ``params["mp"]`` entry,
each given the adjacency's block occupancy, made once per forward. Its
numerics are its own: the exact edge stage in float32 at either compute
type, and a float32 readout.

The products honour ``config.compute_dtype`` (bfloat16 operands, float32
sums), as the JAX package's forwards do. ``graph`` should be RCM-reordered
(``data.reorder.rcm_order`` with ``pin_zero=False``) so the band is
narrow; the result does not depend on the order. Under a profiler session
every MP layer of every forward here is one ``nmrgnn.mp`` span.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from ..config import ModelConfig
from ..graph import Graph
from ..ops.activations import get_activation
from ..ops.banded import (
    BandClassPlan,
    BandPlan,
    band_occupancy,
    band_plan,
    build_band,
    build_band_fused,
    build_band_plain,
    build_band_poly,
    build_band_poly_cls,
    build_band_poly_cls_plain,
    build_band_poly_plain,
    build_band_df,
    mp_banded,
    mp_banded_partial_df,
    mp_banded_df,
    mp_banded_hbm,
    mp_banded_hbm_cls,
    mp_banded_hbm_cls_plain,
    mp_banded_hbm_plain,
    mp_banded_partial,
    mp_banded_partial_plain,
    mp_banded_plain,
    mp_banded_poly_fused,
    plan_on_device,
)
from ..ops.blocksparse import (
    BlockStructure,
    block_occupancy,
    block_structure,
    build_block_adjacency,
    build_block_adjacency_plain,
    mp_blocksparse,
    mp_blocksparse_plain,
    struct_on_device,
)
from ..ops.edge import edge_features as _edge_stage
from ..ops.edgefn import EdgeCheb, eval_edge_chebyshev_device
from ..ops.message_passing import attention_weights
from ..utils.profiling import span
from .gnn import compute_dtype, dense, flatten_batch, noised, readout, training_draws
from .gnn import edge_features as _edge_features

__all__ = ["_edge_features", "_readout", "precompute_band", "apply_banded",
           "apply_banded_classes", "apply_banded_hbm_classes", "apply_banded_frames",
           "padding_rows", "apply_banded_attention", "apply_banded_attention_frames",
           "fragment_band_plan", "apply_banded_fragments", "apply_banded_trainable",
           "precompute_structure", "apply_blocksparse"]


def _readout(params, config: ModelConfig, atoms, nodes, dropout_mask=None) -> torch.Tensor:
    """The banded forwards' readout: the FC block AND the per-element head
    in the compute type (``nmrgnn_tpu/models/infer.py:148-170``), unlike
    the gather forward, whose head is float32; dropout where
    ``dropout_mask`` is given."""
    return readout(params, config, atoms, nodes, head_dtype=compute_dtype(config),
                   dropout_mask=dropout_mask)


def precompute_band(graph: Graph, block_rows: int = 128) -> BandPlan:
    """Host-side banding plan for an (RCM-ordered) frame; reusable across
    layers, forwards and frames with the same topology."""
    return band_plan(np.asarray(graph.nlist), np.asarray(graph.edges), block_rows=block_rows)


def _band(params, config: ModelConfig, nlist, edges, plan: BandPlan, use_kernels: bool,
          fused_edge: bool, cheb: EdgeCheb) -> torch.Tensor:
    """The band M [T, E, B, W] in the compute type (see apply_banded)."""
    cd = compute_dtype(config)
    if cheb is not None:
        build = build_band_poly if use_kernels else build_band_poly_plain
        return build(nlist, edges, cheb, plan, out_dtype=cd)
    if use_kernels and fused_edge:
        return build_band_fused(
            nlist, edges, params["edge_fc"], plan,
            rbf_low=config.rbf_low, rbf_high=config.rbf_high,
            activation_name=config.fc_activation, out_dtype=cd, compute_dtype=cd,
        )
    build = build_band if use_kernels else build_band_plain
    return build(nlist, _edge_features(params, config, edges), plan, out_dtype=cd)


def _occupancy(layers, nlist, edges, plan: BandPlan, use_kernels: bool):
    """The chunk occupancy of the plan's band, made once for the MP layers
    that read it (None without the kernels or without such a layer)."""
    if not (use_kernels and layers):
        return None
    return band_occupancy(nlist, edges, plan.lo, plan.window, plan.block_rows, plan.n_padded)


def _mp_layers(params, config: ModelConfig, M, plan: BandPlan, nodes, inv_p,
               use_kernels: bool, hbm_table: bool, occupancy) -> torch.Tensor:
    """One banded MP layer per ``params["mp"]`` entry over the padded node
    table ``nodes`` (in the compute type), each given the band's
    ``occupancy``."""
    if hbm_table:
        mp = mp_banded_hbm if use_kernels else mp_banded_hbm_plain
    else:
        mp = mp_banded if use_kernels else mp_banded_plain
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            nodes = mp(M, plan, nodes, p["w"], inv_p, config.mp_activation, occupancy)
    return nodes


def apply_banded(
    params,
    config: ModelConfig,
    graph: Graph,
    plan: BandPlan,
    use_kernels: bool = True,
    fused_edge: bool = True,
    cheb: EdgeCheb = None,
    hbm_table: bool = False,
    fused_first: bool = False,
) -> torch.Tensor:
    """Inference forward with banded MP; peaks f32[N] for the unpadded atoms.

    ``graph`` holds tensors on one device. With ``use_kernels`` (the
    default) the band build and MP layers go through the kernel wrappers
    of ``ops/banded.py`` (CUDA kernels on the card, their plain versions
    on the CPU); ``use_kernels=False`` runs the plain versions on any
    device (the exact edge stage then unfused). ``fused_edge=False``
    computes the edge features first and builds the band with
    ``build_band``. ``cheb`` (``ops.edgefn.EdgeCheb``) switches the edge
    stage to its Chebyshev compression, built by ``build_band_poly``.
    ``hbm_table`` runs the MP layers through ``mp_banded_hbm`` (the node
    table read from device memory tile by tile): the same numerics.

    ``fused_first`` runs the Chebyshev build and MP layer 1 as one kernel
    (``mp_banded_poly_fused``), then layers 2.. through ``mp_banded``: the
    serial path's function. It takes the JAX package's condition
    (``nmrgnn_tpu/models/infer.py:215-216``): kernels on, ``cheb`` given,
    ``hbm_table`` off and at least one MP layer; otherwise it is ignored.

    The band, the node table and the MP weights are in the compute type;
    so are the fused exact edge stage's EdgeFC products (float32 sums)."""
    atoms, nlist, edges, inv_degree = graph
    n = atoms.shape[0]
    cd = compute_dtype(config)
    plan = plan_on_device(plan, atoms.device)
    pad = plan.n_padded - n
    nodes = nnf.pad(dense(params["embed"], atoms).to(cd), (0, 0, 0, pad))
    inv_p = nnf.pad(inv_degree, (0, pad))
    if use_kernels and cheb is not None and not hbm_table and fused_first and params["mp"]:
        with span("nmrgnn.mp"):  # layer 1 with the band's build
            M, nodes = mp_banded_poly_fused(nlist, edges, cheb, plan, nodes,
                                            params["mp"][0]["w"], inv_p, config.mp_activation,
                                            out_dtype=cd)
        occ = _occupancy(params["mp"][1:], nlist, edges, plan, use_kernels)
        for p in params["mp"][1:]:
            with span("nmrgnn.mp"):
                nodes = mp_banded(M, plan, nodes, p["w"], inv_p, config.mp_activation, occ)
    else:
        M = _band(params, config, nlist, edges, plan, use_kernels, fused_edge, cheb)
        occ = _occupancy(params["mp"], nlist, edges, plan, use_kernels)
        nodes = _mp_layers(params, config, M, plan, nodes, inv_p, use_kernels, hbm_table, occ)
    return _readout(params, config, atoms, nodes[:n].float())


def _class_occupancy(params, nlist, edges, cls_plan: BandClassPlan, use_kernels: bool):
    """Each class band's chunk occupancy, made once for its MP layers."""
    if not (use_kernels and params["mp"]):
        return [None] * len(cls_plan.classes)
    return [band_occupancy(nlist, edges, c.lo, c.window, cls_plan.block_rows,
                           cls_plan.n_padded, ids=c.ids) for c in cls_plan.classes]


def apply_banded_classes(
    params,
    config: ModelConfig,
    graph: Graph,
    cls_plan: BandClassPlan,
    cheb: EdgeCheb,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Class-bucketed forward; peaks f32[N] for the unpadded atoms.

    Per class c it builds M_c [Tc, E, B, Wc] (the Chebyshev edge stage in
    the build, ``build_band_poly_cls``). Per MP layer it runs
    ``mp_banded_partial`` for each class against the node table cast to
    the compute type, puts each class's float32 rows back at its tiles
    (one ``index_copy_`` per class, over whole tiles), and applies
    act(acc * inv_degree) + nodes in float32, as the JAX package does
    outside its kernels. The node table itself stays float32 between
    layers. ``use_kernels=False`` runs the plain versions."""
    atoms, nlist, edges, inv_degree = graph
    n = atoms.shape[0]
    dev = atoms.device
    B, T = cls_plan.block_rows, cls_plan.num_tiles
    cd = compute_dtype(config)
    mp_act = get_activation(config.mp_activation)
    cls_plan = plan_on_device(cls_plan, dev)
    build = build_band_poly_cls if use_kernels else build_band_poly_cls_plain
    partial = mp_banded_partial if use_kernels else mp_banded_partial_plain
    Ms = [build(nlist, edges, cheb, c, B, cls_plan.n_padded, out_dtype=cd)
          for c in cls_plan.classes]
    tiles = [c.ids.long() for c in cls_plan.classes]
    occs = _class_occupancy(params, nlist, edges, cls_plan, use_kernels)

    pad = cls_plan.n_padded - n
    nodes = nnf.pad(dense(params["embed"], atoms), (0, 0, 0, pad))
    F = nodes.shape[-1]
    inv_col = nnf.pad(inv_degree, (0, pad))[:, None]
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            w = p["w"].to(cd)
            table = nodes.to(cd)
            acc = torch.empty((T, B, F), dtype=torch.float32, device=dev)
            for c, M, ids, occ in zip(cls_plan.classes, Ms, tiles, occs):
                out_c = partial(M, c.lo, table, w, occ)
                acc.index_copy_(0, ids, out_c.view(-1, B, F))  # the classes partition the tiles
            nodes = mp_act(acc.view(T * B, F) * inv_col) + nodes
    return _readout(params, config, atoms, nodes[:n])


def apply_banded_hbm_classes(
    params,
    config: ModelConfig,
    graph: Graph,
    cls_plan: BandClassPlan,
    cheb: EdgeCheb,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Class-bucketed forward with the node table in device memory (the
    JAX package's large-structure fast path); peaks f32[N] for the
    unpadded atoms.

    Per class c it builds M_c [Tc, E, B, Wc] (``build_band_poly_cls``).
    Per MP layer it runs ``mp_banded_hbm_cls`` for each class, every class
    reading the layer's input table, and puts each class's rows (in the
    compute type) into a new table by whole tiles. The table stays in the
    compute type between layers. ``use_kernels=False`` runs the plain
    versions."""
    atoms, nlist, edges, inv_degree = graph
    n = atoms.shape[0]
    dev = atoms.device
    B, T = cls_plan.block_rows, cls_plan.num_tiles
    cd = compute_dtype(config)
    cls_plan = plan_on_device(cls_plan, dev)
    build = build_band_poly_cls if use_kernels else build_band_poly_cls_plain
    mp = mp_banded_hbm_cls if use_kernels else mp_banded_hbm_cls_plain
    Ms = [build(nlist, edges, cheb, c, B, cls_plan.n_padded, out_dtype=cd)
          for c in cls_plan.classes]
    tiles = [c.ids.long() for c in cls_plan.classes]
    occs = _class_occupancy(params, nlist, edges, cls_plan, use_kernels)

    pad = cls_plan.n_padded - n
    nodes = nnf.pad(dense(params["embed"], atoms), (0, 0, 0, pad)).to(cd)
    F = nodes.shape[-1]
    inv_p = nnf.pad(inv_degree, (0, pad))
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            # a new table: writing into `nodes` would change the windows that
            # the layer's later classes read
            new_nodes = torch.empty_like(nodes)
            for c, M, ids, occ in zip(cls_plan.classes, Ms, tiles, occs):
                out_c = mp(M, c, B, nodes, p["w"], inv_p, config.mp_activation, occ)
                # the classes partition the tiles
                new_nodes.view(T, B, F).index_copy_(0, ids, out_c.view(-1, B, F))
            nodes = new_nodes
    return _readout(params, config, atoms, nodes[:n].float())


def _frames_end_to_end(nlist, edges, plan: BandPlan):
    """(nlist, edges, plan) of a stack of frames [Fr, N, K] laid end to
    end, each padded to ``plan.n_padded`` rows: frame f's indices and
    window starts move by f * n_padded, its padded rows hold index -1 (no
    row) and distance 0."""
    fr, n = nlist.shape[:2]
    npad = plan.n_padded
    offsets = torch.arange(fr, device=nlist.device, dtype=torch.int32)[:, None, None] * npad
    nlist_p = nnf.pad(nlist, (0, 0, 0, npad - n), value=-1)
    nlist_b = torch.where(nlist_p >= 0, nlist_p + offsets, nlist_p).reshape(fr * npad, -1)
    lo_b = plan_on_device(plan, nlist.device).lo[None, :] + offsets[:, 0]
    big_plan = plan._replace(lo=lo_b.reshape(-1).contiguous(), n_padded=fr * npad)
    edges_b = nnf.pad(edges, (0, 0, 0, npad - n)).reshape(fr * npad, -1)
    return nlist_b.contiguous(), edges_b, big_plan


def apply_banded_frames(
    params,
    config: ModelConfig,
    graphs: Graph,
    plan: BandPlan,
    cheb: EdgeCheb = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """``apply_banded`` over a stack of same-atom frames; peaks f32[Fr, N].

    ``graphs`` holds stacked tensors ([Fr, N, ...]) and ``plan`` covers
    every frame (``band_plan_frames``). The frames are laid end to end
    along the rows, each padded to ``plan.n_padded``: frame f's neighbor
    indices move by f * n_padded (its padded rows stay -1) and the plan's
    window starts are repeated with the same offsets, so one band build and
    one MP launch per layer serve the whole batch, and each frame's rows
    see only its own. A padding slot (index 0, distance 0) adds nothing
    wherever its index lands. Each frame's node table equals
    ``apply_banded``'s."""
    atoms, nlist, edges, inv_degree = graphs
    fr, n = atoms.shape[:2]
    npad = plan.n_padded
    pad = npad - n
    nlist_b, edges_b, big_plan = _frames_end_to_end(nlist, edges, plan)
    M = _band(params, config, nlist_b, edges_b, big_plan, use_kernels, True, cheb)
    F = params["embed"]["kernel"].shape[-1]
    nodes = nnf.pad(dense(params["embed"], atoms), (0, 0, 0, pad))
    nodes = _mp_layers(params, config, M, big_plan,
                       nodes.reshape(fr * npad, F).to(compute_dtype(config)),
                       nnf.pad(inv_degree, (0, pad)).reshape(-1), use_kernels, False,
                       _occupancy(params["mp"], nlist_b, edges_b, big_plan, use_kernels))
    nodes = nodes.view(fr, npad, F)[:, :n].reshape(fr * n, F).float()
    return _readout(params, config, atoms.reshape(fr * n, -1), nodes).view(fr, n)


def padding_rows(nlist, edges) -> np.ndarray:
    """int64[P]: the distinct rows, sorted, that the padding slots of a
    graph name (slots with distance <= 0 and an index >= 0; a negative
    index names no row). One row in practice: 0 as the graph is built, or
    where the RCM permutation sent row 0. Found on the host; tensors are
    copied there (one wait for the device)."""
    if isinstance(nlist, torch.Tensor):
        nlist, edges = nlist.cpu().numpy(), edges.cpu().numpy()
    nl = np.asarray(nlist)
    return np.unique(nl[(np.asarray(edges) <= 0) & (nl >= 0)]).astype(np.int64)


def _padding_slots(nlist, real, rows: torch.Tensor) -> torch.Tensor:
    """f32[N, K, P]: slot (i, j) -> 1 at the position of its row among
    ``rows`` (sorted) where it is a padding slot naming one of them, else 0."""
    P = rows.shape[0]
    pos = torch.searchsorted(rows, nlist.long()).clamp(max=P - 1)
    hit = ~real & (rows[pos] == nlist.long())
    return nnf.one_hot(pos, P).to(torch.float32) * hit[..., None].to(torch.float32)


def apply_banded_attention(
    params,
    config: ModelConfig,
    graph: Graph,
    plan: BandPlan,
    *,
    use_kernels: bool = True,
    differentiable: bool = False,
    training: bool = False,
    noise=None,
    dropout_mask=None,
    generator=None,
    cheb: EdgeCheb = None,
    pad_rows=None,
) -> torch.Tensor:
    """Attention-family (AMPLayer) forward on the band; peaks f32[N] for
    the unpadded atoms, the numerics of ``gnn.apply``.

    With softmax weights a[i, j] the layer is act(sum_j a[i, j] *
    nodes[nlist[i, j]] @ wv): a banded aggregation with one edge channel
    followed by a dense [F, F] product. Per MP layer: the weights in
    float32 (``attention_weights``); the real slots' weights built into an
    E=1 band (``build_band``, or ``build_band_df`` when ``differentiable``);
    ``mp_banded_partial`` (``mp_banded_partial_df``) with wv[:, :, None];
    then, for each row p that padding slots name (``pad_rows``, sorted;
    None: ``padding_rows`` of the graph, which waits for the device), the
    rank-1 term c_p[i] * (nodes[p] @ wv), c_p[i] the weight of row i's
    padding slots that name p; then the activation and the residual. The
    JAX package adds the padding mass at row 0 (``infer.py:515-526``), which
    equals this only where padding slots name row 0: after the RCM
    permutation they name the old row 0's new place.

    The band's occupancy is made once per forward from nlist and the
    distances before any noise (every layer's band has the same nonzero
    slots) and handed to every partial product. The band, the node table
    and wv go to the compute type; the query, keys, logits, softmax and the
    padding term stay float32. The edge stage is the exact one or, given
    ``cheb``, its Chebyshev evaluation (``eval_edge_chebyshev_device``);
    both plain PyTorch, since the keys need the [N, K, E] features.
    ``training=True`` adds the distance noise and the readout dropout
    (``noise`` [N, K], ``dropout_mask`` [N, F // 2], or drawn from
    ``generator``). ``use_kernels=False`` runs the plain versions (under
    autograd)."""
    atoms, nlist, edges, inv_degree = graph
    n = atoms.shape[0]
    dev = atoms.device
    cd = compute_dtype(config)
    mp_act = get_activation(config.mp_activation)
    plan = plan_on_device(plan, dev)
    if training:
        noise, dropout_mask = training_draws(
            config, edges, (n, config.atom_feature_size // 2), noise, dropout_mask, generator)
    else:
        noise = dropout_mask = None
    real = edges > 0  # the distances before the noise
    mask = real.to(torch.float32)[..., None]
    d = noised(config, edges, noise)
    if cheb is not None:
        e = eval_edge_chebyshev_device(cheb, d) * mask
    else:
        e = _edge_features(params, config, d, mask=mask)
    if use_kernels:
        build = build_band_df if differentiable else build_band
        partial = mp_banded_partial_df if differentiable else mp_banded_partial
    else:
        build, partial = build_band_plain, mp_banded_partial_plain
    occ = _occupancy(params["mp"], nlist, edges, plan, use_kernels)
    if pad_rows is None:
        pad_rows = padding_rows(nlist, edges)
    rows = torch.as_tensor(pad_rows, dtype=torch.int64).to(dev)
    slots = _padding_slots(nlist, real, rows) if rows.numel() else None
    pad = plan.n_padded - n
    nodes = nnf.pad(dense(params["embed"], atoms), (0, 0, 0, pad))
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            a = attention_weights(p["wq"], p["wk"], nodes[:n], e, inv_degree)  # [n, K]
            M = build(nlist, torch.where(real, a, 0.0)[..., None], plan, out_dtype=cd)
            upd = partial(M, plan.lo, nodes.to(cd), p["wv"][:, :, None], occ)[:n]
            if slots is not None:
                c = torch.einsum("ij,ijp->ip", a, slots)           # [n, P]
                upd = upd + c @ (nodes[rows] @ p["wv"])
            nodes = nodes + nnf.pad(mp_act(upd), (0, 0, 0, pad))
    return _readout(params, config, atoms, nodes[:n], dropout_mask)


def apply_banded_attention_frames(
    params,
    config: ModelConfig,
    graphs: Graph,
    plan: BandPlan,
    cheb: EdgeCheb = None,
    use_kernels: bool = True,
    pad_rows=None,
) -> torch.Tensor:
    """``apply_banded_attention`` over a stack of same-atom frames; peaks
    f32[Fr, N]. The frames are laid end to end, each padded to
    ``plan.n_padded`` rows (``plan`` covers every frame): frame f's indices
    and window starts move by f * n_padded and its padded rows hold index
    -1 (no row) and distance 0, so each kernel is launched once a layer for
    the whole batch. ``pad_rows``: per frame, the rows its padding slots
    name (None: found from the graphs, which waits for the device); frame
    f's move by f * n_padded too."""
    atoms, nlist, edges, inv_degree = graphs
    fr, n = atoms.shape[:2]
    npad = plan.n_padded
    flat = lambda a: nnf.pad(a, (0, 0) * (a.dim() - 2) + (0, npad - n)).reshape(  # noqa: E731
        (fr * npad,) + tuple(a.shape[2:]))
    if pad_rows is None:
        pad_rows = [padding_rows(nl, d) for nl, d in zip(nlist, edges)]
    rows = np.concatenate([np.asarray(r, np.int64) + f * npad for f, r in enumerate(pad_rows)])
    nlist_b, edges_b, big_plan = _frames_end_to_end(nlist, edges, plan)
    big = Graph(flat(atoms), nlist_b, edges_b, flat(inv_degree))
    peaks = apply_banded_attention(params, config, big, big_plan, use_kernels=use_kernels,
                                   cheb=cheb, pad_rows=np.unique(rows))
    return peaks.view(fr, npad)[:, :n]


def fragment_band_plan(batch_size: int, pad_to: int, block_rows: int = 128) -> BandPlan:
    """The static band plan of ``batch_size`` fragments padded to ``pad_to``
    atoms and laid end to end, fragment b's indices moved by b * pad_to:
    every tile of fragment b reads only rows [b * pad_to, (b + 1) *
    pad_to), so the window is the fragment and lo = b * pad_to for its
    tiles, whatever the topology."""
    if pad_to % block_rows:
        raise ValueError(f"pad_to={pad_to} must be a multiple of {block_rows}")
    lo = np.repeat(np.arange(batch_size, dtype=np.int64) * pad_to, pad_to // block_rows)
    return BandPlan(lo=lo.astype(np.int32), window=pad_to, block_rows=block_rows,
                    n_padded=batch_size * pad_to)


def _trainable_mp(params, config: ModelConfig, nlist, edges, e, plan: BandPlan, nodes, inv_p,
                  use_kernels: bool) -> torch.Tensor:
    """The band of the edge features ``e`` and the MP layers over the
    padded node table, differentiable: with ``use_kernels`` through
    ``build_band_df`` and ``mp_banded_df`` (all layers given the band's
    occupancy from ``edges``, the distances before any noise), else through
    the plain versions under autograd. All in float32."""
    if use_kernels:
        M = build_band_df(nlist, e, plan)
        occ = _occupancy(params["mp"], nlist, edges, plan, True)
        for p in params["mp"]:
            with span("nmrgnn.mp"):
                nodes = mp_banded_df(M, plan, nodes, p["w"], inv_p, config.mp_activation, occ)
        return nodes
    M = build_band_plain(nlist, e, plan)
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            nodes = mp_banded_plain(M, plan, nodes, p["w"], inv_p, config.mp_activation)
    return nodes


def apply_banded_fragments(
    params,
    config: ModelConfig,
    graph: Graph,
    *,
    training: bool = False,
    noise=None,
    dropout_mask=None,
    generator=None,
    plan: BandPlan = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Differentiable banded forward over a batch of padded fragments:
    Graph[B, N, ...] -> peaks f32[B, N]; the math of ``gnn.apply_batched``
    with the MP layers on the band of the flattened batch
    (``fragment_band_plan(B, N)`` unless ``plan`` is given).

    ``training=True`` adds the distance noise and the readout dropout; the
    draws are per fragment, ``noise`` [B, N, K] and ``dropout_mask``
    [B, N, F // 2], or drawn from ``generator``. The padding mask and the
    band's occupancy come from the distances before the noise. With
    ``use_kernels`` (the default) the band build and MP layers are
    ``build_band_df`` and ``mp_banded_df`` (the kernels on the card);
    ``use_kernels=False`` runs the plain versions under autograd."""
    atoms, nlist, edges, inv_degree = graph
    B, N, K = nlist.shape
    plan = fragment_band_plan(B, N) if plan is None else plan
    if plan.n_padded != B * N or plan.window != N:
        raise ValueError(f"plan {plan.n_padded} rows, window {plan.window} for {B} x {N}")
    plan = plan_on_device(plan, atoms.device)
    if training:
        noise, dropout_mask = training_draws(
            config, edges, (B, N, config.atom_feature_size // 2), noise, dropout_mask,
            generator)
    else:
        noise = dropout_mask = None
    flat_g = flatten_batch(graph)
    flat = lambda a: None if a is None else a.reshape((B * N,) + tuple(a.shape[2:]))  # noqa: E731
    mask = (flat_g.edges > 0).to(torch.float32)[..., None]
    e = _edge_features(params, config, noised(config, flat_g.edges, flat(noise)), mask=mask)
    nodes = _trainable_mp(params, config, flat_g.nlist, flat_g.edges, e, plan,
                          dense(params["embed"], flat_g.atoms), flat_g.inv_degree, use_kernels)
    return _readout(params, config, flat_g.atoms, nodes, flat(dropout_mask)).view(B, N)


def apply_banded_trainable(
    params,
    config: ModelConfig,
    graph: Graph,
    plan: BandPlan,
    *,
    training: bool = False,
    noise=None,
    dropout_mask=None,
    generator=None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Differentiable banded forward of one graph with its band plan;
    peaks f32[N] for the unpadded atoms. The numerics of ``gnn.apply``
    with the MP layers on the band (``build_band_df``, ``mp_banded_df``);
    ``training=True`` as ``apply_banded_fragments`` (``noise`` [N, K],
    ``dropout_mask`` [N, F // 2])."""
    atoms, nlist, edges, inv_degree = graph
    n = atoms.shape[0]
    plan = plan_on_device(plan, atoms.device)
    if training:
        noise, dropout_mask = training_draws(
            config, edges, (n, config.atom_feature_size // 2), noise, dropout_mask, generator)
    else:
        noise = dropout_mask = None
    mask = (edges > 0).to(torch.float32)[..., None]
    e = _edge_features(params, config, noised(config, edges, noise), mask=mask)
    pad = plan.n_padded - n
    nodes = nnf.pad(dense(params["embed"], atoms), (0, 0, 0, pad))
    nodes = _trainable_mp(params, config, nlist, edges, e, plan, nodes,
                          nnf.pad(inv_degree, (0, pad)), use_kernels)
    return _readout(params, config, atoms, nodes[:n], dropout_mask)


def precompute_structure(
    graph: Graph,
    block_size: int = 128,
    pair_rounding: int = 0,
    group: int = 1,
) -> BlockStructure:
    """Host-side sparsity pattern for a frame, reusable across layers and
    repeated forwards with the same neighbor lists."""
    return block_structure(np.asarray(graph.nlist), np.asarray(graph.edges), block_size,
                           pair_rounding=pair_rounding, group=group)


def apply_blocksparse(
    params,
    config: ModelConfig,
    graph: Graph,
    struct: BlockStructure,
    use_kernels: bool = True,
    group: int = 1,
) -> torch.Tensor:
    """Inference forward with block-sparse MP; peaks f32[N] for the
    unpadded atoms.

    The edge stage is the exact RBF + EdgeFC in float32 whatever the
    compute type (``nmrgnn_tpu/models/infer.py:80-86``). A, the node table
    and the MP weights are in the compute type, the table rounded to it
    after every layer; the readout (FC block and head) is float32
    (``:115-123``). With ``use_kernels`` the adjacency build and the MP
    layers go through ``build_block_adjacency`` and ``mp_blocksparse``
    (``group`` > 1: ``mp_blocksparse_grouped``, for a structure built
    with that ``group``), all layers given the block occupancy that
    ``block_occupancy`` makes once for this structure and frame;
    ``use_kernels=False`` runs their plain versions."""
    atoms, nlist, edges, inv_degree = graph
    n = atoms.shape[0]
    cd = compute_dtype(config)
    e = _edge_stage(edges, params["edge_fc"], rbf_low=config.rbf_low, rbf_high=config.rbf_high,
                    activation_name=config.fc_activation)
    struct = struct_on_device(struct, atoms.device)
    build = build_block_adjacency if use_kernels else build_block_adjacency_plain
    A = build(nlist, e, struct, out_dtype=cd)
    pad = struct.n_padded - n
    nodes = nnf.pad(dense(params["embed"], atoms), (0, 0, 0, pad)).to(cd)
    inv_p = nnf.pad(inv_degree, (0, pad))
    # the kernels' occupancy; on the CPU the plain layers read all of A
    occ = (block_occupancy(nlist, edges, struct)
           if use_kernels and nodes.is_cuda and params["mp"] else None)
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            if use_kernels:
                nodes = mp_blocksparse(A, struct, nodes, p["w"], inv_p, config.mp_activation,
                                       group=group, occupancy=occ)
            else:
                nodes = mp_blocksparse_plain(A, struct, nodes, p["w"], inv_p,
                                             config.mp_activation)
    return readout(params, config.replace(compute_dtype="float32"), atoms, nodes[:n].float())
