"""The attention MP layer (AMPLayer) of the gather forward, with its
residual, as one hand-written CUDA kernel a layer (``csrc/attention.cu``):

    out = act(sum_j a[i, j] * (nodes @ wv)[nlist[i, j]]) + nodes
    a   = softmax over all K slots of inv_degree[i] * <edges[i, j] @ wk, nodes[i] @ wq>

Padding slots are included, as the reference has it (``message_passing``'s
module docstring). On the card the projection ``P = nodes @ wv`` is one
float32 product (TF32 as the caller sets it) and the kernel computes the
query, the logits, the softmax and the weighted sum of P's rows by index in
registers, writing only [N, F]: no [N, K, F] tensor. An F that is not a
multiple of 32 runs on zero-padded columns. The plain version, for a CPU
tensor, is ``amp_layer`` plus the residual.

No TPU kernel: the JAX package's gather AMPLayer is plain jnp. The kernel
has no gradient, so a call on the card while autograd records (grad mode
on and an operand that requires grad) takes ``amp_plain``, uncounted.
"""
from __future__ import annotations

import torch

from ._cuda import check, kernel, launch
from .activations import activation_code, get_activation
from .message_passing import amp_layer

MAX_E = 1024  # edge features the kernel takes (its query in shared memory)


def amp_plain(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, nodes: torch.Tensor,
              nlist: torch.Tensor, edges: torch.Tensor, inv_degree: torch.Tensor,
              activation: str = "softplus") -> torch.Tensor:
    """``amp_layer`` with the activation named ``activation``, plus the
    residual ``nodes``: the plain version of ``amp``."""
    return amp_layer(wq, wk, wv, nodes, nlist, edges, inv_degree,
                     get_activation(activation)) + nodes


def kernel_args(wq, wk, values, nodes, nlist, edges, inv_degree):
    """The operands of a launch of ``amp``'s kernel, checked, in its order:
    nodes and values [N, F] and wq [F, E] with F padded to a multiple of 32,
    wk [E, E], int32 nlist [N, K], edges [N, K, E], inv_degree [N], all
    contiguous float32 on ``nodes``' device. Raises on what the kernel
    does not take."""
    if nodes.dim() != 2 or nlist.dim() != 2 or wk.dim() != 2:
        raise ValueError(f"amp kernel: nodes {tuple(nodes.shape)}, nlist {tuple(nlist.shape)} "
                         f"and wk {tuple(wk.shape)} must be 2-D")
    (n, F), K, E = nodes.shape, nlist.shape[1], wk.shape[0]
    if not 1 <= E <= MAX_E:
        raise ValueError(f"amp kernel: E = {E}; it takes 1 to {MAX_E} edge features")
    Fp = -(-F // 32) * 32
    dev = nodes.device
    if Fp != F:  # zero columns of nodes and values, zero rows of wq
        nodes, values = (torch.nn.functional.pad(t, (0, Fp - F)) for t in (nodes, values))
        wq = torch.nn.functional.pad(wq, (0, 0, 0, Fp - F))
    ops = {"nodes": nodes.contiguous(), "values": values.contiguous(), "wq": wq.contiguous(),
           "wk": wk.contiguous(), "nlist": nlist.to(torch.int32).contiguous(),
           "edges": edges.contiguous(), "inv_degree": inv_degree.contiguous()}
    shapes = {"nodes": (n, Fp), "values": (n, Fp), "wq": (Fp, E), "wk": (E, E),
              "nlist": (n, K), "edges": (n, K, E), "inv_degree": (n,)}
    for name, t in ops.items():
        want = torch.int32 if name == "nlist" else torch.float32
        if name in ("nodes", "values"):  # read in 16-byte vectors
            check(name, t, want, shapes[name], dev)
        elif t.device != dev or t.dtype != want or tuple(t.shape) != shapes[name]:
            raise ValueError(f"amp kernel: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                             f"it takes {want} {shapes[name]} on {dev}")
    return ops, (n, K, Fp, E)


def _recording(wq, wk, wv, nodes, nlist, edges, inv_degree, activation="softplus"):
    """``amp_plain`` for a call on the card while autograd records: grad
    mode on and an operand that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (wq, wk, wv, nodes, edges)):
        return amp_plain
    return None


@kernel(amp_plain, on="nodes", route=_recording)
def amp(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, nodes: torch.Tensor,
        nlist: torch.Tensor, edges: torch.Tensor, inv_degree: torch.Tensor,
        activation: str = "softplus") -> torch.Tensor:
    """nodes f32[N, F] after an attention MP layer and its residual: ``wq``
    [F, E], ``wk`` [E, E], ``wv`` [F, F], ``nlist`` [N, K], ``edges`` the
    EdgeFC output [N, K, E], ``inv_degree`` [N], ``activation`` a name that
    ``activation_code`` takes (others raise on the card). On the card one
    product and one launch of ``csrc/attention.cu``, counted in
    ``.launches``, or ``amp_plain`` while autograd records; on the CPU
    ``amp_plain``."""
    act = activation_code(activation)
    F = nodes.shape[-1]
    ops, (n, K, Fp, E) = kernel_args(wq, wk, nodes @ wv, nodes, nlist, edges, inv_degree)
    out = torch.empty((n, Fp), dtype=torch.float32, device=nodes.device)
    launch("nmr_amp_layer", nodes.device, *(t.data_ptr() for t in ops.values()), out.data_ptr(),
           n, K, Fp, E, act)
    return out if Fp == F else out[:, :F]
