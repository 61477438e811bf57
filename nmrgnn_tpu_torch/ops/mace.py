"""The pieces of MACE, higher-order equivariant message passing (Batatia,
Kovács, Simm, Ortner and Csányi, NeurIPS 2022, arXiv:2206.07697; its
MACE-OFF23 sizes, arXiv:2312.15211; mace ``modules/blocks.py``:
``RealAgnosticInteractionBlock``, ``RealAgnosticResidualInteractionBlock``,
``EquivariantProductBasisBlock``; ``modules/symmetric_contraction.py``;
``modules/radial.py``: ``BesselBasis``, ``PolynomialCutoff``), in plain
PyTorch over the port's padded neighbor lists.

Features are irreps l = 0..3 of parity (-1)^l, each a block [2l + 1, F]
of F channels, the m index in the real basis of ``spherical_harmonics``
(Y_lm of a unit vector, normalized so that sum_m Y_lm^2 = 2l + 1, e3nn's
"component"). A slot (i, j) of the neighbor list carries d and r^ from
``painn.edge_geometry`` (a padding slot at d = r_c), Y(r^) [16] and the
edge basis, d in Angstrom as published (10 x the graph's nm):

    R0_n(d) = sqrt(2 / r_c) sin(n pi d / r_c) / d     n = 1..R
    u(x)    = 1 - 21 x^5 + 35 x^6 - 15 x^7            x = d / r_c < 1, else 0
    edge basis = R0 u                                  exactly 0 on padding

An interaction t (h its input, h^0 = onehot(z) @ W_emb, 0e only):

    h~ = Linear_up(h)                 each l: [F, F], no bias
    w  = MLP_t(R0 u)                  R -> 64 -> 64 -> 64 -> P_t F, no biases, act
                                      SiLU / sqrt(E[SiLU(z)^2]) (e3nn's normalize2mom)
    M_i,k,p,m3 = (1/n) sum_j w_ij,k,p sqrt(2 l3 + 1)
                 sum_m1m2 C^p[m1, m2, m3] Y_l1m1(r^_ij) h~_j,k,l2m2
                 for each path p = (l1 of Y, l2 of h~, l3), l3 <= 3, l1 + l2 + l3 even
    A  = Linear(M)                    each l3: [P_l3 F, F] over the paths ending in l3
    first layer: A = its element's [F, F] mix of each l of A; no skip
    later layers: sc = the element's [F, F] mix of h onto each output L
    B_i,k,LM = sum_nu sum_eta W^nu[z_i, eta, k] sum_a U^nu_L[M, a1..a_nu, eta]
               prod_xi A_i,k,a_xi      nu = 1..3, a over A's 16 components
    h  = Linear_prod(B) + sc          each L: [F, F]

The paths are taken in mace's order (h~'s l2, then Y's l1, then l3),
which orders MLP_t's P_t F outputs (path-major) and the rows of each
l3's Linear. n is ``avg_num_neighbors``, held with the weights. A layer
outputs L = 0..L_h (the hidden irreps, 128x0e + 128x1o at L_h = 1), the
last layer L = 0 alone, as mace keeps only scalars after it.

Normalizations are e3nn's defaults ("component" irreps, "element"
paths): a path of the convolution's "uvu" product has the constant
sqrt(2 l3 + 1) on a C of unit norm (one path into each output slot, one
input channel on the Y side); a Linear's 1/sqrt(fan_in) (F, or P_l3 F
after the convolution), the element mixes' 1/sqrt(F V) (e3nn's
FullyConnectedTensorProduct with the one-hot attributes) and the radial
MLP's 1/sqrt(fan_in) are folded into the weights as drawn (standard
normal times that scale; the contraction weights standard normal over the
number of paths eta). The SiLU scale is computed once, by quadrature.

Constants, each with one definition:
  * C^(l1 l2 l3) [2l1+1, 2l2+1, 2l3+1] is the unique intertwiner of the Y
    basis (sum C Y_l1 Y_l2 turns as Y_l3), of unit Frobenius norm, its
    first nonzero entry in index order positive;
  * U^nu_L [2L+1, 16^nu, eta] is the Gram-Schmidt orthonormalization, in
    the index order of the flattened (M, a1, ..., a_nu), of the columns of
    the orthogonal projector P onto the tensors [2L+1; 16^nu] that are
    symmetric in a1..a_nu and equivariant (rotations and parity; L of
    parity (-1)^L); a column whose residual norm is under 1e-8 is
    skipped. P e_j = Q Q[j]^T for any orthonormal basis Q of the space,
    so P is never formed.
Both are computed once in float64 (numpy) and cached. This U basis is
not mace's ``U_matrix_real`` basis; it spans the same space, so random
weights draw from the same model, but trained MACE-OFF weights would need
the change of basis.

The convolution runs over blocks of ``BLOCK_ROWS`` rows of the neighbor
list: the radial MLP, then for each l1 one batched product of Y_l1 over
the slots with the weighted neighbor rows (w_p h~_j of the paths with
that l1), then C on the sums (after the sum over the slots: C is
constant), so that the per-slot temporaries (w [P F], the gathered rows,
the weighted rows of one l1) stay near 3 GB at F = 128, K = 80. A padding
slot has an edge basis of exactly 0, so its w, and with it everything it
adds, is exactly 0 (the MLP has no biases and SiLU(0) = 0). The
symmetric contraction runs over the atoms grouped by element (the
one-hot's column; an atom with no element adds nothing), each element's
W U folded once a forward, as x (x) x then one product with the folded
order-3 and order-2 tensors, then the order-1 term and the last
contraction. The Dense products (the radial MLP, the linears, the mixes)
take their operands in ``compute_dtype`` with float32 sums; the rest is
float32. No TPU kernel: the JAX package has no such family.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from .edge import as_operand
from .painn import ANGSTROM_PER_NM, bessel_basis, edge_geometry

LMAX = 3             # spherical harmonics to l = 3 (all three MACE-OFF23 sizes)
CORRELATION = 3      # the symmetric contraction's order (``product`` is written for 3)
RADIAL_WIDTH = 64    # the radial MLP's hidden width
ENVELOPE_P = 5       # the polynomial envelope's p
SH_DIM = (LMAX + 1) ** 2
BLOCK_ROWS = 2048    # neighbor-list rows a convolution block takes (module docstring)
PRODUCT_ROWS = 8192  # atoms a symmetric-contraction block takes
GS_TOL = 1e-8        # Gram-Schmidt: a residual norm under this is skipped


def _offset(l: int) -> int:
    """The first of l's components in a [16] vector of l = 0..3."""
    return l * l


def spherical_harmonics(unit: torch.Tensor) -> torch.Tensor:
    """[..., 16]: the real Y_lm of ``unit`` [..., 3] for l = 0..3, in the
    order (l, m), each l normalized to sum_m Y_lm^2 = 2l + 1 on the unit
    sphere. l = 1 is sqrt(3) (y, z, x)."""
    x, y, z = unit.unbind(-1)
    x2, y2, z2 = x * x, y * y, z * z
    s3, s15, s5, s7, s105 = (math.sqrt(v) for v in (3, 15, 5, 7, 105))
    s35_8, s21_8 = math.sqrt(35 / 8), math.sqrt(21 / 8)
    return torch.stack([
        torch.ones_like(x),
        s3 * y, s3 * z, s3 * x,
        s15 * x * y, s15 * y * z, 0.5 * s5 * (3 * z2 - 1), s15 * x * z, 0.5 * s15 * (x2 - y2),
        s35_8 * y * (3 * x2 - y2), s105 * x * y * z, s21_8 * y * (5 * z2 - 1),
        0.5 * s7 * z * (5 * z2 - 3), s21_8 * x * (5 * z2 - 1), 0.5 * s105 * z * (x2 - y2),
        s35_8 * x * (x2 - 3 * y2),
    ], -1)


@functools.lru_cache(maxsize=None)
def _frame():
    """(unit sample points [64, 3], 3 rotations [3, 3, 3]), float64, fixed."""
    rng = np.random.default_rng(20220707)
    pts = rng.normal(size=(64, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    rots = []
    for _ in range(3):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        rots.append(q if np.linalg.det(q) > 0 else -q)
    return pts, np.stack(rots)


def _sh64(points: np.ndarray) -> np.ndarray:
    return spherical_harmonics(torch.from_numpy(points)).numpy()


def wigner_d(l: int, rotation: np.ndarray) -> np.ndarray:
    """float64 [2l+1, 2l+1]: D_l(R) with Y_l(R r) = D_l(R) Y_l(r), from the
    Y table (least squares over fixed points of the sphere)."""
    pts = _frame()[0]
    sl = slice(_offset(l), _offset(l + 1))
    y0 = _sh64(pts)[:, sl]
    y1 = _sh64(pts @ rotation.T)[:, sl]
    return np.linalg.lstsq(y0, y1, rcond=None)[0].T


def _null_space(blocks) -> np.ndarray:
    """An orthonormal basis [n, d] of the vectors every matrix of ``blocks``
    [rows, n] sends to 0 (eigenvectors of the summed Gram matrix)."""
    gram = sum(b.T @ b for b in blocks)
    vals, vecs = np.linalg.eigh(gram)
    return vecs[:, vals < 1e-9 * max(vals.max(), 1.0)]


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """float64 [2l1+1, 2l2+1, 2l3+1]: the module docstring's C."""
    dims = (2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1)
    blocks = []
    for rot in _frame()[1]:
        d1, d2, d3 = (wigner_d(l, rot) for l in (l1, l2, l3))
        blocks.append(np.kron(np.kron(d1.T, d2.T), np.eye(dims[2]))
                      - np.kron(np.eye(dims[0] * dims[1]), d3))
    null = _null_space(blocks)
    if null.shape[1] != 1:
        raise ValueError(f"({l1}, {l2}, {l3}) has {null.shape[1]} intertwiners, not 1")
    c = null[:, 0]
    c = c / np.linalg.norm(c)
    first = c[np.abs(c) > 1e-9][0]
    return (c * np.sign(first)).reshape(dims)


def _rep_a(rotation: np.ndarray) -> np.ndarray:
    """float64 [16, 16]: the block-diagonal D of A's components l = 0..3."""
    out = np.zeros((SH_DIM, SH_DIM))
    for l in range(LMAX + 1):
        sl = slice(_offset(l), _offset(l + 1))
        out[sl, sl] = wigner_d(l, rotation)
    return out


def _symmetric_basis(nu: int, parity: int):
    """[16^nu, s] orthonormal columns spanning the tensors symmetric in
    their nu indices whose parity, (-1)^(l1 + ... + l_nu), is ``parity``."""
    ls = np.repeat(np.arange(LMAX + 1), 2 * np.arange(LMAX + 1) + 1)
    cols = []
    for combo in itertools.combinations_with_replacement(range(SH_DIM), nu):
        if (-1) ** int(ls[list(combo)].sum()) != parity:
            continue
        col = np.zeros((SH_DIM,) * nu)
        for perm in set(itertools.permutations(combo)):
            col[perm] = 1.0
        cols.append(col.reshape(-1) / np.linalg.norm(col))
    return np.stack(cols, 1)


def _gram_schmidt_rows(q: np.ndarray) -> np.ndarray:
    """[d, d]: G such that Q G is the Gram-Schmidt orthonormalization, in
    index order, of the columns P e_j = Q q[j] of the projector Q Q^T,
    residuals under ``GS_TOL`` skipped (Q orthonormal, so norms are those
    of the rows' residuals in R^d)."""
    d = q.shape[1]
    basis = np.zeros((d, 0))
    for row in q:
        if basis.shape[1] == d:
            break
        r = row - basis @ (basis.T @ row)
        r = r - basis @ (basis.T @ r)  # twice: orthogonal to float64 rounding
        norm = np.linalg.norm(r)
        if norm >= GS_TOL:
            basis = np.concatenate([basis, (r / norm)[:, None]], 1)
    return basis


@functools.lru_cache(maxsize=None)
def coupling_basis(nu: int, L: int) -> np.ndarray:
    """float64 [2L+1, 16, ..., 16 (nu), eta]: the module docstring's U^nu_L."""
    sym = _symmetric_basis(nu, (-1) ** L)
    m = 2 * L + 1
    blocks = []
    for rot in _frame()[1]:
        t = sym.reshape((SH_DIM,) * nu + (-1,))
        rep = _rep_a(rot)
        for axis in range(nu):  # D^{(x) nu} applied to every symmetric column
            t = np.moveaxis(np.tensordot(rep, t, axes=([1], [axis])), 0, axis)
        rho = sym.T @ t.reshape(SH_DIM ** nu, -1)
        blocks.append(np.kron(np.eye(m), rho.T) - np.kron(wigner_d(L, rot), np.eye(sym.shape[1])))
    null = _null_space(blocks)
    q = np.einsum("msd,as->mad", null.reshape(m, sym.shape[1], -1), sym)
    q = q.reshape(m * SH_DIM ** nu, -1)
    u = q @ _gram_schmidt_rows(q)
    return u.reshape((m,) + (SH_DIM,) * nu + (-1,))


@functools.lru_cache(maxsize=None)
def silu_scale() -> float:
    """1 / sqrt(E[SiLU(z)^2]) for standard-normal z (Gauss-Hermite, 200
    nodes): e3nn's ``normalize2mom`` of SiLU."""
    x, w = np.polynomial.hermite_e.hermegauss(200)
    s = x / (1.0 + np.exp(-x))
    return float(1.0 / np.sqrt((w * s * s).sum() / np.sqrt(2.0 * np.pi)))


class Path(NamedTuple):
    l1: int  # Y's
    l2: int  # h~'s
    l3: int  # the output's


def conv_paths(ls_in) -> list:
    """The convolution's paths for h~ of irreps ``ls_in``, in mace's order."""
    return [Path(l1, l2, l3) for l2 in ls_in for l1 in range(LMAX + 1)
            for l3 in range(abs(l1 - l2), min(l1 + l2, LMAX) + 1) if (l1 + l2 + l3) % 2 == 0]


class ConvPlan(NamedTuple):
    """A convolution's fixed layout: ``paths``; ``groups`` [(l1, [(path
    index, l2, row offset in the group's weighted rows)], rows)]; ``cg``
    float64 [40 or 16, Q]: sqrt(2l3+1) C from the groups' sums (rows (l1,
    m1, path, m2)) to M (rows (l3, m3, path of l3)); ``outputs`` [(l3, row
    offset in M, paths into l3)]."""

    paths: list
    groups: list
    cg: np.ndarray
    outputs: list


@functools.lru_cache(maxsize=None)
def conv_plan(ls_in: tuple) -> ConvPlan:
    """The ``ConvPlan`` of h~'s irreps ``ls_in``."""
    paths = conv_paths(ls_in)
    groups, sums = [], {}
    q = 0
    for l1 in range(LMAX + 1):
        members, rows = [], 0
        for i, p in enumerate(paths):
            if p.l1 == l1:
                members.append((i, p.l2, rows))
                rows += 2 * p.l2 + 1
        if members:
            groups.append((l1, members, rows))
            for i, l2, off in members:
                sums[i] = (q, rows, off)  # group start, group width, path offset
            q += (2 * l1 + 1) * rows
    outputs, into, m = [], {}, 0
    for l3 in range(LMAX + 1):
        ps = [i for i, p in enumerate(paths) if p.l3 == l3]
        if ps:
            outputs.append((l3, m, len(ps)))
            into.update({i: (m, len(ps), k) for k, i in enumerate(ps)})
            m += (2 * l3 + 1) * len(ps)
    cg = np.zeros((m, q))
    for i, p in enumerate(paths):
        c = clebsch_gordan(*p) * math.sqrt(2 * p.l3 + 1)
        start, width, off = sums[i]
        m0, n_paths, k = into[i]
        for m1, m2, m3 in itertools.product(*(range(2 * l + 1) for l in p)):
            cg[m0 + m3 * n_paths + k, start + m1 * width + off + m2] = c[m1, m2, m3]
    return ConvPlan(paths, groups, cg, outputs)


_ON_DEVICE: dict = {}


def _tensor(key, make, device) -> torch.Tensor:
    """A float32 constant on ``device``, made once a process."""
    k = (key, str(device))
    if k not in _ON_DEVICE:
        _ON_DEVICE[k] = torch.as_tensor(make(), dtype=torch.float32).to(device)
    return _ON_DEVICE[k]


class Geometry(NamedTuple):
    """A forward's slots, computed once and read by every layer: ``nlist``
    int64 [N, K], ``sh`` Y(r^) [N, K, 16], ``basis`` R0 u [N, K, R]
    (exactly 0 on padding and at or past the cutoff)."""

    nlist: torch.Tensor
    sh: torch.Tensor
    basis: torch.Tensor


def envelope(x: torch.Tensor) -> torch.Tensor:
    """mace's polynomial cutoff at p = 5, exactly 0 from x = 1 on."""
    p = ENVELOPE_P
    u = (1.0 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1)
         - p * (p + 1) / 2 * x ** (p + 2))
    return torch.where(x < 1.0, u, torch.zeros_like(u))


def geometry(positions: torch.Tensor, nlist: torch.Tensor, edges: torch.Tensor, count: int,
             cutoff: float) -> Geometry:
    """The ``Geometry`` of a graph and its atoms' ``positions`` f32[N, 3]
    nm, ``count`` Bessel functions and the cutoff (nm)."""
    d, unit = edge_geometry(positions, nlist, edges, cutoff)
    scale = math.sqrt(2.0 / (ANGSTROM_PER_NM * cutoff))
    basis = bessel_basis(d, count, cutoff) * (scale * envelope(d / cutoff))[..., None]
    return Geometry(nlist.long(), spherical_harmonics(unit), basis)


class ElementGroups(NamedTuple):
    """The atoms ordered by element: ``order`` int64 [N] (stable), its
    ``inverse``, and ``spans`` [(element, start, end)] of the elements
    present, on the host (one read-back a forward)."""

    order: torch.Tensor
    inverse: torch.Tensor
    spans: list


def element_groups(atoms: torch.Tensor) -> ElementGroups:
    """``ElementGroups`` of the one-hot rows ``atoms`` [N, V]; a row of
    zeros is an atom of no element, ordered last and in no span."""
    v = atoms.shape[1]
    z = torch.where(atoms.amax(1) > 0, atoms.argmax(1), v)
    order = torch.argsort(z, stable=True)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    counts = torch.bincount(z, minlength=v + 1).tolist()
    spans, start = [], 0
    for e in range(v):
        if counts[e]:
            spans.append((e, start, start + counts[e]))
        start += counts[e]
    return ElementGroups(order, inverse, spans)


def _mm(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    return as_operand(x, compute_dtype) @ as_operand(w, compute_dtype)


def linear(kernels: list, h: list, compute_dtype=torch.float32) -> list:
    """Each l's [N, 2l+1, F] times its [F, F'] kernel (``kernels[l]``)."""
    return [_mm(x, k["kernel"], compute_dtype) for x, k in zip(h, kernels)]


def radial_weights(p: list, basis: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """[S, P F]: the radial MLP (``p`` its kernels, e3nn's scales folded
    in) of ``basis`` [S, R], SiLU scaled by ``silu_scale`` (folded into the
    next kernel)."""
    c = silu_scale()
    x = basis
    for i, layer in enumerate(p):
        kernel = layer["kernel"] if i == 0 else layer["kernel"] * c
        x = _mm(x, kernel, compute_dtype)
        if i < len(p) - 1:
            x = torch.nn.functional.silu(x, inplace=True)
    return x


def conv(p: dict, ht: list, geo: Geometry, avg_num_neighbors: torch.Tensor,
         compute_dtype=torch.float32, block: int = BLOCK_ROWS) -> torch.Tensor:
    """A [N, 16, F]: the convolution of ``ht`` (h~, [N, 2l+1, F] each l) over
    ``geo``'s slots, summed, then each l3's Linear over its paths, over
    ``avg_num_neighbors``."""
    plan = conv_plan(tuple(range(len(ht))))
    n, K = geo.nlist.shape
    F = ht[0].shape[-1]
    P = len(plan.paths)
    dev = ht[0].device
    cg = _tensor(("cg", tuple(range(len(ht)))), lambda: plan.cg, dev)
    M = torch.empty((n, cg.shape[0], F), dtype=torch.float32, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        rows = r1 - r0
        nl = geo.nlist[r0:r1].reshape(-1)
        w = radial_weights(p["radial"], geo.basis[r0:r1].reshape(rows * K, -1),
                           compute_dtype).view(rows, K, P, F)
        hj = [x.index_select(0, nl).view(rows, K, x.shape[1], F) for x in ht]
        sums = []
        for l1, members, width in plan.groups:
            t = torch.empty((rows, K, width, F), dtype=torch.float32, device=dev)
            for i, l2, off in members:
                b = 2 * l2 + 1
                torch.mul(hj[l2], w[:, :, i, None, :], out=t[:, :, off:off + b])
            y = geo.sh[r0:r1, :, _offset(l1):_offset(l1 + 1)].transpose(1, 2)
            sums.append(torch.bmm(y, t.view(rows, K, width * F)).view(rows, -1, F))
            del t
        M[r0:r1] = torch.matmul(cg, torch.cat(sums, 1))
    out = []
    for (l3, m0, n_paths), layer in zip(plan.outputs, p["linear"]):
        m = M[:, m0:m0 + (2 * l3 + 1) * n_paths].reshape(n, 2 * l3 + 1, n_paths * F)
        out.append(_mm(m, layer["kernel"] / avg_num_neighbors, compute_dtype))
    return torch.cat(out, 1)


def element_mix(kernels: list, x: torch.Tensor, spans: list, ls,
                compute_dtype=torch.float32) -> torch.Tensor:
    """[N, sum_l (2l+1), F']: each l of ``ls`` (rows of ``x`` [N, ., F] in
    the order of ``ls``, atoms grouped by element) times its element's
    [F, F'] (``kernels[i]["kernel"]`` [V, F, F']); an atom of no element
    gets 0."""
    n = x.shape[0]
    out = x.new_zeros((n, x.shape[1], kernels[0]["kernel"].shape[-1]))
    row = 0
    for l, k in zip(ls, kernels):
        d = 2 * l + 1
        for e, s0, s1 in spans:
            out[s0:s1, row:row + d] = _mm(x[s0:s1, row:row + d], k["kernel"][e], compute_dtype)
        row += d
    return out


def _folded(p: list, Ls) -> tuple:
    """(Kq [V, F, 272, C], K1 [V, F, C]) for the outputs ``Ls``: each
    element's weights W^nu [V, eta, F] folded into U^nu_L once, columns
    C = (L, M, a1), Kq's rows x (x) x's (a2, a3) then x's a2."""
    dev = p[0]["w1"].device
    kq, k1 = [], []
    for L, w in zip(Ls, p):
        m = 2 * L + 1
        u = [_tensor(("U", nu, L), functools.partial(coupling_basis, nu, L), dev)
             for nu in (1, 2, 3)]
        u3 = u[2].reshape(m * SH_DIM, SH_DIM * SH_DIM, -1)
        u2 = u[1].reshape(m * SH_DIM, SH_DIM, -1)
        kq.append(torch.cat([torch.einsum("cqe,zef->zfqc", u3, w["w3"]),
                             torch.einsum("cqe,zef->zfqc", u2, w["w2"])], 2))
        k1.append(torch.einsum("ce,zef->zfc", u[0].reshape(m * SH_DIM, -1), w["w1"]))
    return torch.cat(kq, 3), torch.cat(k1, 2)


def product(p: list, A: torch.Tensor, spans: list, Ls, block: int = PRODUCT_ROWS) -> torch.Tensor:
    """B [N, sum_L (2L+1), F]: the symmetric contraction of ``A`` [N, 16, F]
    (atoms grouped by element) onto the outputs ``Ls`` (``p[i]`` L's
    weights {"w1", "w2", "w3"} [V, eta, F])."""
    kq, k1 = _folded(p, Ls)
    n, _, F = A.shape
    cols = k1.shape[-1] // SH_DIM
    x_all = A.permute(2, 0, 1).contiguous()  # [F, N, 16]
    out = A.new_zeros((F, n, cols))
    q = SH_DIM * SH_DIM
    for e, s0, s1 in spans:
        for r0 in range(s0, s1, block):
            r1 = min(r0 + block, s1)
            x = x_all[:, r0:r1]
            xq = torch.empty((F, r1 - r0, q + SH_DIM), dtype=A.dtype, device=A.device)
            torch.mul(x[..., :, None], x[..., None, :],
                      out=xq[..., :q].view(F, r1 - r0, SH_DIM, SH_DIM))
            xq[..., q:] = x
            c = torch.bmm(xq, kq[e]).add_(k1[e][:, None, :])
            out[:, r0:r1] = (c.view(F, r1 - r0, cols, SH_DIM) * x[:, :, None, :]).sum(-1)
    return out.permute(1, 2, 0)
