"""Plain PyTorch reference of MACE (Batatia et al., NeurIPS 2022,
arXiv:2206.07697) at MACE-OFF23's sizes (Kovács et al., arXiv:2312.15211),
for the ``mace-off23-medium`` configuration, in float32 (TF32 off),
written from the papers' equations and mace ``modules/blocks.py``
(``RealAgnosticInteractionBlock``, ``RealAgnosticResidualInteractionBlock``,
``EquivariantProductBasisBlock``), ``modules/symmetric_contraction.py``
and ``modules/radial.py``:

    d in Angstrom (10 x the graph's nm; r_ij = x_j - x_i taken in float64,
    so exact at the structure's 10 nm offsets, then rounded to float32),
    r_c the cutoff, Y_lm(r^) l = 0..3 with sum_m Y_lm^2 = 2l + 1 (the
    table below)
    e_ij  = sqrt(2 / r_c) sin(n pi d / r_c) / d * u(d / r_c),  n = 1..R
            u(x) = 1 - 21 x^5 + 35 x^6 - 15 x^7 below 1, else 0
    h     = one_hot @ W_emb                                  (0e)
    each interaction t:
      h~  = h_l @ W_up,l                                     each l
      w   = MLP(e_ij): R -> 64 -> 64 -> 64 -> P F, no biases, SiLU / sqrt(E[SiLU(z)^2])
      m_ij,p = w_ij,p sqrt(2 l3 + 1) sum C^p[m1, m2, m3] Y_l1m1(r^_ij) h~_j,l2m2
      M   = sum_j m_ij / avg_num_neighbors;  A_l3 = M_l3 @ W_lin,l3 (its paths' rows)
      t = 1: A_l = A_l @ W_skip,l[z_i];  later: sc_L = h_L @ W_skip,L[z_i]
      B_L = sum_nu sum_eta W^nu_L[z_i, eta] (U^nu_L[..., eta] contracted with A nu times)
      h_L = B_L @ W_out,L (+ sc_L);  the last interaction keeps L = 0 alone
    peaks = nmrgnn's readout of the last h's scalars (``model.py``'s FC block and head)

Constants, with the program's definitions (built here by this file's own
code, in float64): C^(l1 l2 l3) is the unique intertwiner of the Y basis,
of unit norm, its first nonzero entry (index order) positive; U^nu_L the
Gram-Schmidt orthonormalization, in the flattened (M, a1..a_nu) index
order, of the columns of the orthogonal projector onto the tensors
[2L+1; 16^nu] symmetric in the a's and equivariant under rotations and
parity, residual norms under 1e-8 skipped; the SiLU scale by quadrature.
The paths come in mace's order (h~'s l2, then l1, then l3).

Departures from mace: nmrgnn's per-element head on the last layer's 128
scalars (Dense(F, F/2, SiLU), Dense(F/2, V), the atom's own element's
output times its peak std plus its mean) in place of mace's linear and
non-linear readouts and the energy sum; one-hot rows over nmrgnn's V = 10
element vocabulary; a padded list of K = 80 slots an atom in place of a
radius graph (above every atom's count within r_c in the cell, so the cap
drops nothing: a slot of graph distance 0 is padding and a slot at or past
r_c no edge, and neither adds anything); the U basis above, not mace's
``U_matrix_real`` (the same space); the SiLU scale from quadrature in
place of e3nn's sampled estimate; ``avg_num_neighbors`` is the weights'.

Every dense product and every contraction goes through ``model.Products``:
float32, or for the control that decides ``correct`` its operands rounded
to TF32 first. The per-edge terms run in blocks of ``block`` atoms, the
contraction in blocks of ``block`` atoms of one element, so that the
reference fits at the cell's size.
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from .model import Products

LMAX = 3


def sh_table(r: torch.Tensor) -> torch.Tensor:
    """[..., 16] real spherical harmonics of unit vectors ``r`` [..., 3], l
    = 0..3 in (l, m) order, sum_m Y_lm^2 = 2l + 1."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    cols = [torch.ones_like(x)]
    cols += [math.sqrt(3.0) * c for c in (y, z, x)]
    a = math.sqrt(15.0)
    cols += [a * x * y, a * y * z, math.sqrt(5.0) / 2 * (3 * z * z - 1), a * x * z,
             a / 2 * (x * x - y * y)]
    b, c, e = math.sqrt(35.0 / 8), math.sqrt(105.0), math.sqrt(21.0 / 8)
    cols += [b * y * (3 * x * x - y * y), c * x * y * z, e * y * (5 * z * z - 1),
             math.sqrt(7.0) / 2 * z * (5 * z * z - 3), e * x * (5 * z * z - 1),
             c / 2 * z * (x * x - y * y), b * x * (x * x - 3 * y * y)]
    return torch.stack(cols, -1)


def _rotations(count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        a = rng.normal(size=(3, 3))
        q = np.linalg.qr(a)[0]
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        out.append(q)
    return out


def _d_matrix(l: int, rot: np.ndarray) -> np.ndarray:
    """D_l(rot) with Y_l(rot r) = D_l Y_l(r), fitted on 100 points."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(100, 3))
    pts = pts / np.sqrt((pts ** 2).sum(1))[:, None]
    sl = slice(l * l, (l + 1) * (l + 1))
    before = sh_table(torch.tensor(pts)).numpy()[:, sl]
    after = sh_table(torch.tensor(pts @ rot.T)).numpy()[:, sl]
    sol, *_ = np.linalg.lstsq(before, after, rcond=None)
    return sol.T


def _kernel(rows) -> np.ndarray:
    """Orthonormal basis of the common null space of the stacked ``rows``
    (right singular vectors of singular value ~0)."""
    a = np.concatenate(rows, 0)  # more rows than columns
    _, s, vt = np.linalg.svd(a, full_matrices=False)
    return vt[s < 1e-7 * max(s.max(), 1.0)].T


@functools.lru_cache(maxsize=None)
def cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """C^(l1 l2 l3) [2l1+1, 2l2+1, 2l3+1], float64."""
    n1, n2, n3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rows = []
    for rot in _rotations(4, 11):
        d1, d2, d3 = (_d_matrix(l, rot) for l in (l1, l2, l3))
        # sum_{m1 m2} C[m1 m2 m3] d1[m1 a] d2[m2 b] = sum_m3' d3[m3 m3'] C[a b m3']
        lhs = np.einsum("ia,jb,kc->abkijc", d1, d2, np.eye(n3)).reshape(n1 * n2 * n3, -1)
        rhs = np.einsum("ai,bj,kc->abkijc", np.eye(n1), np.eye(n2), d3).reshape(n1 * n2 * n3, -1)
        rows.append(lhs - rhs)
    null = _kernel(rows)
    assert null.shape[1] == 1, (l1, l2, l3, null.shape)
    v = null[:, 0] / np.linalg.norm(null[:, 0])
    nz = np.flatnonzero(np.abs(v) > 1e-9)[0]
    return (v if v[nz] > 0 else -v).reshape(n1, n2, n3)


@functools.lru_cache(maxsize=None)
def u_basis(nu: int, L: int) -> np.ndarray:
    """U^nu_L [2L+1, 16, ..., 16, eta], float64."""
    comp_l = [l for l in range(LMAX + 1) for _ in range(2 * l + 1)]
    # symmetric coordinates: one orthonormal column per multiset of
    # indices of the right parity
    multisets = [c for c in itertools.combinations_with_replacement(range(16), nu)
                 if sum(comp_l[i] for i in c) % 2 == L % 2]
    sym = np.zeros((16 ** nu, len(multisets)))
    for k, c in enumerate(multisets):
        idx = {np.ravel_multi_index(p, (16,) * nu) for p in itertools.permutations(c)}
        sym[list(idx), k] = 1.0 / math.sqrt(len(idx))
    m = 2 * L + 1
    rows = []
    for rot in _rotations(3, 5):
        big = np.zeros((16, 16))
        for l in range(LMAX + 1):
            big[l * l:(l + 1) ** 2, l * l:(l + 1) ** 2] = _d_matrix(l, rot)
        moved = sym.reshape((16,) * nu + (-1,))
        for ax in range(nu):
            moved = np.moveaxis(np.tensordot(big, moved, axes=([1], [ax])), 0, ax)
        rho = sym.T @ moved.reshape(16 ** nu, -1)  # the rotation on symmetric coordinates
        # T = X sym^T with X [m, s]: equivariant when X rho = D_L X
        s = rho.shape[0]
        rows.append(np.kron(np.eye(m), rho.T) - np.kron(_d_matrix(L, rot), np.eye(s)))
    null = _kernel(rows)
    q = np.stack([(v.reshape(m, -1) @ sym.T).reshape(-1) for v in null.T], 1)
    cols = []
    for j in range(q.shape[0]):  # Gram-Schmidt of P e_j = q q[j]^T, in index order
        if len(cols) == q.shape[1]:
            break
        if np.linalg.norm(q[j]) < 1e-8:  # P e_j itself is under the tolerance
            continue
        col = q @ q[j]
        for _ in range(2):
            for c in cols:
                col = col - c * (c @ col)
        norm = np.linalg.norm(col)
        if norm >= 1e-8:
            cols.append(col / norm)
    return np.stack(cols, 1).reshape((m,) + (16,) * nu + (-1,))


@functools.lru_cache(maxsize=None)
def silu_norm() -> float:
    """1 / sqrt(E[SiLU(z)^2]), z standard normal (Gauss-Hermite quadrature)."""
    z, w = np.polynomial.hermite_e.hermegauss(200)
    silu = z / (1.0 + np.exp(-z))
    return float((np.sum(w * silu ** 2) / math.sqrt(2.0 * math.pi)) ** -0.5)


def paths(ls_in) -> list:
    return [(l1, l2, l3) for l2 in ls_in for l1 in range(LMAX + 1)
            for l3 in range(abs(l1 - l2), min(l1 + l2, LMAX) + 1) if (l1 + l2 + l3) % 2 == 0]


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def contract(wts: dict, A: torch.Tensor, atoms: torch.Tensor, L: int, prod: Products = None,
             block: int = 512) -> torch.Tensor:
    """B_L [N, 2L+1, F]: the symmetric contraction of ``A`` [N, 16, F] onto
    L with the weights ``wts`` {"w1", "w2", "w3"} [V, eta, F], each atom by
    its element in ``atoms`` f32[N, V] one-hot (a row of zeros: 0), as
    mace's Contraction: each element's W U, then contracted with A from the
    last index, adding the lower orders; ``block`` atoms at a time."""
    prod = prod or Products()
    n, _, F = A.shape
    f32 = dict(dtype=torch.float32, device=A.device)
    z = atoms.argmax(1)
    has = atoms.sum(1) > 0
    out = torch.zeros((n, F, 2 * L + 1), **f32)
    u = [torch.tensor(u_basis(nu, L), **f32) for nu in (1, 2, 3)]
    for e in range(atoms.shape[1]):
        idx = torch.nonzero((z == e) & has).flatten()
        if idx.numel() == 0:
            continue
        u3 = prod.einsum("mabcq,qf->fmabc", u[2], wts["w3"][e])
        u2 = prod.einsum("mabq,qf->fmab", u[1], wts["w2"][e])
        u1 = prod.einsum("maq,qf->fma", u[0], wts["w1"][e])
        for a0 in range(0, idx.numel(), block):
            at = idx[a0:a0 + block]
            xa = A[at].transpose(1, 2)  # [b, F, 16]
            c3 = prod.einsum("fmabc,nfc->nfmab", u3, xa) + u2
            c2 = torch.einsum("nfmab,nfb->nfma", prod.op(c3), prod.op(xa)) + u1
            out[at] = torch.einsum("nfma,nfa->nfm", prod.op(c2), prod.op(xa))
    return out.transpose(1, 2)


def forward(p: dict, cfg: dict, atoms, nlist, edges, positions, prod: Products = None,
            block: int = 512, layer_out: list = None) -> torch.Tensor:
    """Peaks f32[N] of one structure: ``atoms`` f32[N, V] one-hot, ``nlist``
    [N, K], ``edges`` f32[N, K] nm (0: padding), ``positions`` f32[N, 3] nm.
    ``layer_out``, a list, receives each interaction's A [N, 16, F]."""
    prod = prod or Products()
    dev = atoms.device
    n, V = atoms.shape
    F, R = cfg["atom_feature_size"], cfg["edge_hidden_size"]
    L_h = cfg["edge_feature_size"]
    rc = 10.0 * cfg["rbf_high"]  # Angstrom
    pos = positions.double()  # differences exact at any offset, then Angstrom
    f32 = dict(dtype=torch.float32, device=dev)
    c_act = silu_norm()
    z = atoms.argmax(1)
    has = atoms.sum(1) > 0

    # each block of atoms: neighbors, real edges, Y and the edge basis
    blocks = []
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(r0 + block, n), device=dev)
        j = nlist[rows].long()
        r = ((pos[j] - pos[rows][:, None, :]) * 10.0).float()
        d = torch.linalg.norm(r, dim=-1)
        edge = (edges[rows] > 0) & (d < rc)
        safe = torch.where(edge, d, torch.full_like(d, rc))
        unit = r / safe[..., None]
        x = safe / rc
        env = torch.where(edge, 1 - 21 * x ** 5 + 35 * x ** 6 - 15 * x ** 7, torch.zeros_like(x))
        k = torch.arange(1, R + 1, **f32)
        basis = (math.sqrt(2.0 / rc) * torch.sin(k * math.pi * safe[..., None] / rc)
                 / safe[..., None] * env[..., None])
        blocks.append((rows, j, sh_table(unit), basis))

    def per_element(x, kernel):
        """x [n, c, F] times kernel[z_i] [F, F'] for each atom's element."""
        out = torch.zeros(x.shape[:2] + (kernel.shape[-1],), **f32)
        for e in range(V):
            sel = (z == e) & has
            if bool(sel.any()):
                out[sel] = prod.einsum("ncf,fg->ncg", x[sel], kernel[e])
        return out

    h = {0: prod.mm(atoms, p["embed"]["kernel"])[:, None, :]}
    n_layers = len(p["mp"])
    for t, layer in enumerate(p["mp"]):
        ls_out = [0] if t == n_layers - 1 else list(range(L_h + 1))
        ls_in = sorted(h)
        ht = {l: prod.einsum("ncf,fg->ncg", h[l], layer["up"][i]["kernel"])
              for i, l in enumerate(ls_in)}
        ps = paths(ls_in)
        M = {l3: torch.zeros((n, 2 * l3 + 1, sum(q[2] == l3 for q in ps) * F), **f32)
             for l3 in range(LMAX + 1)}
        for rows, j, Y, basis in blocks:
            x = basis
            for i, lin in enumerate(layer["radial"]):
                x = prod.mm(x, lin["kernel"])
                if i < len(layer["radial"]) - 1:
                    x = silu(x) * c_act
            w = x.view(*j.shape, len(ps), F)
            seen = {l3: 0 for l3 in range(LMAX + 1)}
            for pi, (l1, l2, l3) in enumerate(ps):
                y = Y[..., l1 * l1:(l1 + 1) ** 2]
                c = torch.tensor(cg(l1, l2, l3) * math.sqrt(2 * l3 + 1), **f32)
                hj = ht[l2][j]  # [b, K, 2l2+1, F]
                yc = prod.einsum("bka,aqc->bkqc", y, c)  # [b, K, 2l2+1, 2l3+1]
                msg = torch.einsum("bkqc,bkqf->bkcf", yc, hj) * w[:, :, pi, None, :]
                s = seen[l3]
                M[l3][rows, :, s * F:(s + 1) * F] = msg.sum(1)
                seen[l3] += 1
        avg = p["avg_num_neighbors"]
        A = torch.cat([prod.einsum("ncq,qf->ncf", M[l3], layer["linear"][l3]["kernel"]) / avg
                       for l3 in range(LMAX + 1)], 1)  # [n, 16, F]
        if t == 0:
            A = torch.cat([per_element(A[:, l * l:(l + 1) ** 2], layer["skip"][l]["kernel"])
                           for l in range(LMAX + 1)], 1)
            sc = None
        else:
            sc = {L: per_element(h[L], layer["skip"][i]["kernel"]) for i, L in enumerate(ls_out)}
        if layer_out is not None:
            layer_out.append(A)
        B = {L: contract(layer["product"][i], A, atoms, L, prod, block)
             for i, L in enumerate(ls_out)}
        h = {}
        for i, L in enumerate(ls_out):
            h[L] = prod.einsum("ncf,fg->ncg", B[L], layer["out"][i]["kernel"])
            if sc is not None:
                h[L] = h[L] + sc[L]
    x = h[0][:, 0, :]
    for layer in p["fc"][:-1]:
        x = silu(prod.mm(x, layer["kernel"]) + layer["bias"]) + x
    x = silu(prod.mm(x, p["fc"][-1]["kernel"]) + p["fc"][-1]["bias"])
    full = prod.mm(x, p["out"]["kernel"]) + p["out"]["bias"]
    return torch.sum((full * p["peak_std"] + p["peak_avg"]) * atoms, dim=-1)
