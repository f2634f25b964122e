"""Banded smoothed-aggregation multigrid (counterpart of
pinn_fem_tpu/ops/mg.py).

A V-cycle that stays in the banded DIA representation, as the JAX
package's does:

  * coarsening: pairwise aggregation of adjacent nodes (components kept
    apart).  A fine entry A[i, i+o] with i = B I + r (B = 2 components)
    lands on a coarse offset fixed by (o, r), so the coarse offsets are
    static and each coarse diagonal is a sum of strided slices of fine
    diagonals;
  * smoothing: damped Jacobi (omega = 2/3) on every level, smoothed
    aggregation on the first _SMOOTH_LEVELS coarsenings;
  * transfers: piecewise-constant node pairs, restriction P^T a
    reshape-sum, prolongation P a repeat (the cycle is symmetric, so it is
    a PCG preconditioner);
  * coarsest level (<= `coarsest` DOFs): one dense Cholesky factor, with
    the JAX package's 1e-10 I shift, reused by every cycle of a solve.

Boundary conditions enter once, by masking the fine operator (mask_dia).

Device work.  The index algebra of dia_mul, coarsen, mask_dia and
_dense_from_dia depends on the offsets and sizes only: it is computed on
the host with numpy once per shape and device and kept (lru caches), so a
build runs a few torch ops a level: two per offset of the left operand in
dia_mul (as the JAX package), at most eight gathers and adds in coarsen
(the JAX package: one op per (offset, residue)).  Each sum runs in the
JAX package's order: dia_mul adds offset by offset of the left operand,
coarsen adds a coarse entry's contributions by (fine offset, residue),
smoothed_operator adds A, then -2 omega E, then omega^2 F.  No add has two
contributions to one entry in one op, so the build is deterministic on a
card too.

Every level holds its own DiaLayout (made once per level shape), and every
level matvec is ops.dia.dia_matvec: kernel 1 (`stencil_kernel`) on a CUDA
tensor, its plain twin on a CPU tensor.  `v_cycle_reference` runs the same
cycle on `dia_matvec_reference` (the plain version the card is held to).
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .dia import DiaLayout, dia_matvec, dia_matvec_reference

_OMEGA = 2.0 / 3.0
_SMOOTH_LEVELS = 2  # coarsenings that use smoothed aggregation


class MGLevel(NamedTuple):
    offsets: Tuple[int, ...]   # diagonal offsets of this level
    ndof: int                  # level size
    diags: torch.Tensor        # (nd, ndof) level operator
    inv_diag: torch.Tensor     # (ndof,) 1 / diag(A), for Jacobi smoothing
    smoothed: bool = False     # transfers below this level are SA-smoothed
    layout: Optional[DiaLayout] = None      # kernel 1's layout of the level
    omega_inv_diag: Optional[torch.Tensor] = None  # _OMEGA * inv_diag


class MGHierarchy(NamedTuple):
    levels: Tuple[MGLevel, ...]
    chol: torch.Tensor         # coarsest-level Cholesky factor (lower)
    components: int            # DOFs per node
    smooth: bool               # smoothed-aggregation transfers


@functools.lru_cache(maxsize=256)
def _level_layout(offsets: Tuple[int, ...], ndof: int) -> DiaLayout:
    """The layout of one level shape, made once, so kernel 1's plan and
    device offsets (cached on the layout) are made once too."""
    return DiaLayout(offsets=np.asarray(offsets, np.int64), entry_slot=None,
                     ndof=ndof, bandwidth=max(max(abs(o) for o in offsets), 1))


def _on(device: str, *arrays) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in arrays)


@functools.lru_cache(maxsize=256)
def _mask_plan(offsets: Tuple[int, ...], ndof: int, device: str):
    """Start of each offset's window in the mask padded by ndof zeros on
    each side (clamped as the JAX package's dynamic_slice clamps)."""
    return _on(device, np.clip(ndof + np.asarray(offsets), 0, 2 * ndof))[0]


def mask_dia(offsets: Tuple[int, ...], diags: torch.Tensor,
             free_mask: torch.Tensor) -> torch.Tensor:
    """Masked-BC operator in DIA form: M A M + (I - M).

    d'_k[i] = d_k[i] * m[i] * m[i + o_k]; the offset-0 diagonal gains
    (1 - m[i]) so fixed rows become identity (cf. ops/linalg.masked_solve).
    """
    ndof = diags.shape[1]
    starts = _mask_plan(tuple(offsets), ndof, str(diags.device))
    m_pad = F.pad(free_mask, (ndof, ndof))
    out = diags * free_mask * m_pad.unfold(0, ndof, 1)[starts]
    k0 = tuple(offsets).index(0)
    out[k0] = out[k0] + (1.0 - free_mask)
    return out


def dia_rowscale(diags: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """D_scale @ A in DIA form: every row i scaled by scale[i]."""
    return diags * scale[None, :]


@functools.lru_cache(maxsize=256)
def _mul_plan(offsets_a: Tuple[int, ...], offsets_b: Tuple[int, ...],
              device: str):
    """(out offsets, (na, nb) out row of each (oa, ob) pair on device)."""
    out_offsets = tuple(sorted({oa + ob for oa in offsets_a
                                for ob in offsets_b}))
    sums = np.add.outer(np.asarray(offsets_a), np.asarray(offsets_b))
    rows = np.searchsorted(np.asarray(out_offsets), sums)
    return out_offsets, _on(device, rows)[0]


def dia_mul(offsets_a: Tuple[int, ...], da: torch.Tensor,
            offsets_b: Tuple[int, ...], db: torch.Tensor, ndof: int
            ) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """(A @ B) of two DIA operators.

    (A B)[i, i + oa + ob] += A[i, i+oa] * B[i+oa, i+oa+ob], so each output
    diagonal oa+ob accumulates da[oa] * shift(db[ob], oa), a slice of the
    zero-padded db.  One multiply and one index_add_ per oa (its rows are
    distinct, so each entry gets one add an op, in oa order).
    """
    offsets_a, offsets_b = tuple(offsets_a), tuple(offsets_b)
    out_offsets, rows = _mul_plan(offsets_a, offsets_b, str(da.device))
    out = torch.zeros((len(out_offsets), ndof), dtype=da.dtype,
                      device=da.device)
    pad = max(abs(o) for o in offsets_a)
    db_pad = F.pad(db, (pad, pad))
    for ka, oa in enumerate(offsets_a):
        shifted = db_pad[:, pad + oa:pad + oa + ndof]
        out.index_add_(0, rows[ka], da[ka] * shifted)
    return out_offsets, out


@functools.lru_cache(maxsize=256)
def _union_plan(offsets: Tuple[int, ...], off_e: Tuple[int, ...],
                off_f: Tuple[int, ...], device: str):
    out_offsets = tuple(sorted(set(offsets) | set(off_e) | set(off_f)))
    where = np.asarray(out_offsets)
    return (out_offsets, *_on(device, *(np.searchsorted(where, o)
                                        for o in (offsets, off_e, off_f))))


def smoothed_operator(offsets: Tuple[int, ...], diags: torch.Tensor,
                      ndof: int, omega: float = _OMEGA
                      ) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """S = (I - omega*A*D^-1) A (I - omega*D^-1*A) in DIA form.

    Sandwiching the tentative aggregation with S instead of A is smoothed
    aggregation: P_s^T A P_s = P_t^T S P_t with P_s = (I - omega D^-1 A)
    P_t.  S = A - 2*omega*E + omega^2*F with E = A D^-1 A and
    F = A D^-1 A D^-1 A.
    """
    offsets = tuple(offsets)
    k0 = offsets.index(0)
    inv_d = 1.0 / diags[k0]
    m1 = dia_rowscale(diags, inv_d)                       # D^-1 A
    off_e, e = dia_mul(offsets, diags, offsets, m1, ndof)  # A D^-1 A
    m3 = dia_rowscale(e, inv_d)                            # D^-1 E
    off_f, f = dia_mul(offsets, diags, off_e, m3, ndof)    # A D^-1 E

    out_offsets, ia, ie, i_f = _union_plan(offsets, off_e, off_f,
                                           str(diags.device))
    s = torch.zeros((len(out_offsets), ndof), dtype=diags.dtype,
                    device=diags.device)
    s.index_add_(0, ia, diags)
    s.index_add_(0, ie, e * (-2.0 * omega))
    s.index_add_(0, i_f, f * (omega * omega))
    return out_offsets, s


def _agg_index(i: np.ndarray, components: int) -> np.ndarray:
    """Static aggregation map: merge adjacent nodes, keep vector components
    separate.  For `components` DOFs per node, fine dof i = C*node + c
    aggregates to coarse dof C*(node//2) + c."""
    c = i % components
    node = i // components
    return components * (node // 2) + c


@functools.lru_cache(maxsize=256)
def _coarsen_plan(offsets: Tuple[int, ...], components: int, device: str):
    """(coarse offsets, (m, n_cd * components) source rows on device).

    Source row k * B + r is residue r of fine diagonal k (row nd * B is a
    zero row).  Coarse diagonal c at phase ph (coarse dofs ph::components)
    sums column j of its row of the table, j = 0..m-1, in the JAX
    package's (offset, residue) order."""
    B = 2 * components
    r = np.arange(B)
    i_c = _agg_index(r, components)
    contribs = {}   # (coarse offset, phase) -> [source rows, in order]
    for k, o in enumerate(offsets):
        c_off = _agg_index(r + o, components) - i_c
        for rr in range(B):
            contribs.setdefault((int(c_off[rr]), int(i_c[rr])), []).append(
                k * B + rr)
    coarse_offsets = tuple(sorted({c for c, _ in contribs}))
    m = max(len(v) for v in contribs.values())
    table = np.full((len(coarse_offsets), components, m), len(offsets) * B)
    for (c, ph), rows in contribs.items():
        table[coarse_offsets.index(c), ph, :len(rows)] = rows
    table = table.reshape(-1, m).T.copy()
    return coarse_offsets, _on(device, table)[0]


def coarsen(offsets: Tuple[int, ...], diags: torch.Tensor, ndof: int,
            components: int = 1
            ) -> Tuple[Tuple[int, ...], torch.Tensor, int]:
    """One aggregation Galerkin coarsening P^T A P in DIA form.

    The aggregation pattern is periodic with period B = 2*components, so a
    fine entry A[i, i+o] lands on a coarse offset fixed by the residue
    r = i % B: each (offset, residue) pair contributes one strided slice
    of a fine diagonal to one coarse diagonal.  The device work is one
    reshape of the fine diagonals into (offset, residue) rows, then one
    gather and one add per contribution rank (at most 4 a coarse entry).
    """
    offsets = tuple(offsets)
    B = 2 * components
    n_c_nodes = -(-ndof // B)          # coarse nodes after padding
    n_c = components * n_c_nodes
    coarse_offsets, table = _coarsen_plan(offsets, components,
                                          str(diags.device))
    # (nd * B + 1, n_c_nodes): row k * B + r holds residue r of diagonal k.
    d_pad = F.pad(diags, (0, B * n_c_nodes - ndof))
    rows = d_pad.view(len(offsets), n_c_nodes, B).transpose(1, 2)
    rows = F.pad(rows.reshape(len(offsets) * B, n_c_nodes), (0, 0, 0, 1))
    acc = torch.zeros((table.shape[1], n_c_nodes), dtype=diags.dtype,
                      device=diags.device)
    for j in range(table.shape[0]):
        acc += rows[table[j]]
    out = acc.view(len(coarse_offsets), components, n_c_nodes).transpose(1, 2)
    return coarse_offsets, out.reshape(len(coarse_offsets), n_c), n_c


@functools.lru_cache(maxsize=64)
def _dense_plan(offsets: Tuple[int, ...], ndof: int, device: str):
    """(flat source in the (nd, ndof) diagonals, flat target in the dense
    (ndof, ndof) matrix) of every in-range entry."""
    i = np.arange(ndof)
    src, dst = [], []
    for k, o in enumerate(offsets):
        ok = (i + o >= 0) & (i + o < ndof)
        src.append(k * ndof + i[ok])
        dst.append(i[ok] * ndof + i[ok] + o)
    return _on(device, np.concatenate(src), np.concatenate(dst))


def _dense_from_dia(offsets: Tuple[int, ...], diags: torch.Tensor, ndof: int
                    ) -> torch.Tensor:
    src, dst = _dense_plan(tuple(offsets), ndof, str(diags.device))
    a = torch.zeros(ndof * ndof, dtype=diags.dtype, device=diags.device)
    a[dst] = diags.reshape(-1)[src]
    return a.view(ndof, ndof)


def build_hierarchy(layout: DiaLayout, diags: torch.Tensor,
                    free_mask: torch.Tensor, coarsest: int = 512,
                    max_levels: int = 12, components: int = 1,
                    smooth: bool = True) -> MGHierarchy:
    """The multigrid hierarchy of one assembled operator.  Every V-cycle of
    a PCG solve reuses it, the coarsest-level Cholesky factor included.

    components: DOFs per node (the problem dimension); aggregation merges
    adjacent nodes and keeps vector components separate.
    smooth: smoothed aggregation on the first _SMOOTH_LEVELS coarsenings
    (tentative aggregates alone give h-dependent convergence; the coarse
    diagonal count grows ~3x per smoothed coarsening, so only the finest
    levels smooth).
    The Cholesky factor is NaN where the coarse operator does not factor,
    as the JAX package's cho_factor gives (the PCG then stops on a
    non-finite r.z).
    """
    offsets = tuple(int(o) for o in layout.offsets)
    ndof = layout.ndof
    diags = mask_dia(offsets, diags, free_mask)

    levels: List[MGLevel] = []
    for li in range(max_levels):
        k0 = offsets.index(0)
        # Aggregation pads odd levels with all-zero rows; give those an
        # identity diagonal (their off-diagonals are zero by construction)
        # or the Jacobi smoother divides by zero.
        diag = torch.where(diags[k0].abs() > 0, diags[k0], 1.0)
        diags[k0] = diag
        inv_diag = 1.0 / diag
        sm_here = bool(smooth and li < _SMOOTH_LEVELS)
        levels.append(MGLevel(offsets=offsets, ndof=ndof, diags=diags,
                              inv_diag=inv_diag, smoothed=sm_here,
                              layout=_level_layout(offsets, ndof),
                              omega_inv_diag=_OMEGA * inv_diag))
        if ndof <= coarsest:
            break
        if sm_here:
            off_s, d_s = smoothed_operator(offsets, diags, ndof)
        else:
            off_s, d_s = offsets, diags
        offsets, diags, ndof = coarsen(off_s, d_s, ndof,
                                       components=components)

    last = levels[-1]
    a_c = _dense_from_dia(last.offsets, last.diags, last.ndof)
    # The Galerkin coarse operator of an SPD fine operator is SPD; a tiny
    # shift guards float32 semi-definiteness from aggregated fixed rows.
    a_c = a_c + 1e-10 * torch.eye(last.ndof, dtype=a_c.dtype,
                                  device=a_c.device)
    chol, info = torch.linalg.cholesky_ex(a_c)
    chol = torch.where(info == 0, chol, torch.nan)
    return MGHierarchy(levels=tuple(levels), chol=chol,
                       components=components, smooth=smooth)


def _restrict(r: torch.Tensor, n_c_nodes: int, components: int
              ) -> torch.Tensor:
    """P^T r with node-pair aggregation: sum the two fine nodes of each
    coarse node, component-wise."""
    n_pad = 2 * n_c_nodes * components
    if n_pad != r.shape[0]:
        r = F.pad(r, (0, n_pad - r.shape[0]))
    return r.view(n_c_nodes, 2, components).sum(dim=1).reshape(-1)


def _prolong(e_c: torch.Tensor, n_f: int, components: int) -> torch.Tensor:
    """P e_c: inject each coarse node's value into its two fine nodes."""
    e = e_c.view(-1, 1, components).expand(-1, 2, components).reshape(-1)
    return e[:n_f]


def _cycle(h: MGHierarchy, b: torch.Tensor,
           matvec: Callable[[DiaLayout, torch.Tensor, torch.Tensor],
                            torch.Tensor]) -> torch.Tensor:
    """One symmetric V(1,1) cycle from x0 = 0 with the given level matvec.
    Each non-coarsest level runs two matvecs, a smoothed one two more."""
    levels = h.levels
    comp = h.components

    def mv(lvl: MGLevel, v: torch.Tensor) -> torch.Tensor:
        return matvec(lvl.layout, lvl.diags, v)

    # Downsweep: smooth from zero, restrict the residual (P_s^T r =
    # inject^T((I - omega A D^-1) r) below a smoothed level).
    xs: List[torch.Tensor] = []
    bs: List[torch.Tensor] = [b]
    for li in range(len(levels) - 1):
        lvl = levels[li]
        x = lvl.omega_inv_diag * bs[li]        # smooth(b, x=0), one sweep
        r = bs[li] - mv(lvl, x)
        if lvl.smoothed:
            r = r - _OMEGA * mv(lvl, lvl.inv_diag * r)
        xs.append(x)
        bs.append(_restrict(r, levels[li + 1].ndof // comp, comp))

    # Coarsest: exact solve with the prefactored Cholesky.
    x_c = torch.cholesky_solve(bs[-1][:, None], h.chol)[:, 0]

    # Upsweep: correct (P_s e = (I - omega D^-1 A) inject(e) below a
    # smoothed level), then post-smooth once.
    for li in range(len(levels) - 2, -1, -1):
        lvl = levels[li]
        e = _prolong(x_c, lvl.ndof, comp)
        if lvl.smoothed:
            e = e - lvl.omega_inv_diag * mv(lvl, e)
        x = xs[li] + e
        x_c = x + lvl.omega_inv_diag * (bs[li] - mv(lvl, x))
    return x_c


def v_cycle(h: MGHierarchy, b: torch.Tensor) -> torch.Tensor:
    """One symmetric V(1,1) cycle, x0 = 0: the PCG preconditioner apply.
    Kernel 1 on every level of a CUDA hierarchy."""
    return _cycle(h, b, dia_matvec)


def v_cycle_reference(h: MGHierarchy, b: torch.Tensor) -> torch.Tensor:
    """The same cycle on the plain matvec (dia_matvec_reference)."""
    return _cycle(h, b, dia_matvec_reference)


def cycle_matvecs(h: MGHierarchy) -> int:
    """Level matvecs one V-cycle runs: 2 (L - 1) + 2 S for L levels, S of
    them smoothed and not the coarsest."""
    return sum(2 + 2 * lvl.smoothed for lvl in h.levels[:-1])
