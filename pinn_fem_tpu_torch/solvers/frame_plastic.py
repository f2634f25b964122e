"""Frame plastic-hinge pushover (counterpart of
pinn_fem_tpu/solvers/frame_plastic.py): rigid-plastic collapse of 2D frames
by the event-to-event hinge method.

Elastic-perfectly-plastic concentrated bending hinges at member ends: an
end hinges when its local end moment reaches +-Mp and then carries Mp
while the mechanism rotates (proportional, monotone pushover; no axial-
moment interaction).  With hinge state h the member tangent is the static
condensation of the released end rotations out of the exact 6 x 6 local
matrix, K_c = K_kk - K_kr K_rr^-1 K_rk, so a hinged end's moment rate is
zero and a doubly hinged member is the axial bar.  Each increment solves
the tangent system for du/dlambda, scales to the first end reaching +-Mp
(ends within rtol_simultaneous of it hinge together), commits, and repeats
until the free-block tangent is a mechanism (smallest eigenvalue at most
1e-10 of the largest).

Float64 torch on the caller's device, the card by default: each event
assembles, checks and solves on the device and reads one packet on the
host (the flags, the step and the new hinges), which decides the event.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.frame import (_F64, FrameProblem, _local_stiffness,
                            _to_global)
from ..models.plane import _numpy, _t
from ..ops.assembly import scatter_add
from ..utils.runtime import resolve_device

_THETA = (2, 5)                  # local end-rotation rows (t1, t2)


def _condensed_local(kl: torch.Tensor, hinges: torch.Tensor
                     ) -> torch.Tensor:
    """(m, 6, 6) local tangent stiffness with the hinged end-rotation DOFs
    statically condensed out (zeroed rows / columns keep the 6 x 6
    assembly shape).  Each hinge state's condensation is formed for every
    member and selected by the state, so nothing is read on the host."""
    out = kl
    state = hinges[:, 0].long() + 2 * hinges[:, 1].long()
    for code in (1, 2, 3):           # bit 0: end 1 hinged, bit 1: end 2
        rel = [t for b, t in enumerate(_THETA) if code & (1 << b)]
        keep = torch.as_tensor([i for i in range(6) if i not in rel],
                               device=kl.device)
        rel = torch.as_tensor(rel, device=kl.device)
        kkk = kl[:, keep][:, :, keep]
        kkr = kl[:, keep][:, :, rel]
        krr = kl[:, rel][:, :, rel]
        kc = kkk - torch.einsum("mab,mbc,mdc->mad", kkr,
                                torch.linalg.inv(krr), kkr)
        blk = torch.zeros_like(kl)
        blk[:, keep[:, None], keep[None, :]] = kc
        out = torch.where((state == code)[:, None, None], blk, out)
    return out


@dataclass
class FramePushoverResult:
    """Capacity curve and hinge history of a proportional pushover."""
    collapse_factor: Optional[float]   # lambda at mechanism (None: capped)
    mechanism: bool                    # True if collapse was reached
    load_factors: np.ndarray           # (k,) committed lambda after events
    displacements: np.ndarray          # (k, n_probe) probe history
    hinge_members: np.ndarray          # (n_h,) member of each hinge
    hinge_ends: np.ndarray             # (n_h,) 0 | 1 local end
    hinge_factors: np.ndarray          # (n_h,) lambda at formation
    end_moments: np.ndarray            # (m, 2) final local end moments
    axial: np.ndarray                  # (m,) final axial (tension +)
    u: np.ndarray                      # (ndof,) final displacements


def _event(kl, t, dm, hinges, base_mask, f_ref, mp, m_end, ndof: int,
           rtol: float):
    """One event's device work: the condensed tangent, the floating DOFs,
    the mechanism test, the rate solve du and the room of every elastic
    end.  Returns (du, dm_end, dn, new, packet): new (m, 2) the ends that
    hinge at the step, packet = [a load on a floating DOF, no free DOF,
    mechanism, step, new...], float64."""
    kc_loc = _condensed_local(kl, hinges)
    blocks = _to_global(t, kc_loc)
    flat = dm[:, :, None] * ndof + dm[:, None, :]
    k = scatter_add(ndof * ndof, flat, blocks).reshape(ndof, ndof)
    diag = torch.diagonal(k)
    scale = diag.max() if diag.numel() else torch.ones((), dtype=_F64)
    floating = (base_mask > 0) & (diag <= 1e-12 * scale)
    loaded_floating = torch.any(floating & (f_ref.abs() > 0))
    mask = base_mask * (~floating)
    fixed = (mask == 0).sum()
    # The free block's spectrum: that of M K M past its n_fixed zeros.
    w = torch.linalg.eigvalsh(mask[:, None] * k * mask[None, :])
    w0 = w[torch.clamp(fixed, max=ndof - 1)]
    mechanism = w0 <= 1e-10 * torch.clamp_min(w[-1], 1e-300)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    du = torch.linalg.solve_ex(km, f_ref * mask)[0] * mask
    du_loc = torch.einsum("mij,mj->mi", t, du[dm])
    df_loc = torch.einsum("mij,mj->mi", kc_loc, du_loc)
    dm_end = df_loc[:, [2, 5]]                      # (m, 2)
    dn = -df_loc[:, 0]
    mp2 = mp[:, None].expand_as(m_end)
    room = torch.where(dm_end > 0.0, (mp2 - m_end) / dm_end,
                       (-mp2 - m_end) / dm_end)
    inf = torch.full_like(room, float("inf"))
    room = torch.where(torch.isfinite(room), room, inf)
    room = torch.where(dm_end.abs() <= 1e-14 * mp2, inf, room)
    room = torch.where(hinges, inf, room)
    d_lam = room.min()
    new = (room <= d_lam * (1.0 + rtol)) & ~hinges
    packet = torch.cat([torch.stack([loaded_floating.to(_F64),
                                     (fixed == ndof).to(_F64),
                                     mechanism.to(_F64), d_lam]),
                        new.reshape(-1).to(_F64)])
    return du, dm_end, dn, new, packet


def frame_pushover(problem: FrameProblem, plastic_moment,
                   max_load_factor: Optional[float] = None,
                   probe_dofs=None, max_hinges: Optional[int] = None,
                   rtol_simultaneous: float = 1e-9,
                   device=None) -> FramePushoverResult:
    """Proportional pushover of the problem's load pattern to plastic
    collapse (module docstring), float64 on `device` ("cuda" when None).

    plastic_moment: (m,) or scalar Mp > 0.  max_load_factor: stop the ramp
    there if no mechanism forms first (collapse_factor is then None,
    mechanism False).  Proportional load patterns only."""
    mp_np = np.broadcast_to(np.asarray(plastic_moment, dtype=float),
                            (problem.nelm,)).copy()
    if np.any(mp_np <= 0.0):
        raise ValueError("plastic_moment must be positive")
    if problem.member_loads is not None and \
            np.any(problem.member_loads):
        raise ValueError(
            "frame pushover supports nodal load patterns only — the "
            "hinge-event scaling needs end moments linear in λ, and "
            "member-load fixed-end corrections break that; lump the "
            "distributed load to the nodes")
    if problem.temperature is not None \
            or problem.temperature_gradient is not None:
        raise ValueError("frame pushover does not take a thermal load "
                         "case — thermoelastic loads are not "
                         "proportional (run them as a separate static)")
    if not np.any(problem.loads):
        raise ValueError("the pushover needs a nonzero load pattern")

    dev = resolve_device(device)
    ndof = problem.ndof
    kl, t = _local_stiffness(problem, dev)
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64, device=dev)
    base_mask = _t(problem.free_mask(), dev)
    f_ref = _t(problem.loads, dev)
    mp = _t(mp_np, dev)
    probe = torch.as_tensor(
        np.arange(ndof) if probe_dofs is None
        else np.asarray(probe_dofs, dtype=int).reshape(-1),
        dtype=torch.int64, device=dev)

    hinges = torch.zeros((problem.nelm, 2), dtype=torch.bool, device=dev)
    lam = 0.0
    u = torch.zeros(ndof, dtype=_F64, device=dev)
    m_end = torch.zeros((problem.nelm, 2), dtype=_F64, device=dev)
    axial = torch.zeros(problem.nelm, dtype=_F64, device=dev)
    lam_hist, u_hist = [0.0], [u[probe]]
    h_mem, h_end, h_lam = [], [], []
    mechanism = False
    cap = 2 * problem.nelm if max_hinges is None else int(max_hinges)

    for _ in range(cap + 1):
        du, dm_end, dn, new, packet = _event(
            kl, t, dm, hinges, base_mask, f_ref, mp, m_end, ndof,
            rtol_simultaneous)
        packet = packet.cpu().numpy()
        loaded_floating, no_free, is_mechanism, d_lam = packet[:4]
        if loaded_floating or no_free or is_mechanism:
            # A load on a fully released DOF, no free DOF, or a singular
            # free-block tangent: the mechanism.
            mechanism = True
            break
        d_lam = float(d_lam)
        if not np.isfinite(d_lam) or d_lam <= 0.0:
            # no end can ever yield under this pattern: elastic forever
            if max_load_factor is None:
                raise ValueError(
                    "no member end moves toward its plastic moment "
                    "under this load pattern (pure axial pattern?) — "
                    "give max_load_factor to run a capped elastic ramp")
            d_lam = np.inf
        capped = (max_load_factor is not None
                  and lam + d_lam >= float(max_load_factor))
        if capped:
            d_lam = float(max_load_factor) - lam
        lam += d_lam
        u = u + d_lam * du
        m_end = m_end + d_lam * dm_end
        axial = axial + d_lam * dn
        lam_hist.append(lam)
        u_hist.append(u[probe])
        if capped:
            break
        # The ends that reach +-Mp at this step (within rtol_simultaneous
        # of the first), decided on the device at its step.
        for mm, ee in np.argwhere(packet[4:].reshape(-1, 2) > 0):
            h_mem.append(int(mm))
            h_end.append(int(ee))
            h_lam.append(lam)
        hinges |= new

    return FramePushoverResult(
        collapse_factor=(lam if mechanism else None),
        mechanism=mechanism,
        load_factors=np.asarray(lam_hist),
        displacements=_numpy(torch.stack(u_hist)),
        hinge_members=np.asarray(h_mem, dtype=int),
        hinge_ends=np.asarray(h_end, dtype=int),
        hinge_factors=np.asarray(h_lam),
        end_moments=_numpy(m_end), axial=_numpy(axial), u=_numpy(u))
