"""FORM structural reliability: failure probabilities from the dense
differentiable solve (counterpart of pinn_fem_tpu/solvers/reliability.py).

Random variables (normal or lognormal: Young's modulus, areas or density
over element subsets, a global load scale, a resistance) map to standard
normals by the exact marginal transform, optionally through a Nataf
(Gaussian-copula) correlation factor and random-field expansions
(exp(-d / L) between element midpoints).  Each limit state g_i <= 0
(member stress, probe displacement, fundamental frequency or fatigue life
ratio) is searched by the HL-RF fixpoint u <- (grad g . u - g) /
|grad g|^2 grad g; beta_i = sign(g(0)) |u*|, p_f = Phi(-beta).  The series
system gets the simple and the Ditlevsen bounds; SORM adds Breitung's
curvature correction through the Hessian of the whole chain; Monte Carlo
(crude, or importance sampling on the dominant design points) checks it
on the same response.

The JAX package vmaps the HL-RF over the limit states and the Monte Carlo
over samples.  Here a demand / capacity function takes a batch:
`ratios_all(U)` maps (B, n_vars) standard-normal rows to (B, n_ls)
ratios.  The truss stress and displacement limit states are one batched
dense solve (solvers/sizing.batched_response: one float64 scatter a row,
one batched torch.linalg.solve); the frequency and fatigue limit states,
and the frame and continuum families' (form_core), evaluate the rows one
after another.  HL-RF runs limit state i on row i of U: the gradient of
sum_i g_i(U_i) is row i's own gradient, so the batch is the vmap.  The
HL-RF history stays on the device and is fetched once; a Monte Carlo
chunk is one batch, fetched once.  The samples come from
numpy.random.default_rng(seed), as the JAX package draws them, so both
packages see the same u.

Dense only (the MPP search traces the dense masked solve).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import erf, sqrt
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.problem import TrussProblem
from ..utils.runtime import resolve_device

_DISTS = ("normal", "lognormal")
_KINDS = ("young", "area", "density", "load_scale", "resistance")


@dataclass
class ReliabilityResult:
    """FORM output + the Monte-Carlo cross-check when requested."""
    beta: np.ndarray            # (n_ls,) Hasofer-Lind indices
    pf: np.ndarray              # (n_ls,) Phi(-beta)
    alpha: np.ndarray           # (n_ls, n_vars) MPP direction cosines
    design_point: np.ndarray    # (n_ls, n_vars) MPP in physical space
    g_final: np.ndarray         # (n_ls,) residual g at the MPP
    converged: np.ndarray       # (n_ls,) bool
    labels: List[str]           # limit-state labels ("stress e3", ...)
    variables: List[str]        # variable names, alpha column order
    # Series-system bounds: max p_f,i <= p_f <= min(1, sum p_f,i).
    system_pf_lower: float = float("nan")
    system_pf_upper: float = float("nan")
    alpha_correlation: Optional[np.ndarray] = None   # (n_ls, n_ls)
    # Ditlevsen second-order series bounds.
    system_pf_ditlevsen_lower: float = float("nan")
    system_pf_ditlevsen_upper: float = float("nan")
    n_iter: int = 0
    # SORM (Breitung) probabilities (None unless sorm=True).
    pf_sorm: Optional[np.ndarray] = None
    system_pf_sorm_lower: float = float("nan")
    system_pf_sorm_upper: float = float("nan")
    # Monte-Carlo cross-check (None unless run): series-system estimate.
    mc_pf: Optional[float] = None
    mc_std_error: Optional[float] = None
    mc_n: Optional[int] = None
    mc_pf_per_ls: Optional[np.ndarray] = None
    mc_method: Optional[str] = None      # "crude" | "importance"
    history: np.ndarray = field(
        default_factory=lambda: np.zeros(0))     # per-iteration max |g|


def _norm_cdf(x):
    x = np.asarray(x, dtype=float)
    return 0.5 * (1.0 + np.vectorize(lambda v: erf(v / sqrt(2.0)))(x))


def _parse_variables(variables, nelm: int):
    """Validate and normalize the variable specs: a list of dicts with
    name, kind, dist, a / b (x = a + b u normal, exp(a + b u) lognormal),
    mean and an (nelm,) float mask for the element-field kinds."""
    if not variables:
        raise ValueError("reliability needs at least one random "
                         "variable")
    out = []
    names = set()
    for spec in variables:
        if "field" in spec:
            raise ValueError('"field" variables (spatially correlated '
                             'random fields) are supported by the '
                             'reliability analysis only — expand or '
                             'drop the field spec here')
        name = spec.get("name")
        if not name or name in names:
            raise ValueError("every variable needs a unique name")
        names.add(name)
        kind = spec.get("kind")
        if kind not in _KINDS:
            raise ValueError(f"variable kind must be one of {_KINDS}, "
                             f"got {kind!r}")
        dist = spec.get("distribution", "lognormal"
                        if kind != "load_scale" else "normal")
        if dist not in _DISTS:
            raise ValueError(f"distribution must be one of {_DISTS}, "
                             f"got {dist!r}")
        mean = float(spec["mean"])
        if "std" in spec:
            std = float(spec["std"])
        elif "cov" in spec:
            std = float(spec["cov"]) * abs(mean)
        else:
            raise ValueError(f'variable "{name}" needs "std" or "cov"')
        if std <= 0.0:
            raise ValueError(f'variable "{name}" needs positive spread')
        if dist == "lognormal":
            if mean <= 0.0:
                raise ValueError(f'lognormal "{name}" needs a positive '
                                 f'mean')
            delta = std / mean
            zeta = float(np.sqrt(np.log1p(delta * delta)))
            lam = float(np.log(mean) - 0.5 * zeta * zeta)
            a, b = lam, zeta
        else:
            a, b = mean, std
        mask = None
        if kind in ("young", "area", "density"):
            m = np.zeros(nelm)
            elems = spec.get("elements")
            if elems is None:
                m[:] = 1.0
            else:
                idx = np.asarray(elems, dtype=int).reshape(-1)
                if idx.size == 0 or np.any(idx < 0) \
                        or np.any(idx >= nelm):
                    raise ValueError(f'variable "{name}": bad element '
                                     f'subset')
                m[idx] = 1.0
            mask = m
        out.append({"name": name, "kind": kind, "dist": dist,
                    "a": a, "b": b, "mask": mask, "mean": mean})
    return out


_PHI2_GAUSS: dict = {}     # cached Gauss-Legendre rules (per order)


def _phi2(a, b, rho, n_gauss: int = 64):
    """P(Z1 <= a, Z2 <= b) of the standard bivariate normal with
    correlation rho: Owen's single integral Phi(a) Phi(b) + int_0^rho
    phi2(a, b; r) dr by Gauss-Legendre on r; |rho| -> 1 analytically."""
    a = float(a)
    b = float(b)
    rho = float(rho)
    pa, pb = float(_norm_cdf(a)), float(_norm_cdf(b))
    if rho >= 1.0 - 1e-6:
        return min(pa, pb)
    if rho <= -1.0 + 1e-6:
        return max(0.0, pa + pb - 1.0)
    if abs(rho) < 1e-14:
        return pa * pb
    if n_gauss not in _PHI2_GAUSS:
        _PHI2_GAUSS[n_gauss] = np.polynomial.legendre.leggauss(n_gauss)
    x, w = _PHI2_GAUSS[n_gauss]
    r = 0.5 * rho * (x + 1.0)
    jac = 0.5 * rho
    one = 1.0 - r * r
    dens = np.exp(-(a * a - 2.0 * r * a * b + b * b) / (2.0 * one)) \
        / (2.0 * np.pi * np.sqrt(one))
    return pa * pb + float(jac * np.dot(w, dens))


def _ditlevsen_bounds(betas, alphas):
    """Second-order series-system bounds (Ditlevsen 1979) from the FORM
    pairwise joint probabilities Phi2(-b_i, -b_j; a_i . a_j), events in
    descending p_f; infinite-beta events drop out.  Returns (lo, hi)."""
    finite = np.isfinite(betas)
    bs = np.asarray(betas, dtype=float)[finite]
    al = np.asarray(alphas, dtype=float)[finite]
    if bs.size == 0:
        return 0.0, 0.0
    pf = _norm_cdf(-bs)
    order = np.argsort(-pf)
    bs, al, pf = bs[order], al[order], pf[order]
    n = bs.size
    if n == 1:
        return float(pf[0]), float(pf[0])
    pij = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            rho = float(np.clip(al[i] @ al[j], -1.0, 1.0))
            pij[i, j] = _phi2(-bs[i], -bs[j], rho)
    lo = pf[0]
    hi = pf[0]
    for i in range(1, n):
        lo += max(0.0, pf[i] - float(np.sum(pij[i, :i])))
        hi += pf[i] - float(np.max(pij[i, :i]))
    return float(min(lo, 1.0)), float(min(max(hi, lo), 1.0))


def _parse_variables_with_fields(variables, nelm: int, midpoints):
    """_parse_variables plus random-field expansion: a material variable
    with {"field": {"correlation_length": L}} becomes one variable per
    element (same marginal, one-hot mask) with rho(d) = exp(-d / L)
    between element midpoints (the midpoint method), through the same
    Nataf adjustment as user correlations.  Returns (varspecs, rz_base),
    rz_base the Gaussian-space correlation seeded with the field blocks
    (None without a field).  The JAX package fills the blocks pair by pair;
    here each block is one numpy expression of the same values."""
    if not variables:
        raise ValueError("reliability needs at least one random "
                         "variable")
    expanded = []
    field_groups = []            # (first_index, element_ids, L)
    for spec in variables:
        fld = spec.get("field")
        if fld is None:
            expanded.append(dict(spec))
            continue
        if spec.get("kind") not in ("young", "area", "density"):
            raise ValueError('"field" needs a material kind '
                             '(young / area / density)')
        ln = float(fld.get("correlation_length", 0.0))
        if ln <= 0.0:
            raise ValueError('"field" needs a positive '
                             '"correlation_length"')
        elems = spec.get("elements")
        ids = (np.arange(nelm) if elems is None
               else np.asarray(elems, dtype=int).reshape(-1))
        first = len(expanded)
        for e in ids:
            sub = {k: v for k, v in spec.items()
                   if k not in ("field", "elements", "name")}
            sub["name"] = f'{spec["name"]}#e{int(e)}'
            sub["elements"] = [int(e)]
            expanded.append(sub)
        field_groups.append((first, ids, ln))
    varspecs = _parse_variables(expanded, nelm)
    if not field_groups:
        return varspecs, None
    rz = np.eye(len(varspecs))
    mids = np.asarray(midpoints, dtype=float)
    for first, ids, ln in field_groups:
        k = ids.size
        if k < 2:
            continue
        pts = mids[ids]
        d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
        rho = np.exp(-d / ln)
        va = varspecs[first]
        bs = np.array([varspecs[first + a]["b"] for a in range(k)])
        if va["dist"] == "lognormal":
            delta = np.sqrt(np.expm1(bs ** 2))[:, None]
            r = np.log1p(rho * delta * delta) / (bs[:, None] * bs[None, :])
        else:
            r = rho
        upper = np.triu(np.ones((k, k), dtype=bool), 1)
        a_i, b_i = np.nonzero(upper)
        rz[first + a_i, first + b_i] = r[a_i, b_i]
        rz[first + b_i, first + a_i] = r[a_i, b_i]
    return varspecs, rz


def _physical(var, u):
    """x_v(u_v) of one variable (a tensor or a float)."""
    x = var["a"] + var["b"] * u
    if var["dist"] != "lognormal":
        return x
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def _nataf_cholesky(varspecs, correlation, rz_base=None):
    """Lower Cholesky factor of the Gaussian-space correlation matrix
    (Nataf / Gaussian copula) from pairwise physical-space correlations
    [[name_i, name_j, rho], ...], closed form for these marginals:
    normal-normal keeps rho, lognormal-lognormal ln(1 + rho d_i d_j) /
    (z_i z_j), normal-lognormal rho d / z.  None without a correlation."""
    if not correlation and rz_base is None:
        return None
    names = [v["name"] for v in varspecs]
    n = len(varspecs)
    rz = np.eye(n) if rz_base is None else np.asarray(rz_base,
                                                     dtype=float).copy()
    for entry in (correlation or ()):
        if len(entry) != 3:
            raise ValueError('correlation entries are '
                             '[name_i, name_j, rho]')
        na, nb, rho = entry
        if na not in names or nb not in names or na == nb:
            raise ValueError(f"bad correlation pair ({na!r}, {nb!r})")
        rho = float(rho)
        if not -1.0 < rho < 1.0:
            raise ValueError("correlation must be in (-1, 1)")
        i, j = names.index(na), names.index(nb)
        vi, vj = varspecs[i], varspecs[j]

        def delta(v):
            return float(np.sqrt(np.expm1(v["b"] ** 2)))

        if vi["dist"] == "normal" and vj["dist"] == "normal":
            r = rho
        elif vi["dist"] == "lognormal" and vj["dist"] == "lognormal":
            r = float(np.log1p(rho * delta(vi) * delta(vj))
                      / (vi["b"] * vj["b"]))
        else:
            ln = vi if vi["dist"] == "lognormal" else vj
            r = rho * delta(ln) / ln["b"]
        if not -1.0 < r < 1.0:
            raise ValueError(f"correlation ({na}, {nb}) = {rho} is "
                             f"infeasible for these marginals "
                             f"(Gaussian-space {r:.3f})")
        rz[i, j] = rz[j, i] = r
    try:
        return np.linalg.cholesky(rz)
    except np.linalg.LinAlgError:
        raise ValueError("correlation matrix is not positive definite")


class VariableMap:
    """The variables' transforms on a batch of standard-normal rows.

    physical(U): (B, n_vars) -> (B, n_vars) physical values (through the
    Nataf factor when there is one).  field(X, kind, base): the (B, nelm)
    per-element field of `kind`, each element taking the value of the last
    variable whose mask covers it, else `base`: the JAX package's
    sequential base (1 - m) + x m for 0 / 1 masks, gathered at once.
    load_scale(X): (B,) product of the load-scale variables."""

    def __init__(self, varspecs, chol, nelm: int, dtype, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype,
                                   device=device)

        self.a = t([v["a"] for v in varspecs])
        self.b = t([v["b"] for v in varspecs])
        self.is_log = torch.as_tensor(
            [v["dist"] == "lognormal" for v in varspecs], device=device)
        self.chol = None if chol is None else t(chol)
        self.owner = {}
        for kind in ("young", "area", "density", "thickness", "inertia"):
            own = np.full(nelm, -1, dtype=np.int64)
            for i, v in enumerate(varspecs):
                if v["kind"] == kind and v["mask"] is not None:
                    own[np.asarray(v["mask"]) > 0.0] = i
            if np.any(own >= 0):
                self.owner[kind] = (
                    torch.as_tensor(own >= 0, device=device),
                    torch.as_tensor(np.maximum(own, 0), device=device))
        self.scales = [i for i, v in enumerate(varspecs)
                       if v["kind"] == "load_scale"]

    def physical(self, u: torch.Tensor) -> torch.Tensor:
        z = u if self.chol is None else u @ self.chol.T
        lin = self.a + self.b * z
        return torch.where(self.is_log,
                           torch.exp(torch.where(self.is_log, lin, 0.0)),
                           lin)

    def field(self, x: torch.Tensor, kind: str,
              base: torch.Tensor) -> torch.Tensor:
        base = base.expand(x.shape[0], -1)
        if kind not in self.owner:
            return base
        covered, idx = self.owner[kind]
        return torch.where(covered, x[:, idx], base)

    def load_scale(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        for i in self.scales:
            scale = scale * x[:, i]
        return scale


def rowwise(single):
    """A batched ratios function from a one-row one: single(u (n_vars,))
    -> (n_ls,), evaluated row after row (the families' dense solves)."""
    def ratios_all(u: torch.Tensor) -> torch.Tensor:
        return torch.stack([single(row) for row in u])
    return ratios_all


def _hlrf(ratios_all, n_ls: int, n_vars: int, n_iter: int, dtype, dev):
    """The HL-RF fixpoint of every limit state at once, limit state i on
    row i: (beta, alpha, u*, g*, g(0), |g| history (n_ls, n_iter)) as
    float64 numpy copies, from one fetch."""
    rows = torch.arange(n_ls, device=dev)

    def g_and_grad(u):
        leaf = u.detach().requires_grad_()
        with torch.enable_grad():
            g = 1.0 - ratios_all(leaf)[rows, rows]
            dg, = torch.autograd.grad(torch.sum(g), leaf)
        return g.detach(), dg

    u = torch.zeros((n_ls, n_vars), dtype=dtype, device=dev)
    hist = []
    for _ in range(int(n_iter)):
        g, dg = g_and_grad(u)
        nrm2 = torch.clamp_min(torch.sum(dg * dg, dim=1), 1e-30)
        u = ((torch.sum(dg * u, dim=1) - g) / nrm2)[:, None] * dg
        hist.append(torch.abs(g))
    g_star, dg_star = g_and_grad(u)
    with torch.no_grad():
        g_mean = 1.0 - ratios_all(torch.zeros_like(u))[rows, rows]
    beta = torch.sign(g_mean) * torch.linalg.vector_norm(u, dim=1)
    nrm = torch.clamp_min(torch.linalg.vector_norm(dg_star, dim=1), 1e-30)
    alpha = -dg_star / nrm[:, None]
    hist = (torch.stack(hist) if hist
            else torch.zeros((0, n_ls), dtype=dtype, device=dev))
    out = torch.cat([beta[:, None], alpha, u, g_star[:, None],
                     g_mean[:, None], hist.T], dim=1).double().cpu()
    # np.array copies: the reset of unreachable rows writes in place.
    beta, alpha, u, g_star, g_mean, hist = (
        np.array(p.numpy(), dtype=float) for p in torch.split(
            out, [1, n_vars, n_vars, 1, 1, int(n_iter)], dim=1))
    return beta[:, 0], alpha, u, g_star[:, 0], g_mean[:, 0], hist


def _design_points(varspecs, chol, u_stars) -> np.ndarray:
    z_stars = u_stars if chol is None else u_stars @ chol.T
    xp = np.zeros(u_stars.shape)
    for j, v in enumerate(varspecs):
        x = v["a"] + v["b"] * z_stars[:, j]
        xp[:, j] = np.exp(x) if v["dist"] == "lognormal" else x
    return xp


def form_core(ratios_all, varspecs, chol, labels, n_iter: int = 50,
              tol: float = 1e-4, mc_samples: int = 0, mc_seed: int = 0,
              mesh=None, dtype=None, device=None):
    """Shared FORM driver over a batched demand / capacity `ratios_all`
    ((B, n_vars) -> (B, n_ls)): HL-RF on all limit states at once, the
    unreachable-surface reset (zero-demand limit states are beta = inf,
    p_f = 0, not beta = 0), physical design points through the Nataf
    factor, the simple and Ditlevsen bounds, optional crude Monte Carlo.
    Used by the frame and continuum families.  mesh= (a device mesh) is
    ROADMAP item 15's multi-device row and raises."""
    from ..parallel import refuse_mesh
    from ..utils.runtime import default_dtype

    refuse_mesh(mesh, "the Monte Carlo samples")
    dtype = dtype or default_dtype()
    dev = resolve_device(device)
    n_vars = len(varspecs)
    n_ls = len(labels)
    betas, alphas, u_stars, g_stars, g0s, _ = _hlrf(
        ratios_all, n_ls, n_vars, n_iter, dtype, dev)
    unreachable = (~np.isfinite(betas) | (np.abs(g_stars) >= tol)
                   | (np.abs(betas) < 1e-12)) & (g0s > 1.0 - 1e-3)
    betas[unreachable] = np.inf
    g_stars[unreachable] = 0.0
    alphas[unreachable] = 0.0
    u_stars[unreachable] = 0.0
    converged = ((np.abs(g_stars) < tol) & np.isfinite(betas)) \
        | unreachable
    pf = _norm_cdf(-betas)
    xp = _design_points(varspecs, chol, u_stars)
    dit_lo, dit_hi = _ditlevsen_bounds(betas, alphas)
    result = ReliabilityResult(
        beta=betas, pf=pf, alpha=alphas, design_point=xp,
        g_final=g_stars, converged=converged, labels=list(labels),
        variables=[v["name"] for v in varspecs],
        system_pf_lower=float(np.max(pf)),
        system_pf_upper=float(min(1.0, np.sum(pf))),
        system_pf_ditlevsen_lower=dit_lo,
        system_pf_ditlevsen_upper=dit_hi,
        alpha_correlation=alphas @ alphas.T, n_iter=n_iter)
    if mc_samples:
        result = _attach_monte_carlo(result, ratios_all, n_ls,
                                     int(mc_samples), int(mc_seed), 1024,
                                     dtype, n_vars, device=dev)
    return result


def _fatigue_limit_state(limit_state: Dict, var_names, varspecs):
    """The validated fatigue limit state: (spec dict, resistance index)."""
    fat_ls = limit_state.get("fatigue")
    if not fat_ls:
        raise ValueError('fatigue limit state needs a "fatigue" '
                         'spec {psd, omegas, damping, sn, method}')
    if limit_state.get("min_life_s") is None:
        raise ValueError('fatigue limit state needs "min_life_s"')
    f_life = float(limit_state["min_life_s"])
    if f_life <= 0.0:
        raise ValueError("min_life_s must be positive")
    sn = fat_ls.get("sn") or {}
    if sn.get("exponent") is None:
        raise ValueError('fatigue limit state needs "sn": '
                         '{"exponent": m, ...}')
    f_m = float(sn["exponent"])
    if f_m <= 0.0:
        raise ValueError("S-N exponent must be positive")
    res_var = None
    if limit_state.get("variable") is not None:
        rname = limit_state["variable"]
        if rname not in var_names:
            raise ValueError(f'limit-state resistance variable '
                             f'{rname!r} is not defined')
        res_var = var_names.index(rname)
        if varspecs[res_var]["kind"] != "resistance":
            raise ValueError(f'{rname!r} must have kind '
                             f'"resistance"')
    elif sn.get("coefficient") is None:
        raise ValueError('fatigue limit state needs '
                         'sn.coefficient or a resistance '
                         '"variable" playing the Basquin C')
    f_om = np.asarray(fat_ls.get("omegas", ()), dtype=float).reshape(-1)
    if f_om.size < 4 or np.any(np.diff(f_om) <= 0.0) or f_om[0] <= 0.0:
        raise ValueError('fatigue limit state needs an ascending '
                         'positive "omegas" sweep (>= 4 points)')
    f_psd = np.broadcast_to(np.asarray(fat_ls.get("psd", 1.0), dtype=float),
                            f_om.shape).copy()
    f_damp = fat_ls.get("damping", (0.0, 0.0))
    f_method = fat_ls.get("method", "dirlik")
    if f_method not in ("dirlik", "narrowband"):
        raise ValueError('fatigue method must be "dirlik" or '
                         '"narrowband"')
    return ({"life": f_life, "m": f_m, "om": f_om, "psd": f_psd,
             "damp": (float(f_damp[0]), float(f_damp[1])),
             "method": f_method,
             "coeff": (None if sn.get("coefficient") is None
                       else float(sn["coefficient"]))}, res_var)


def form_reliability(
    problem: TrussProblem,
    variables: List[Dict],
    limit_state: Dict,
    n_iter: int = 50,
    tol: float = 1e-4,
    mc_samples: int = 0,
    mc_seed: int = 0,
    mc_chunk: int = 1024,
    mc_method: str = "crude",
    sorm: bool = False,
    correlation=None,
    data=None,
    areas=None,
    mesh=None,
    device=None,
) -> ReliabilityResult:
    """FORM beta / p_f for every requested limit state (the JAX package's
    contract):

        limit_state: {"type": "stress", "limit": R | "variable": name,
                      "elements": [..]}          # default: all members
                   | {"type": "displacement", "limit": d,
                      "probe_dofs": [..]}
                   | {"type": "frequency", "min_frequency_hz": f}
                   | {"type": "fatigue", "min_life_s": T, "variable": C,
                      "fatigue": {psd, omegas, damping, sn, method},
                      "elements": [..]}

    mc_samples > 0 adds Monte Carlo (series system and per limit state),
    chunks of mc_chunk samples, each one batch of dense solves (padded
    with zero-weight rows); mc_method "importance" samples a Gaussian
    mixture on the dominant design points.  sorm=True adds Breitung's
    correction pf det(I + beta A)^(-1/2), A = T'HT / |grad g| with H the
    Hessian of g through the whole chain (torch.autograd.functional.
    hessian).  `areas` overrides the member areas (RBDO's final check).
    mesh= raises (ROADMAP item 15).  device: where to solve when `data` is
    not given ("cuda" when None)."""
    from ..ops.host import _geometry
    from ..parallel import refuse_mesh
    from .newton import DENSE_DOF_LIMIT
    from .sizing import _host_material, batched_response

    if problem.ndof > DENSE_DOF_LIMIT:
        raise ValueError(f"FORM traces the dense solve "
                         f"({problem.ndof} DOFs > {DENSE_DOF_LIMIT}); "
                         f"assess on a coarser model")
    refuse_mesh(mesh, "the Monte Carlo samples")
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    nelm = data.nelm
    midpoints = _geometry(problem)[3]
    varspecs, rz_base = _parse_variables_with_fields(
        variables, nelm, midpoints)
    n_vars = len(varspecs)
    var_names = [v["name"] for v in varspecs]

    young_np, area_np, rho_np = _host_material(problem)
    if areas is not None:
        area_np = np.broadcast_to(np.asarray(areas, dtype=float),
                                  (nelm,)).copy()

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype,
                               device=dev)

    base = {"young": t(young_np), "area": t(area_np),
            "density": t(rho_np)}
    chol = _nataf_cholesky(varspecs, correlation, rz_base=rz_base)
    vm = VariableMap(varspecs, chol, nelm, dtype, dev)

    ls_type = limit_state.get("type", "stress")
    res_var = None
    fat = None
    if ls_type == "stress":
        if limit_state.get("variable") is not None:
            rname = limit_state["variable"]
            if rname not in var_names:
                raise ValueError(f'limit-state resistance variable '
                                 f'{rname!r} is not defined')
            res_var = var_names.index(rname)
            if varspecs[res_var]["kind"] != "resistance":
                raise ValueError(f'{rname!r} must have kind '
                                 f'"resistance"')
        elif limit_state.get("limit") is None:
            raise ValueError('stress limit state needs "limit" or '
                             '"variable"')
        elems = limit_state.get("elements")
        ls_idx = (np.arange(nelm) if elems is None
                  else np.asarray(elems, dtype=int).reshape(-1))
        if np.any(ls_idx < 0) or np.any(ls_idx >= nelm):
            raise ValueError("limit-state elements out of range")
        labels = [f"stress e{int(e)}" for e in ls_idx]
    elif ls_type == "displacement":
        if limit_state.get("limit") is None:
            raise ValueError('displacement limit state needs "limit"')
        pd = limit_state.get("probe_dofs")
        if pd is None:
            raise ValueError("displacement limit state needs "
                             "probe_dofs")
        ls_idx = np.asarray(pd, dtype=int).reshape(-1)
        if np.any(ls_idx < 0) or np.any(ls_idx >= problem.ndof):
            raise ValueError("probe_dofs out of range")
        labels = [f"displacement dof{int(d)}" for d in ls_idx]
    elif ls_type == "fatigue":
        fat, res_var = _fatigue_limit_state(limit_state, var_names,
                                            varspecs)
        elems = limit_state.get("elements")
        ls_idx = (np.arange(nelm) if elems is None
                  else np.asarray(elems, dtype=int).reshape(-1))
        if np.any(ls_idx < 0) or np.any(ls_idx >= nelm):
            raise ValueError("limit-state elements out of range")
        labels = [f"fatigue e{int(e)}" for e in ls_idx]
    elif ls_type == "frequency":
        if limit_state.get("min_frequency_hz") is None:
            raise ValueError('frequency limit state needs '
                             '"min_frequency_hz"')
        f_req = float(limit_state["min_frequency_hz"])
        if f_req <= 0.0:
            raise ValueError("min_frequency_hz must be positive")
        lam_req = (2.0 * np.pi * f_req) ** 2
        ls_idx = np.zeros(1, dtype=int)
        labels = [f"frequency f1>={f_req:g}Hz"]
    else:
        raise ValueError('limit_state type must be "stress", '
                         '"displacement", "fatigue" or "frequency"')
    limit_c = (None if limit_state.get("limit") is None
               else float(limit_state["limit"]))
    n_ls = int(ls_idx.size)
    ls_d = torch.as_tensor(ls_idx, dtype=torch.int64, device=dev)

    def fields(u):
        """(x, young, area, density (B, nelm), load scale (B,))."""
        x = vm.physical(u)
        return (x, vm.field(x, "young", base["young"]),
                vm.field(x, "area", base["area"]),
                vm.field(x, "density", base["density"]), vm.load_scale(x))

    def capacity(x):
        if res_var is not None:
            return x[:, res_var][:, None]
        return torch.full((x.shape[0], 1), limit_c, dtype=dtype, device=dev)

    def ratios_all(u):
        """(B, n_ls) demand / capacity ratios, failure iff >= 1: the one
        definition behind g (FORM), the Monte Carlo indicator and the
        unreachable-surface test."""
        x, young, area, rho, scale = fields(u)
        if ls_type == "fatigue":
            from .sizing import fatigue_life_ratio, member_force_frf_sq

            om, psd = t(fat["om"]), t(fat["psd"])
            rows = []
            for k in range(u.shape[0]):
                h2 = member_force_frf_sq(data, young[k], area[k], rho[k],
                                         om, *fat["damp"])[:, ls_d]
                a_sel = area[k][ls_d]
                s_sigma = h2 * (psd * scale[k] * scale[k])[:, None] \
                    / (a_sel * a_sel)[None, :]
                c = (x[k, res_var] if res_var is not None
                     else torch.as_tensor(fat["coeff"], dtype=dtype,
                                          device=dev))
                rows.append(fatigue_life_ratio(om, s_sigma, fat["m"], c,
                                               fat["life"],
                                               method=fat["method"]))
            return torch.stack(rows)
        if ls_type == "frequency":
            from .modal_inverse import modal_observables_elem

            lam1 = torch.stack([modal_observables_elem(
                problem, young[k], area[k], rho[k], 1, data=data)[0][0]
                for k in range(u.shape[0])])
            return (lam_req / torch.clamp_min(lam1, 1e-30))[:, None]
        uu, sigma = batched_response(data, young, area,
                                     data.loads[None] * scale[:, None])
        if ls_type == "stress":
            return torch.abs(sigma)[:, ls_d] / capacity(x)
        return torch.abs(uu)[:, ls_d] / limit_c

    betas, alphas, u_stars, g_stars, g0s, hists = _hlrf(
        ratios_all, n_ls, n_vars, n_iter, dtype, dev)

    # Unreachable surfaces: a member the load never stresses has g ~ 1
    # everywhere and no zero crossing; the answer is beta = inf, p_f = 0.
    unreachable = (~np.isfinite(betas) | (np.abs(g_stars) >= tol)) \
        & (g0s > 1.0 - 1e-3)
    betas[unreachable] = np.inf
    g_stars[unreachable] = 0.0
    alphas[unreachable] = 0.0
    u_stars[unreachable] = 0.0      # design point = the mean (finite)
    xp = _design_points(varspecs, chol, u_stars)
    converged = ((np.abs(g_stars) < tol) & np.isfinite(betas)) \
        | unreachable
    pf = _norm_cdf(-betas)
    sys_lo = float(np.max(pf)) if n_ls else float("nan")
    sys_hi = float(min(1.0, np.sum(pf))) if n_ls else float("nan")
    dit_lo, dit_hi = _ditlevsen_bounds(betas, alphas) if n_ls \
        else (float("nan"), float("nan"))
    result = ReliabilityResult(
        beta=betas, pf=pf, alpha=alphas, design_point=xp,
        g_final=g_stars, converged=converged, labels=labels,
        variables=var_names, system_pf_lower=sys_lo,
        system_pf_upper=sys_hi, system_pf_ditlevsen_lower=dit_lo,
        system_pf_ditlevsen_upper=dit_hi,
        alpha_correlation=alphas @ alphas.T if n_ls else None,
        n_iter=n_iter,
        history=np.max(hists, axis=0) if n_ls else np.zeros(0))

    if sorm and n_ls:
        # Breitung: pf det(I + beta A)^(-1/2), A = T'HT / |grad g| at the
        # MPP, T an orthonormal tangent basis (QR completion of alpha).
        safe_u = np.where(np.isfinite(u_stars), u_stars, 0.0)
        eigs = []
        for i in range(n_ls):
            def g_one(u, i=i):
                return 1.0 - ratios_all(u[None])[0, i]

            u_i = t(safe_u[i])
            h = torch.autograd.functional.hessian(g_one, u_i)
            leaf = u_i.clone().requires_grad_()
            with torch.enable_grad():
                dg, = torch.autograd.grad(g_one(leaf), leaf)
            nrm = torch.clamp_min(torch.linalg.vector_norm(dg), 1e-30)
            q, _ = torch.linalg.qr((-dg / nrm)[:, None], mode="complete")
            t_basis = q[:, 1:]
            eigs.append(torch.linalg.eigvalsh(t_basis.T @ h @ t_basis
                                              / nrm))
        eigs = torch.stack(eigs).double().cpu().numpy()
        with np.errstate(invalid="ignore"):
            factors = 1.0 + betas[:, None] * eigs
        ok_rows = np.isfinite(betas) & np.all(factors > 0.01, axis=1)
        det_fac = np.where(ok_rows,
                           np.prod(np.where(ok_rows[:, None],
                                            np.maximum(factors, 0.01),
                                            1.0), axis=1) ** -0.5,
                           1.0)
        pf_sorm = np.where(np.isfinite(betas), pf * det_fac, 0.0)
        result.pf_sorm = pf_sorm
        result.system_pf_sorm_lower = float(np.max(pf_sorm))
        result.system_pf_sorm_upper = float(min(1.0, np.sum(pf_sorm)))

    if mc_samples and mc_samples > 0:
        if mc_method not in ("crude", "importance"):
            raise ValueError('mc_method must be "crude" or '
                             '"importance"')
        result = _attach_monte_carlo(result, ratios_all, n_ls,
                                     int(mc_samples), int(mc_seed),
                                     int(mc_chunk), dtype, n_vars,
                                     method=mc_method, betas=betas,
                                     u_stars=u_stars, device=dev)
    return result


def _attach_monte_carlo(result, ratios_all, n_ls, n_samples, seed, chunk,
                        dtype, n_vars, method="crude", betas=None,
                        u_stars=None, mesh=None, device=None):
    """Monte Carlo on the same demand / capacity ratios: each chunk of
    `chunk` samples is one call of the batched ratios (padded to the
    chunk with zero-weight rows) and one fetch of its failure table.

    method "crude": u ~ N(0, I), pf = mean(fail).  method "importance":
    an equal-weight Gaussian mixture on the dominant design points (finite
    beta <= beta_min + 2); the likelihood ratio phi(u) / q(u) on the host
    in float64 through a logsumexp.  mesh= raises (ROADMAP item 15)."""
    from ..parallel import refuse_mesh

    refuse_mesh(mesh, "the Monte Carlo samples")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = None
    if method == "importance":
        finite = np.isfinite(betas)
        if not np.any(finite):
            raise ValueError("importance sampling needs at least one "
                             "finite-beta limit state")
        bmin = float(np.min(betas[finite]))
        dom = finite & (betas <= bmin + 2.0)
        centers = np.asarray(u_stars[dom], dtype=float)   # (K, n)
    s_w_sys = s_w2_sys = 0.0
    s_w_ls = np.zeros(n_ls)
    s_w2_ls = np.zeros(n_ls)
    done = 0
    while done < n_samples:
        b = min(chunk, n_samples - done)
        if centers is None:
            u = rng.standard_normal((b, n_vars))
            w = np.ones(b)
        else:
            k = rng.integers(0, centers.shape[0], size=b)
            u = centers[k] + rng.standard_normal((b, n_vars))
            # w = phi(u) / q(u) = K / sum_k exp(u . c_k - |c_k|^2 / 2)
            lg = u @ centers.T - 0.5 * np.sum(centers ** 2, axis=1)
            m = np.max(lg, axis=1, keepdims=True)
            w = centers.shape[0] * np.exp(
                -(m[:, 0] + np.log(np.sum(np.exp(lg - m), axis=1))))
        if b < chunk:
            u = np.concatenate([u, np.zeros((chunk - b, n_vars))])
            w = np.concatenate([w, np.zeros(chunk - b)])
        with torch.no_grad():
            f = (ratios_all(torch.as_tensor(u, dtype=dtype, device=dev))
                 >= 1.0).cpu().numpy()
        wi_sys = w * np.any(f, axis=1)
        s_w_sys += float(np.sum(wi_sys))
        s_w2_sys += float(np.sum(wi_sys ** 2))
        wi_ls = w[:, None] * f
        s_w_ls += np.sum(wi_ls, axis=0)
        s_w2_ls += np.sum(wi_ls ** 2, axis=0)
        done += b
    pf_mc = s_w_sys / n_samples
    var = max(s_w2_sys / n_samples - pf_mc ** 2, 0.0)
    result.mc_pf = float(pf_mc)
    result.mc_std_error = float(np.sqrt(max(var, 1e-300) / n_samples))
    result.mc_n = n_samples
    result.mc_pf_per_ls = s_w_ls / n_samples
    result.mc_method = method
    return result


__all__ = ["ReliabilityResult", "form_core", "form_reliability",
           "VariableMap", "rowwise"]
