"""pinn_fem_tpu_torch: the PyTorch / CUDA port of pinn_fem_tpu.

The JAX package `pinn_fem_tpu` is the reference; this package computes the
same results with PyTorch, and runs the hot loops as hand-written CUDA
kernels on an NVIDIA Hopper card (ops/kernels/).  It never imports JAX.

Ported so far: truss documents through the JSON CLI (cli/generic.py) with
the Newton-Raphson method, on the dense path for small meshes and on the
banded (DIA) operator with the fused Jacobi-PCG kernels above 2048 DOFs;
PINN identification by gradient descent (methods gd and hybrid), whose
loss evaluates MLP material fields with the material kernels; and the
second-order methods full-nr with NN fields and gn, which differentiate
the torch form of the material twice and evaluate values with the
kernels.  Truss documents may carry thermal loads and prescribed support
displacements, and solve_nr takes Green-Lagrange kinematics on the dense
path.  The Node backend's JSON API entry points run too: the legacy
solvers (solvers/legacy.py), scalar (E, A) identification
(solvers/scalar_inverse.py) and their CLIs (cli/api_fem_solver.py,
cli/api_pinn_gd.py, cli/api_pinn_nr.py, cli/legacy_generic.py).  Meshes
whose numbering gives no banded layout take the gather-based PCG
(ops/cg.py), and RCM (ops/reorder.py) renumbers them; solve's
checkpoint_dir / resume write and read the JAX package's checkpoint files
(utils/checkpoint.py).  Truss dynamics run too: solve_transient (central
difference on the stencil kernel, Newmark on the fused PCG above the dense
limit), its checkpointed form, stable_dt, moving-load and base-excitation
loads, the mass matrices, and "transient" analysis documents through the
CLI.  Modal and linearized-buckling analyses (solvers/modal.py,
solvers/buckling.py) run dense in float64 and banded on the fused PCG,
through "modal" and "buckling" documents and solve_transient(method=
"modal").  The frequency-domain analyses run on them: harmonic response
(solvers/harmonic.py), random vibration (solvers/random_response.py) with
spectral and rainflow fatigue (solvers/fatigue.py), and response spectra
(solvers/spectrum.py), through "harmonic", "random" and "spectrum"
documents and a transient's "probe_elements" / "fatigue" keys.
Elastoplastic statics and explicit transients (solvers/plasticity.py over
ops/plastic.py), arc-length continuation (solvers/riks.py) and Guyan /
Craig-Bampton reduction (solvers/reduction.py) run through "plastic",
"continuation" and "reduction" documents and a transient's "plasticity"
key.  The plane-stress / plane-strain continuum family (models/plane.py,
ops/plane_plastic.py, solvers/plane_plasticity.py) runs through
"element_type": "plane" documents (io/plane_io.py): dense and banded
statics, modal, buckling, Newmark, harmonic, elastoplastic statics and
reduction.  ROADMAP.md lists what is still to port.

Float32 by default; PINN_FEM_TPU_X64=1 computes in float64 where no CUDA
kernel is on the path (utils/runtime.py).  TF32 is switched off for every
contraction, because rounded inputs break the symmetry the Cholesky and
PCG solves rely on.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import SolverConfig, SolverResult  # noqa: E402
from .models.fields import (  # noqa: E402
    Material,
    MLPField,
    ScalarField,
    make_mlp_field,
    material_from_numpy,
    to_field,
)
from .models.plane import (  # noqa: E402
    PlaneProblem,
    annulus_mesh,
    edge_load,
    plane_buckling,
    plane_harmonic,
    plane_matrices,
    plane_modal,
    plane_stable_dt,
    pressure_load,
    rect_mesh,
    solve_plane_static,
    solve_plane_transient,
)
from .models.problem import (  # noqa: E402
    ProblemData,
    TrussProblem,
    element_dofs,
    free_and_fixed_dofs,
    split_element_data,
)
from .ops.assembly import (  # noqa: E402
    assemble_system,
    compute_residual_and_jacobian,
    element_strain_stress,
    internal_force_and_strain,
)
from .ops.mass import consistent_mass, lumped_mass, total_mass  # noqa: E402
from .ops.thermal import thermal_free_strains, thermal_loads  # noqa: E402
from .solvers.buckling import (  # noqa: E402
    BucklingResult,
    buckling_analysis,
    buckling_eigenvalues,
)
from .solvers.driver import solve  # noqa: E402
from .solvers.dynamics import (  # noqa: E402
    TransientResult,
    base_excitation_force_fn,
    moving_load_force_fn,
    solve_transient,
    solve_transient_checkpointed,
    stable_dt,
)
from .solvers.fatigue import (  # noqa: E402
    SpectralFatigue,
    davenport_peak_factor,
    dirlik_damage_rate,
    first_passage_probability,
    narrowband_damage_rate,
    rainflow_cycles,
    rainflow_damage,
    spectral_fatigue,
    spectral_moments,
    synthesize_gaussian_history,
)
from .solvers.full_newton import solve_full_nr  # noqa: E402
from .solvers.gauss_newton import solve_gauss_newton  # noqa: E402
from .solvers.gd import solve_gd  # noqa: E402
from .solvers.harmonic import HarmonicResult, harmonic_response  # noqa: E402
from .solvers.hybrid import solve_hybrid  # noqa: E402
from .solvers.legacy import (  # noqa: E402
    LegacySolverConfig,
    PINNGradientDescentConfig,
    PINNSolverConfig,
    PINNSolverResult,
    solve_incremental_newton,
    solve_pinn_gradient_descent,
    solve_pinn_newton_raphson,
)
from .solvers.modal import (  # noqa: E402
    ModalResult,
    mac,
    modal_analysis,
    modal_eigenpairs,
    modal_eigenvalues,
    rayleigh_coefficients,
)
from .solvers.newton import solve_nr  # noqa: E402
from .solvers.plane_plasticity import (  # noqa: E402
    PlanePlasticResult,
    solve_plane_plastic,
)
from .solvers.plasticity import (  # noqa: E402
    PlasticStaticResult,
    PlasticTransientResult,
    solve_elastoplastic,
    solve_transient_plastic,
)
from .solvers.random_response import (  # noqa: E402
    RandomResponseResult,
    random_response,
)
from .solvers.reduction import (  # noqa: E402
    ReducedModel,
    craig_bampton,
    craig_bampton_dense,
    guyan_reduce,
    guyan_reduce_dense,
    reduce_loads,
    reduce_model,
)
from .solvers.riks import RiksResult, solve_riks  # noqa: E402
from .solvers.spectrum import (  # noqa: E402
    DirectionalSpectrumResult,
    SpectrumCurve,
    SpectrumResult,
    directional_combination,
    response_spectrum,
    spectrum_from_history,
)

__all__ = [
    "BucklingResult", "DirectionalSpectrumResult", "HarmonicResult",
    "LegacySolverConfig", "Material", "MLPField", "ModalResult",
    "PINNGradientDescentConfig", "PINNSolverConfig", "PINNSolverResult",
    "PlanePlasticResult", "PlaneProblem", "annulus_mesh", "edge_load",
    "plane_buckling", "plane_harmonic", "plane_matrices", "plane_modal",
    "plane_stable_dt", "pressure_load", "rect_mesh", "solve_plane_plastic",
    "solve_plane_static", "solve_plane_transient",
    "PlasticStaticResult", "PlasticTransientResult", "ProblemData",
    "RandomResponseResult", "ReducedModel", "RiksResult", "ScalarField",
    "SolverConfig", "SolverResult", "SpectralFatigue", "SpectrumCurve",
    "SpectrumResult", "TransientResult", "TrussProblem", "assemble_system",
    "base_excitation_force_fn", "buckling_analysis", "buckling_eigenvalues",
    "compute_residual_and_jacobian", "consistent_mass", "craig_bampton",
    "craig_bampton_dense", "davenport_peak_factor", "directional_combination",
    "dirlik_damage_rate", "element_dofs", "element_strain_stress",
    "first_passage_probability", "free_and_fixed_dofs", "guyan_reduce",
    "guyan_reduce_dense", "harmonic_response", "internal_force_and_strain",
    "lumped_mass", "mac", "make_mlp_field", "material_from_numpy",
    "modal_analysis", "modal_eigenpairs", "modal_eigenvalues",
    "moving_load_force_fn", "narrowband_damage_rate", "rainflow_cycles",
    "rainflow_damage", "random_response", "rayleigh_coefficients",
    "reduce_loads", "reduce_model", "response_spectrum", "solve",
    "solve_elastoplastic", "solve_full_nr", "solve_gauss_newton", "solve_gd",
    "solve_hybrid", "solve_incremental_newton", "solve_nr",
    "solve_pinn_gradient_descent", "solve_pinn_newton_raphson", "solve_riks",
    "solve_transient", "solve_transient_checkpointed",
    "solve_transient_plastic", "spectral_fatigue", "spectral_moments",
    "spectrum_from_history", "split_element_data", "stable_dt",
    "synthesize_gaussian_history", "thermal_free_strains", "thermal_loads",
    "to_field", "total_mass",
]
