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
reduction.  The 3D solid family (models/solid.py, ops/solid_plastic.py,
solvers/solid_plasticity.py) runs through "element_type": "solid"
documents (io/solid_io.py): the same analyses, with banded statics, modal
and explicit transients on the stencil and PCG kernels; both continuum
families run explicit elastoplastic transients
(solvers/continuum_transient_plastic.py).  The 2D and 3D frame families
(models/frame.py, models/frame3d.py, solvers/frame_plastic.py) run through
"element_type": "frame" and "frame3d" documents (io/frame_io.py,
io/frame3d_io.py): dense statics, modal, buckling, Newmark, harmonic,
reduction and the plastic-hinge pushover, with banded statics and modal on
the stencil and PCG kernels.  The Mindlin plate family (models/plate.py,
ops/plate_plastic.py, solvers/plate_plasticity.py) runs through
"element_type": "plate" documents (io/plate_io.py): dense statics, modal
with membrane prestress, buckling, Newmark, harmonic, layered
elastoplastic statics and reduction, with banded statics on the stencil
and PCG kernels.  The flat-facet shell family (models/shell.py,
ops/shell_plastic.py, solvers/shell_plasticity.py,
solvers/shell_nonlinear.py) runs through "element_type": "shell"
documents (io/shell_io.py): dense statics, modal, buckling, Newmark,
harmonic, layered elastoplastic statics, reduction, the Marguerre Newton
and arc length, with banded statics and the banded Marguerre Newton on
the stencil and PCG kernels.  Response spectra, random vibration and
spectral fatigue of the plane, solid, frame, space-frame, plate and shell
families (solvers/continuum_spectrum.py) run through their "spectrum" and
"random" documents.  Identification runs through "identification"
documents: the truss time-domain, modal and FRF fits
(solvers/transient_inverse.py, modal_inverse.py, frequency_inverse.py)
and the plane, solid, plate, shell and frame families' Young / inertia
fits, large meshes on the banded adjoint (solvers/banded_inverse.py over
ops/dia.dia_solve_diff: two fused PCGs an ADAM iteration on a card).
Sizing and reliability run through "sizing" and "reliability" documents
of every family that has them: truss areas by ADAM (the augmented
Lagrangian on the dense differentiable solve), the fully stressed design
and, past the dense limit, optimality criteria on the banded operator
(solvers/sizing.py: one fused PCG an iteration on a card); FORM / SORM
with Nataf correlation, random fields and Monte Carlo
(solvers/reliability.py); frame inertia sizing, RBDO and reliability
(models/frame.py); continuum thickness sizing and reliability
(solvers/continuum_sizing.py, continuum_reliability.py).  ROADMAP.md lists
what is still to port.

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
from .models.frame import (  # noqa: E402
    FrameProblem,
    frame_buckling,
    frame_geometric_stiffness,
    frame_harmonic,
    frame_matrices,
    frame_modal,
    frame_modal_banded,
    frame_reliability,
    frame_static_response,
    identify_frame_properties,
    optimize_frame_inertia,
    optimize_frame_inertia_rbdo,
    solve_frame_static,
    solve_frame_static_banded,
    solve_frame_transient,
)
from .models.frame3d import (  # noqa: E402
    SpaceFrameProblem,
    solve_space_frame_static,
    solve_space_frame_transient,
    space_frame_harmonic,
    space_frame_matrices,
    space_frame_modal,
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
    plane_static_response,
    solve_plane_static,
    solve_plane_transient,
)
from .models.solid import (  # noqa: E402
    SolidProblem,
    box_mesh,
    extrude_mesh,
    identify_solid_young_banded,
    solid_buckling,
    solid_harmonic,
    solid_matrices,
    solid_modal,
    solid_modal_banded,
    solid_stable_dt,
    solid_static_response,
    solve_solid_static,
    solve_solid_static_banded,
    solve_solid_transient,
    solve_solid_transient_banded,
    surface_load,
)
from .models.plate import (  # noqa: E402
    PlateProblem,
    identify_plate_young,
    identify_plate_young_banded,
    mindlin_navier_w,
    mindlin_ss_buckling_nx,
    plate_buckling,
    plate_geometric_stiffness,
    plate_harmonic,
    plate_matrices,
    plate_modal,
    plate_supports,
    plate_static_response,
    recover_moments,
    solve_plate_static,
    solve_plate_static_banded,
    solve_plate_transient,
)
from .models.shell import (  # noqa: E402
    ShellProblem,
    arch_strip_mesh,
    cylinder_panel_mesh,
    hemisphere_mesh,
    shell_buckling,
    shell_geometric_stiffness,
    shell_harmonic,
    shell_matrices,
    shell_modal,
    shell_static_response,
    solve_shell_static,
    solve_shell_transient,
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
from .solvers.continuum_spectrum import (  # noqa: E402
    ContinuumFatigueResult,
    ContinuumRandomResult,
    ContinuumSpectrumResult,
    continuum_random_response,
    continuum_response_spectrum,
    continuum_spectral_fatigue,
    continuum_stress_frf,
    frame_fiber_stress_frf,
    shell_fiber_stress_frf,
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
from .solvers.frame_plastic import (  # noqa: E402
    FramePushoverResult,
    frame_pushover,
)
from .solvers.frequency_inverse import (  # noqa: E402
    frf_probe_amplitudes,
    identify_from_frf,
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
from .solvers.modal_inverse import (  # noqa: E402
    identify_field_from_modal,
    identify_from_modal,
    modal_observables,
)
from .solvers.newton import solve_nr  # noqa: E402
from .solvers.continuum_transient_plastic import (  # noqa: E402
    ContinuumPlasticTransientResult,
    solve_plane_transient_plastic,
    solve_solid_transient_plastic,
)
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
from .solvers.plate_plasticity import (  # noqa: E402
    PlatePlasticResult,
    solve_plate_plastic,
)
from .solvers.shell_plasticity import (  # noqa: E402
    ShellPlasticResult,
    solve_shell_plastic,
)
from .solvers.shell_nonlinear import (  # noqa: E402
    ShellNonlinearResult,
    marguerre_energy,
    solve_shell_nonlinear,
    solve_shell_nonlinear_banded,
    solve_shell_riks,
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
from .solvers.solid_plasticity import (  # noqa: E402
    SolidPlasticResult,
    solve_solid_plastic,
)
from .solvers.transient_inverse import (  # noqa: E402
    identify_field_from_transient,
    identify_from_transient,
    transient_probe_response,
)
from .solvers.reliability import (  # noqa: E402
    ReliabilityResult,
    form_reliability,
)
from .solvers.sizing import (  # noqa: E402
    SizingResult,
    fatigue_life_ratio,
    fully_stressed_design,
    member_force_frf_sq,
    optimize_compliance_oc,
    optimize_sizing,
    static_response_elem,
)
from .solvers.continuum_reliability import continuum_reliability  # noqa: E402
from .solvers.continuum_sizing import (  # noqa: E402
    optimize_plane_thickness,
    optimize_plate_thickness,
    optimize_shell_thickness,
)
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
    "ContinuumPlasticTransientResult", "SolidPlasticResult", "SolidProblem",
    "box_mesh", "extrude_mesh", "solid_buckling", "solid_harmonic",
    "solid_matrices", "solid_modal", "solid_modal_banded", "solid_stable_dt",
    "solve_plane_transient_plastic", "solve_solid_plastic",
    "solve_solid_static", "solve_solid_static_banded",
    "solve_solid_transient", "solve_solid_transient_banded",
    "solve_solid_transient_plastic", "surface_load",
    "FrameProblem", "FramePushoverResult", "frame_buckling",
    "frame_geometric_stiffness", "frame_harmonic", "frame_matrices",
    "frame_modal", "frame_modal_banded", "frame_pushover",
    "solve_frame_static", "solve_frame_static_banded",
    "solve_frame_transient",
    "SpaceFrameProblem", "solve_space_frame_static",
    "solve_space_frame_transient", "space_frame_harmonic",
    "space_frame_matrices", "space_frame_modal",
    "PlatePlasticResult", "PlateProblem", "mindlin_navier_w",
    "mindlin_ss_buckling_nx", "plate_buckling", "plate_geometric_stiffness",
    "plate_harmonic", "plate_matrices", "plate_modal", "plate_supports",
    "recover_moments", "solve_plate_plastic", "solve_plate_static",
    "solve_plate_static_banded", "solve_plate_transient",
    "ShellProblem", "arch_strip_mesh", "cylinder_panel_mesh",
    "hemisphere_mesh", "shell_buckling", "shell_geometric_stiffness",
    "shell_harmonic", "shell_matrices", "shell_modal", "solve_shell_static",
    "solve_shell_transient", "ShellPlasticResult", "solve_shell_plastic",
    "ShellNonlinearResult", "marguerre_energy", "solve_shell_nonlinear",
    "solve_shell_nonlinear_banded", "solve_shell_riks",
    "ContinuumFatigueResult", "ContinuumRandomResult",
    "ContinuumSpectrumResult", "continuum_random_response",
    "continuum_response_spectrum", "continuum_spectral_fatigue",
    "continuum_stress_frf", "frame_fiber_stress_frf",
    "shell_fiber_stress_frf",
    "identify_from_transient", "identify_field_from_transient",
    "transient_probe_response", "identify_from_modal",
    "identify_field_from_modal", "modal_observables", "identify_from_frf",
    "frf_probe_amplitudes", "identify_frame_properties",
    "identify_plate_young", "identify_plate_young_banded",
    "identify_solid_young_banded",
    "ReliabilityResult", "SizingResult", "continuum_reliability",
    "fatigue_life_ratio", "form_reliability", "frame_reliability",
    "frame_static_response", "fully_stressed_design", "member_force_frf_sq",
    "optimize_compliance_oc", "optimize_frame_inertia",
    "optimize_frame_inertia_rbdo", "optimize_plane_thickness",
    "optimize_plate_thickness", "optimize_shell_thickness",
    "optimize_sizing", "plane_static_response", "plate_static_response",
    "shell_static_response", "solid_static_response",
    "static_response_elem",
]
