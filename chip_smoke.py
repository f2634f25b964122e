#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failed check raises, so the exit
code is not 0 and no result line is printed:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from pinn_fem_tpu_torch/ops/kernels/csrc;
  3. each kernel against its plain PyTorch twin on the card: the stencil
     on the 2,000,002-DOF chain and the 40,000-DOF grid (staged window,
     bit-equal, and on a misaligned view of u), and on a 63-diagonal band
     too wide for shared memory (the kernel's unstaged path, bit-equal);
     the two PCG kernels for one step, both bit-equal to their twins (the
     direction kernel also on misaligned views and on the wide band's
     unstaged path, with its plan logged; the update with its device
     state); the fused PCG against its twin recurrence on the grid, and
     300 PCG iterations at tol = 0 on the chain (ms per iteration for
     both); a torch.profiler window of 64 fused PCG iterations on the grid
     and on the chain (device kernels per iteration, busy and idle share,
     device us per launch of each banded kernel), and the direction
     kernel's plan, ms, device us and share of its bound at both sizes;
  4. the Newton main path: the 100 x 200 cross-braced grid document
     (40,000 DOFs, 79,102 elements, tol 1e-5, 2 load increments) through
     pinn_fem_tpu_torch.cli.generic.main on cuda, checked against a
     float64 scipy solve, with the banded kernels' launch counts from that
     run;
  5. corpus example1 on cuda (the dense path);
  6. kernel 4, the material fields' forward and backward kernels, against
     their twin (the twin's autograd for the backward) at the grid's 79,102
     midpoints and on a 1,000,000-element chain, with 1 and 2 hidden
     layers and load factors 0.3 and 1.0; the forward also bit for bit
     against a second call, with its plan, registers and local bytes
     logged; the backward (4b) also against
     its plain version (material_coefficients_backward_reference), bit
     for bit against a second call, and with gs alone (the GD path: the
     density block exactly zero); ms of kernel, plain version, twin and
     torch form (each field's eval_batch and the product), the s-only
     call's ms beside its own bound, host us per wrapper call, and a
     profile: device us per launch of both kernels, one device kernel per
     call;
  7. the GD main path: the grid as a PINN document (three MLP fields,
     pinn_grid_document) through main() on cuda for GD_ITERS iterations,
     with both material kernels' launch counts from that run, ms per GD
     iteration, a profile of GD iterations, and the first CPU_ROWS history
     rows against a CPU run of the same document (the twin);
  8. corpus example2 (scalar GD) and example7-P (hybrid, three NN fields,
     initial weights as the JAX CLI draws them) on cuda;
  9. the second-order methods through main() on cuda: corpus example9
     and example10 (full-nr with NN fields; converged, ||(f_int - f)_free||
     < 1e-5 at the identified material on the card, each increment's
     history length); gn on copies of example3 and example7 (max_iterations
     100; u within 2e-4 L of [1, 2, 3]); kernel 4 takes every value-only
     evaluation (its launches equal the phases' flag reads plus the
     reactions, > 0 on example10 and example7), kernel 4b none; and the
     16 x 32 PINN grid as a full-nr document (n_z 1,990; 1,906 elements),
     FNR_GRID_ITERS iterations: ms per iteration split into loss,
     gradient and Hessian (one torch.func call) and LM tries, host syncs
     per iteration, the device's idle share (torch.profiler over
     FNR_SPLIT_ITERS iterations), the peak memory, the loss falling at
     every accepted step, finite rows, and the first FNR_CPU_ROWS rows
     against a CPU run of the same document (the twin);
 10. thermal loads, support settlement and Green-Lagrange Newton: the
     100 x 200 grid as a thermal document (a per-node temperature
     gradient, alpha dT up to 0.5 against load strains of about 1; tol
     1e-5, 2 increments), as a settlement document (the right edge's
     x-DOFs settled 0.01, -1e-2 on each top-row node's y-DOF) and as a
     settlement-only document, each through main() on cuda twice (ms warm,
     Newton and PCG iterations, kernels 1-3's launches with one update per
     direction pass): thermal converged, its float64 residual with f + f_th
     <= sqrt(tol) and u within 1e-3 of float64; settlement converged, u
     within 1e-3 of a float64 solve of K_ff u_f = f_f - K_fp u_p, the
     settled values kept and their reactions within 1e-3 of float64
     K u - f; settlement only converged: false, as the JAX package gives
     (ROADMAP fault 3.9), with u within 1e-3 of float64; and
     solve_nr(geometric_nonlinear=True) on the 32 x 32 grid (2,048 DOFs,
     the dense limit) with strains of 10-40 %: its float64 Green-Lagrange
     equilibrium residual, its distance from the linear solve, ms per
     Newton iteration, and the singular tangent's RuntimeError on the card;
 11. the Node backend's JSON API entry points on cuda: (a) the legacy
     PINN GD (solve_pinn_gradient_descent) on the 100 x 200 PINN grid for
     LEGACY_GD_ITERS iterations, kernels 4 and 4b once an iteration, the
     loss falling, ms an iteration, the device's idle share over 20
     iterations, the first LEGACY_CPU_ROWS rows against the CPU twin;
     (b) api_fem_solver.main on the 32 x 32 grid (10 increments, u and
     strains within 1e-3 of float64) and solve_incremental_newton with
     three frozen MLP fields (kernel 4 once per assembly, u against the
     CPU twin); (c) api_pinn_nr and api_pinn_gd through main() (E A
     within 1e-3; without measurements exit 1) and identify_scalars_gd's
     ms an iteration on the 40k grid; (d) legacy_generic.main on the
     legacy web NN payload (a timestamped log, u within 1e-2, kernel 4
     not launched: input_dim 1); (e) PINN_FEM_TPU_X64=1: example1 in
     float64 on the card, the 40k grid document refused (exit 1);
 12. meshes without a banded layout, RCM, and checkpoint / resume: (a)
     the 100 x 200 grid document with its nodes renumbered by a seeded
     permutation (shuffled_document) through main() on cuda: no banded
     layout, so the gather-based PCG (ops/cg.py, torch ops); converged, u
     mapped back within 1e-3 of float64, no repo kernel launched, Newton
     and PCG iterations beside phase 4's, ms warm, ms per PCG iteration
     and the device's idle share over 64 PCG iterations; (b) RCM
     (reorder_problem) on that mesh: its host time, the implementation
     (native library or numpy), its band against the 192-diagonal budget,
     and its solve_nr with u mapped back (within 1e-3 of float64 and 1e-4
     of (a)); then the shuffled 20 x 60 grid, which RCM puts back on the
     banded operator: kernels 1-3 launched, u within 1e-3 of float64 and
     1e-4 of its gather solve; (c) the gather and banded Newton cores on
     one ProblemData of the natural 100 x 200 grid (Newton counts within
     one, u within 1e-4, one gather K u within 1e-6 of kernel 1's); (d)
     checkpoint / resume on cuda: the grid's nr run writes state.msgpack,
     the driver's state after increment 1 resumed gives the uninterrupted
     u within 1e-5 with kernels 1-3 for the re-run increment only (the
     state written as half of the final u, as tests/test_aux.py does,
     within 1e-3), and the PINN grid's GD run of 2 increments saves theta,
     which loads back on the card bit for bit and resumes;
 13. truss dynamics: (a) the 100 x 200 grid as a transient document
     (central, dt "auto", damping [0.05, 0], a step load, 2,000 steps
     recorded every 20) through main() on cuda twice (cold and warm ms):
     kernel 1 launched exactly 1 + n + 2n/r times and no other kernel,
     the history within 1e-3 of the float64 transcription
     (examples_grid.float64_transient) and its first 200 steps within
     1e-5 of the CPU twin, ms a step and the device's idle share over
     200 profiled steps; (b) the 2,000,002-DOF chain at bench.py's
     setting (dt = stable_dt, one record, one probe, fetch_state=False):
     ms a step by (t(4000) - t(400)) / 3600, medians of 3, the idle share
     over 200 steps, kernel 1's n + 3 launches, and tests/
     test_dynamics.py's wave-front check after a 10-step pulse; (c)
     Newmark on the grid through main() at 10x its stable step (damping
     [0.05, 1e-3], 200 steps): kernels 2 and 3 once each per PCG round,
     PCG iterations and flag reads a step, ms a step, u within 2e-3 of
     the CPU twin (20 steps) and 1e-3 of a float64 Newmark (one sparse
     LU); (d) "prestress": true (the banded static Newton on kernels
     1-3) and a moving load across the top row through main(), then the
     same transient from the card's prestress state within 1e-4 of the
     CPU twin; (e) (a)'s document with a checkpoint every 500 steps: the
     records within 1e-6 of (a)'s, a run stopped at 1,000 steps resumed
     to (a)'s tail, transient.npz read by numpy; (f) Green-Lagrange
     central and Newmark on the 32 x 32 grid (dense) against the CPU
     twin, ms a step; and PINN_FEM_TPU_X64=1: a banded transient on the
     card refused;
 14. the banded multigrid (ops/mg.py): (a) solve_nr(linear_solver=
     "cg-dia") on the 100 x 200 grid with cg_precond "mg" and "jacobi":
     both converged and within 1e-3 of float64, the MG levels (ndof,
     diagonals, bandwidth), Newton and PCG iterations, ms per hierarchy
     build and per MG-PCG iteration, warm wall, the idle share, and kernel
     1 launched exactly sum over solves of (1 + V)(1 + iterations) plus
     2 a Newton iteration and 1 (V the level matvecs of a cycle); (b) the
     PCG alone on that operator at tol 1e-6: MG iterations x 8 < Jacobi's,
     both walls, the MG loop's idle share; (c) the V-cycle on kernel 1
     within 1e-6 of the plain cycle (v_cycle_reference), and kernel 1
     bit-equal to its twin at every level's shape, its ms, device us and
     plain ms beside its byte bound; (d) the guided strip (2 x length
     nodes numbered along its length) at lengths 2,000 (MG reaches tol:
     gated) and 10,000 (MG capped, not gated: ROADMAP fault 3.14): Jacobi
     and MG counts, walls, true residuals and x against float64; (e) the
     707 x 1414 grid (1,999,396 DOFs): levels, build time, MG and Jacobi
     PCG each capped by an iteration budget (the item near 30 s), where
     each stops, not gated (MG breaks down there: fault 3.15); (f) float64
     CUDA operands on the MG path (dia_cg_solve, solve_nr) refused with the
     ValueError naming PINN_FEM_TPU_X64 and kernel 1;
 15. batched solving (parallel/batched.py): (a) kernels 4 and 4b with a
     member axis at the PINN grid's 79,102 midpoints, B = 1, 8 and 32
     members of their own weights and load factors: one launch each for
     all members, each member's forward bit-equal to the one-member kernel
     and within the twin's bounds, its gradient within 1e-5 of max|grad|
     of the one-member kernel and of the plain batched version, bit for
     bit across two calls, B = 1 bit-equal to the one-member launch; ms,
     device us, B one-member launches' ms and the bound at B; (b)
     solve_gd_batched on the 40k PINN grid, 8 members at load scales
     0.5-2.0 (their float64 fields), 200 iterations: one launch of kernel
     4 and one of 4b an iteration for all members (and kernel 4 once for
     the reactions), ms an iteration and the idle share for 8 members and
     for one, beside phase 7's GD, every member's loss falling, member 3
     against a batch of member 3 alone; (c) solve_nr_batched on the 32 x
     32 grid: 256 load scales on one factorization (problems/s, all
     converged, three rows within 1e-3 of float64) and 16 distinct load
     factors (per-member tangents); (d) solve_gd_batched_incremental, 16
     members of the 8 x 16 PINN grid, 2 increments: converged and
     total_iterations per member, two members against driver.solve; (e)
     the 32 x 64 grid as an ensemble document (64 seeded amplitude
     histories, 2,048 central steps recorded every 32 at 4 probe DOFs)
     through main(): ms a step, the idle share, two rows within 1e-5 of
     the unbatched solve_transient, the envelope; a Green-Lagrange
     ensemble (16 members, 32 x 32) against the unbatched run; an
     include_stress_envelope document; (f) cli.api_batch: nr and gd
     payloads exit 0 with the four keys, an unresolvable measured_batch
     exits 1 with {error, type}; (g) float64 CUDA operands at the batched
     material dispatch refused with the ValueError naming PINN_FEM_TPU_X64
     and kernels 4 and 4b, and mesh= refused;
 16. modal and buckling analyses: (a) dyn-modal.json and dyn-buckling.json
     through main() on cuda (the dense float64 path, torch on the card),
     each within 1e-10 of the port's CPU run of the document (|shapes|
     within 1e-8), no repo kernel; (b) modal_analysis of the 100 x 200
     grid at the JAX defaults (6 modes, lumped, n_iter 25, cg_tol 1e-8):
     16 block columns, one fused PCG each a subspace iteration, kernel 1
     exactly 25 x 16 + 6 times and kernels 2 and 3 each the sum over the
     solves of 32 ceil(iterations / 32), the PCG iterations (sum, largest
     and smallest column, stalls at max_iter), wall, residuals, ok and the
     Ritz change, the eigenvalues within 1e-2 of scipy's float64
     shift-invert eigsh, and the last block solve bit-equal to the twin
     recurrence (fused_cg_solve_reference) on the card; (c)
     buckling_analysis of a 32 x 36 cross-braced strip in compression
     (2,304 DOFs, above the dense limit; kappa(K_ff) computed in float64
     and logged, eps32 kappa <= 1e-2): kernel 1 exactly 4 x 30 x 8 times,
     kernels 2 and 3 as in (b), load factors within max(1e-3, 10 eps32
     kappa) of scipy's dense float64 eigh, a block solve bit-equal to the
     twin; (d) solve_transient(method="modal", 6 modes) on the 100 x 200
     grid under a load in the span of its three lowest float64 modes,
     2,000 steps at the central step, against method="central": u within
     2e-3 of max |u| and KE within 1e-2 of its max (tests/test_dynamics.py
     :380), ms a step of the modal integration (no repo kernel) and its
     idle share; (e) float64 CUDA operands on the banded modal and
     buckling paths refused with the ValueError naming PINN_FEM_TPU_X64
     and kernels 1-3;
 17. frequency-domain analyses: (a) dyn-harmonic, dyn-random, dyn-fatigue
     and dyn-spectrum.json through main() on cuda (the dense float64
     tiers, no repo kernel), each within 1e-10 of the port's CPU run; on
     the 100 x 200 grid, against a float64 reference of scipy eigsh's 12
     lowest modes computed once: (b) a "harmonic" document, method
     "modal" with 12 modes (28 block columns), Rayleigh zeta 0.05 on
     modes 1 and 12, 200 frequencies, 4 probe nodes and 8 probe elements:
     kernel 1 exactly 25 x 28 + 12 times, kernels 2 and 3 each the sum
     of 32 ceil(iterations / 32), amplitudes and member forces within
     2e-2 of each probe's peak and the truncation residual within 1e-3 of
     the float64 superposition, TF32 off, the wall split into modal solve
     and sweep; (c) a "random" document (6 modes, white noise, a Dirlik
     fatigue block, m = 3, and a first-passage block): launches as in
     16(b), rms within 2e-2 and damage rates within 6e-2 of float64; (d)
     "spectrum" documents with 4 modes on the grid turned on its side
     (200 x 100, 40,000 DOFs: the 100 x 200 strip is refused by the
     mechanism guard of the JAX contract), CQC on a tabulated Sa, then
     SRSS and a history Sa on the same modes: kernel 1 exactly 25 x 12 +
     4 times, peaks and member forces within 1e-2 of their max and the
     mass fraction within 1e-3 of the float64 combination of eigsh's 4
     modes; (e) the direct
     float32 sweep of the 32 x 32 grid (2,048 DOFs, 120 frequencies, 4
     chunks of 32 block systems of 4,096 x 4,096): each residual within a
     factor 2 (or 1e-6) of its float64 recomputation from the returned
     X, unflagged points within 1e-2 of the float64 dense tier, ms a
     frequency; (f) a 2,000-step central transient of the grid under a
     sine load recording 8 members every step with a rainflow fatigue
     block: kernel 1 exactly
     1 + n + 2n times, forces within 1e-6 of a float64 recovery from the
     recorded element DOFs, damage equal to rainflow_damage on them, u
     within 2e-3 of the CPU twin; (g) float64 CUDA operands on the banded
     modal sweep refused (the ValueError naming PINN_FEM_TPU_X64 and
     kernels 1-3), mesh= refused (item 15);
 18. elastoplasticity, continuation and reduction: (a) dyn-plastic,
     dyn-continuation and dyn-reduction.json through main() on cuda (the
     dense float64 tiers, no repo kernel), each within 1e-10 of the
     port's CPU run (Craig-Bampton's modal rows and columns of k_red and
     m_red aligned in sign first; relative errors and residual norms by
     their absolute difference); (b) solve_elastoplastic on the 40 x 80
     grid (6,400 DOFs: the float32 dense device tier, one float32 LU a
     Newton iteration), isotropic and kinematic hardening, 0 -> 1 -> -1
     -> 0 in 32 steps, against the same history in float64 on the card:
     every step converged, u within 1e-3 of max |u_f64| at every step, the
     yielded sets equal but for members within 1e-4 of the yield surface
     in the float64 state; ms a Newton iteration, the LU's share,
     iterations a step, peak memory; (c) solve_transient_plastic on the
     100 x 200 grid (banded), central, 2,000 steps under a trapezoid load
     that yields and unloads part of the grid: with beta != 0 kernel 1
     exactly once a step (K0 v) and its plain version never, probe u
     within 2e-3 of max |u| from a float64 replay of the recurrence on
     the card (K0 v by kernel 1's plain version in float64), with beta =
     0 no launch and |KE + SE + W_p - W_ext| within 2e-2 of max |W_ext|
     at every record; ms a step and the idle share with and without
     beta; (d) solve_riks on a 6,000-DOF shallow two-chord arch through
     its first limit point on the float32 device tier (tol 3e-5: float32
     meets no corrector test near 1e-8 there) against the same path in
     float64 on the card: the limit load within 1e-3, lambda falling
     after its maximum, one LU a corrector iteration, ms an iteration;
     (e) a Craig-Bampton document of the 500-story tower (2,004 DOFs, the
     top two nodes as masters, 8 modes, compare_full) through main():
     reduced omegas within 1e-10 of scipy in float64, the wall time; (f)
     reduction above the dense limit (a truss and a shell) and with
     data=, each compose key of the transient
     "plasticity" spec, and a float64 CUDA operand at (c)'s kernel 1
     dispatch (the ValueError naming PINN_FEM_TPU_X64 and kernel 1),
     each refused before any launch;
 19. the plane continuum family: (a) dyn-plane (modal) and
     dyn-plane-plastic (the thick-wall cylinder) through main() on the
     card, within 1e-10 of the port's CPU runs (mode shapes
     sign-aligned), no repo kernel; (b) the JAX package's banded plane
     benchmark strip at full width (128 x 512 Q4s, 132,354 DOFs, 21
     diagonals): kernels 1-3 on its operator against their plain
     versions (plans, ms, bounds, CSR K u), then solve_plane_static_banded
     (tol 1e-7) and the strip as a document through main(): the closed
     form within 2e-3, the relative residual below 1e-6, u within 1e-3 of
     a float64 scipy solve of the same float32 diagonals (and of the
     float64 operator within that plus the float32 representation floor,
     ROADMAP fault 3.23), kernels 2 and 3 launched 32 ceil(it / 32)
     times and kernel 1 once, the host layout build, warm wall (median of
     3), PCG ms an iteration and the idle share; (c) the dense float64
     analyses at the 8,192-DOF budget (a 40 x 98 Q4 wall, 8,118 DOFs):
     modal, buckling, 500 Newmark steps and a 20-frequency harmonic sweep
     within 1e-9 of scipy.sparse float64 references, each mode's residual
     within 1e-9 or 64 eps64 lambda_max / lambda_i (ROADMAP fault 3.24),
     wall and peak memory of each; (d) the cylinder on a 48 x 80
     annulus (7,938 DOFs) on the float32 tier: its residuals at the
     document's tolerance (the tier's 1e-5 floor; ROADMAP fault 3.22),
     then at 1e-4 converged, within 1e-3 of the float64 tier on the
     card, ms a Newton iteration and the LU's share; (e) mesh=, each
     later item's analysis type, an identification block without a
     measurement, the 8,192-DOF budget and a banded prescribed
     displacement, each refused before any launch;
 20. the 3D solid family and the continuum plastic transients: (a) the
     corpus dyn-solid (6,075 DOFs, the banded tier: kernels 1 / 2 / 3
     launched 1 / 32 ceil(it / 32) / 32 ceil(it / 32) times, within 1e-4
     of the CPU run, the closed form u_z = sigma z / E, u_x = -nu sigma x /
     E, von Mises = sigma within 2e-3), dyn-solid-plastic,
     dyn-solid-transient-plastic and dyn-plane-transient-plastic (float64
     tiers, within 1e-10 of the CPU run, no repo kernel) through main();
     (b) the JAX package's banded solid benchmark column at full width
     (16 x 16 x 96 hex8, 84,099 DOFs, 99 diagonals, bandwidth 923):
     kernels 1-3 on its operator against their plain versions (plans,
     staged or not, ms, device us, bounds, CSR K u), then
     solve_solid_static_banded (tol 1e-8) and the column as a document
     through main(): the closed form within 2e-3, the relative residual
     below 1e-6, u within 1e-3 of a float64 scipy banded Cholesky solve of
     the same float32 diagonals (and the float32 representation floor
     against the float64 operator, fault 3.23), the launches of the
     formula, the layout build, PCG iterations and ms an iteration, warm
     wall (median of 3), the idle share; (c) its banded modal analysis (4
     modes, n_iter 30, cg_tol 1e-7) against scipy's eigsh on the same
     float64 lumped pencil within 1e-2, kernel 1 n_iter k and kernels 2-3
     the block solves' rounds; (d) its explicit transient, 2,000 steps at
     solid_stable_dt with beta = 0 and beta != 0: kernel 1 exactly 1 + n +
     2n / r and 2 + 2n + 3n / r times, u within 2e-3 of a float64 twin
     run, ms a step, idle share; (e) the plastic explicit transient of a
     24 x 24 x 48 box (91,875 DOFs) with beta != 0 on the structured path:
     kernel 1 once a step, no ndof^2 array, u within 2e-3 of the float64
     run; the float32 plastic statics of a 10 x 10 x 20 column (7,623
     DOFs) within 1e-3 of the float64 tier, yielded sets equal; (f) the
     dense float64 analyses at the 8,192-DOF budget (a clamped 12 x 12 x
     15 column, 8,112 DOFs): modal, buckling, 500 Newmark steps and a
     20-frequency harmonic sweep within 1e-9 of scipy.sparse float64
     (fault 3.24's residual rule), wall and peak memory of each; (g)
     mesh=, the solid types of later items, an identification block
     without a measurement, the 8,192-DOF budgets, a
     banded prescribed displacement and "plasticity" with "banded", each
     refused before any launch;
 21. the 2D and 3D frame families: (a) the corpus dyn-frame (modal),
     dyn-frame-thermal, dyn-frame-pushover and dyn-frame3d through main()
     within 1e-10 of the port's CPU run, no repo kernel, and
     dyn-frame-identify without its synthetic block refused in the JAX
     package's words; (b) the JAX package's
     banded frame tower at full width (50 stories x 260 bays, 39,933
     DOFs, 21 diagonals, bandwidth 155) and (c) its space-frame skeleton
     (50 stories on 4 x 32 columns, 39,168 DOFs, 67 diagonals, bandwidth
     1,229): kernels 1-3 on each operator against their plain versions,
     then the banded statics (tol 1e-7) and the mesh as a document through
     main(): the relative residual below 1e-6, the base shear within 1e-2
     of the applied wind, u within 1e-3 of a float64 scipy solve of the
     same float32 diagonals (and the float32 floor against the float64
     operator), the launches of the formula, the layout build, PCG
     iterations and ms an iteration, warm wall (median of 3), the idle
     share; after (b), the float32 count at the float32 floor (fault
     3.28): tower(12, 60) at tol 1e-6 under two loads one float32 step
     apart, each u within 1e-3 of the dense float64 solve and the
     launches of the formula, the two counts recorded; (d) the banded modal (4 modes, n_iter 20, cg_tol 1e-7) of
     tower(20, 100) and grid3d(20, 4, 8) against eigsh on the same
     float64 lumped pencil within 1e-2, kernel 1 n_iter k and kernels 2-3
     the block solves' rounds; (e) the dense float64 analyses of
     tower(20, 30) and grid3d(10, 3, 10) (1,953 and 1,980 DOFs): statics,
     modal (the tower's with prestress), buckling under gravity, 500
     Newmark steps and a 20-frequency harmonic sweep within 1e-9 of scipy
     float64, and the plastic-hinge pushover of a 2-story, 4-bay portal
     against a float64 numpy event loop (the hinge sequence equal); (f)
     mesh= and the frame types of later items, each refused before any
     launch;
 22. the plate family and the continuum spectrum / random analyses: (a)
     dyn-plate.json refined to a 128 x 128 slab (t 0.02, 49,923 DOFs, 33
     diagonals, bandwidth 392) through solve_plate_static_banded (tol
     1e-7) and as a document through main() probing the centre: u within
     1e-3 of a float64 scipy solve of the same float32 diagonals (and the
     float32 floor against the float64 operator), the centre within 2e-3
     of mindlin_navier_w, the launches of the formula, the layout build,
     PCG iterations and ms an iteration, warm wall, the idle share; (b)
     kernels 1-3 on the slab's operator against their plain versions;
     (c) the dense float64 plate analyses of a 50 x 50 square (7,803
     DOFs) on the card within 1e-9 of scipy.sparse float64 on the same
     MITC4 blocks: statics, modal with and without a membrane prestress
     (eigsh; degenerate pairs by their spans), buckling (and within 2e-2
     of mindlin_ss_buckling_nx), Newmark, harmonic, and Guyan reduction
     of a 24 x 24 square (reduction is dense-only up to 2,048 DOFs);
     dyn-plate-plastic's float64 tier within 1e-10 of the port's CPU run
     (its plastic strain within the Newton tolerance, 1e-9), the float32
     plastic tier on the mirror plate of tests/test_plate_plastic.py at
     its bounds, and the corpus strip refined to 128 x 8 (3,483 DOFs)
     through main() on the float32 tier beside the float64 tier on the
     card (ROADMAP fault 3.30: the float32 tier stalls and says so,
     success false); wall and peak memory of each; (d) dyn-plane-spectrum and spectrum and random documents of
     the solid, frame, space-frame and plate families through main()
     within 1e-10 of the port's CPU run, and an 8,010-DOF plane wall's
     random document with Dirlik fatigue at 64 frequencies against
     scipy's float64 sweep within 1e-9, ms a frequency; (e)
     dyn-plate-identify with "banded": false beside its zones (the JAX
     package's ValueError) and a plate's reliability and sizing (item
     24), each refused before any launch;
 23. the flat-facet shell family: (a) the Scordelis-Lo roof
     (dyn-shell.json) refined to 96 x 96 (56,454 DOFs, 69 diagonals,
     bandwidth 593) through solve_shell_static_banded (tol 1e-7) and as
     a document through main() probing the midside free-edge node: u
     within 1e-3 of a float64 scipy solve of the same float32 diagonals,
     kernels 2 and 3 launched 32 ceil(it / 32) times and kernel 1 once,
     PCG ms an iteration, the layout build, warm wall, the idle share,
     the midside deflection recorded, and the 32 x 32 roof's within 1e-2
     of the published 0.3024 (ROADMAP fault 3.34); (b) the banded
     Marguerre Newton on the JAX benchmark's 16 x 512 von Karman strip
     (52,326 DOFs, 4 load steps): converged, the midspan deflection
     within 3e-3 of the exact beam, kernel 1 never and kernels 2 and 3
     the sum over its PCG solves of 32 ceil(it / 32), ms a Newton
     iteration split into block build, scatter, PCG and line search, the
     block build's operations a second against the FP32 peak; (c)
     kernels 1-3 against their plain versions on both operators; (d) the
     dense float64 analyses of the 17 x 17 roof (statics, modal,
     buckling, reduction, a random document), a cylindrical panel's
     spectrum document (theta_z held, ROADMAP fault 3.33), and
     dyn-shell, dyn-shell-snap and dyn-shell-plastic through main()
     within 1e-10 of the port's CPU run, Newmark and harmonic on the 35 x
     35 roof within 1e-9 of scipy.sparse float64, and the plastic strip
     refined above the dense limit on the float32 tier beside the float64
     tier (residuals recorded), wall and peak memory of each; (e) shell
     "sizing" and "reliability" documents, an "identification" document
     without a measurement, and shell modal and buckling above the dense
     limit, each refused before any launch;
 24. identification: (a) the 128 x 512 plane strip (132,354 DOFs) with
     dyn-plane-identify's two zones on the banded adjoint
     (identify_plane_young_banded: a forward and an adjoint fused PCG an
     ADAM iteration), twin data from the banded tier; the zones within
     5e-3 of 800 / 1400, the first zone gradient within 1e-3 of the
     float64 twin on the card (plain PCG) and that within 1e-5 of its
     central difference, the launches of the formula (kernel 1 once, for
     the twin data's reactions; kernels 2 and 3 the sum of 32 ceil(it /
     32)), ms an ADAM iteration split by part, PCG counts, idle share,
     peak memory; (b) per-element log-E and field=True, 5 iterations
     each, gradients against the float64 twin; (c) the 84k solid column
     gated as (a), the plate slab and the 32 x 32 roof at full width
     (launches, the loss rows), and small plate and roof documents on
     the card against the port's CPU run; (d) the seven identification
     documents, n_iter cut to 50, against the port's CPU run of the same
     document (CPU processes beside the card's runs); (e) refusals before
     any launch.
 25. Sizing and reliability (ROADMAP item 24): (a) OC compliance sizing
     on the 100 x 200 grid (40,000 DOFs), uncut: oc_sizing_iteration,
     the compliance drop, PCG iterations, idle share, peak memory, areas
     and history against a float64 host OC (scipy.sparse LU, the same
     bisection), the document default (40 iterations) through the CLI,
     launches by the fused PCG's formula (kernel 1 once an OC
     iteration); (b) ADAM sizing of the 16 x 64 strip (2,048 DOFs) with
     dyn-sizing.json's analysis, float32 against float64 on the card;
     (c) FORM on the strip with E a random field (3,860 variables), 8
     stress limit states and 2,048 Monte-Carlo samples in chunks of
     1,024 (each one batched dense solve), against float64 on the card;
     (d) the seven sizing / reliability documents (ADAM cut) and nine
     small family documents against the port's CPU run, with
     benchmarks/dyn_corpus.py's gates; (e) refusals before any launch.

Every kernel is held to its plain version by the tolerance stated where it
is checked.  The line before the last is {"kernels": [...]}, one entry per
kernel with its launches on its main path, error, ms (CUDA events), the
twin's ms, the bound (bytes at 3.35 TB/s or operations at 67 TFLOP/s FP32,
whichever is larger), a one-call PyTorch yardstick where one exists, the
device us per launch from the profiler, for the two PCG kernels the
wrapper's ms per call beside the ms of the launch bound once as the PCG
loop calls it, and for the material kernels the host us per wrapper call
(the backward also its twin's ms and the s-only call's ms and bound;
kernel 4 also its launches on phase 9's paths, kernels 1-3 theirs on
phase 10's documents, kernels 4 and 4b theirs on phase 11's legacy
paths, every kernel its launches on phase 12's paths and, as
launches_dynamics, on phase 13's, as launches_multigrid on phase 14's,
as launches_batched on phase 15's, as launches_eigen on phase 16's,
as launches_frequency on phase 17's, as launches_nonlinear on phase 18's,
as launches_plane on phase 19's, as launches_solid on phase 20's, as
launches_frame on phase 21's, as launches_plate on phase 22's, as
launches_shell on phase 23's, as launches_identification on phase
24's, as launches_sizing on phase 25's, kernels 1-3 their figures on phase 19's
strip operator (plane_strip), on phase 20's column operator
(solid_column), on phase 21's tower and skeleton operators (frame_tower,
frame3d_grid), on phase 22's slab operator (plate_slab) and on phase 23's
roof and Marguerre strip operators (shell_roof, shell_marguerre), kernel
1 also its times at the
multigrid's level shapes, kernels 4 and 4b their member-axis times at
B = 1, 8 and 32 as members); the last is
{"ok": true,
"device": {...}}.  Needs one card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
GRID = (100, 200)
GRID_TOL = 1e-5
# Newton iterations on the grid with the earlier update kernel (float32
# dot products summed outside it): 18 stencils.
EARLIER_NEWTON_ITERATIONS = 8
CHAIN_NODES = 1_000_001
WIDE_NDOF = 1_000_001
CG_ITERS = 300
MAT_CHAIN_ELEMENTS = 1_000_000
# 600: the loss falls below a fifth of its start only after about 530 GD
# steps from the initial weights the JAX CLI draws (the CPU twin: 0.230
# at 500, 0.147 at 600).
GD_ITERS = 600
CPU_ROWS = 50
# Card vs CPU twin, first CPU_ROWS GD history rows: max |difference| over
# each column's largest value.  Adam steps every component by about lr from
# its first step on, whatever the size of its gradient, so float32 noise in
# near-zero gradients moves the trajectory: two CPU runs of this document
# whose measured data differ by one float32 ulp drift 2.8e-2 apart
# (loss_physics) within 50 rows, u_norm 2.3e-3, theta_norm 2.3e-6
# (tests/measure_torch_agreement.py drift).  The first row precedes any
# step; it and theta_norm are held tightly.
GD_ROWS_RTOL = 0.1
GD_FIRST_ROW_RTOL = 1e-5
GD_THETA_RTOL = 1e-4
# Phase 9: the full-NR PINN grid, its iterations, the iterations of the
# timed split and the profile, and the rows held against the CPU twin.
FNR_GRID = (16, 32)
FNR_GRID_ITERS = 20
FNR_SPLIT_ITERS = 5
FNR_CPU_ROWS = 3
# Card vs CPU twin, first FNR_CPU_ROWS full-NR rows: max |difference| over
# each column's largest value.  Newton steps do not amplify float32 noise
# as Adam's do: two CPU runs of the 8 x 16 grid whose measured data differ
# by one float32 ulp stay 2.6e-7 apart over 3 rows, and the port and the
# JAX package 1.5e-5 over 5 rows of the 4 x 8 grid
# (tests/measure_torch_agreement.py fnr_drift, second_order); 16 x 32,
# 2.8e-7 on the card machine's CPU.  The card against the twin: 1.1e-7 on
# the first row, 6.0e-6 over 3 rows (grad_norm_theta; NVIDIA H100 80GB
# HBM3, 700.00 W).  The first row precedes any step and is held as phase
# 7 holds its first row.
FNR_FIRST_ROW_RTOL = 1e-5
FNR_ROWS_RTOL = 1e-4
# ||(f_int - f)_free|| at the identified material
# (tests/test_examples_e2e.py:76-86).
FNR_RESIDUAL = 1e-5
# Phase 10: the settlement document's load on each top-row node's y-DOF
# (with the right edge settled 0.01, it converges at the grid's tol, where
# a load of -1e-4 leaves the residual at the float32 floor); the settled
# DOFs' reactions against float64 (the 24 x 48 grid on the CPU: 2.4e-5);
# the Green-Lagrange grid at the dense limit and its load factor (strains
# of about 20 %), and its float64 equilibrium residual
# ||(f_int(u) - f)_free|| / ||f_free||.
SETTLE_TOP_LOAD = -1e-2
SETTLED_REACTIONS_RTOL = 1e-3
GL_GRID = (32, 32)
GL_LOAD = 0.3
GL_RESIDUAL = 1e-3
# Phase 11: the legacy GD on the PINN grid and the rows held against the
# CPU twin (phase 7's bounds); the dense grid of api_fem_solver and the
# frozen-NN incremental Newton, their increments, and u's bound against
# float64 and against the CPU twin; the scalar identification's grid, its
# true E A and the scalar GD's iterations.
LEGACY_GD_ITERS = 300
LEGACY_CPU_ROWS = 20
LEGACY_GRID = (32, 32)
LEGACY_INCREMENTS = 10
FROZEN_INCREMENTS = 3
LEGACY_U_RTOL = 1e-3
SCALAR_GRID = (16, 32)
SCALAR_EA = 2e9
SCALAR_GD_ITERS = 500
# Adam's step is about lr per component: at 3e-3 (the SI payload's) the
# grid's u, of order 7e-4, oscillates and the loss rises (331 -> 645 on
# the card); at 1e-5 it falls to 0.03 in 500 steps (the CPU, 100 x 200).
SCALAR_GD_LR = 1e-5
# tests/test_cli.py's legacy web payload: one input_dim 1 net.
LEGACY_WEB_NN = {
    "nodes": [{"x": 0, "y": 0, "fixed": True},
              {"x": 1, "y": 0, "fixed_y": True},
              {"x": 2, "y": 0, "fixed_y": True},
              {"x": 3, "y": 0, "fixed_y": True}],
    "elements": [[0, 1], [1, 2], [2, 3]],
    "loads": [0, 0, 0, 0, 0, 0, 1.0, 0],
    "material": {"young": 1.0, "area": 1.0, "density": 1.0},
    "measured_displacements": {"nodes": [1, 2, 3], "ux": [1.0, 2.0, 3.0],
                               "uy": [0, 0, 0]},
    "nn_config": {"young": {"enabled": True, "hiddenLayers": 2,
                            "neuronsPerLayer": 8}},
    "pinn_config": {"max_iterations": 1500, "learning_rate_u": 0.01,
                    "learning_rate_theta": 1e-3, "tolerance": 1e-5},
    "solver_type": "pinn-gd",
}
# Phase 12: the seed of the node renumbering, the grid RCM puts back on
# the banded operator, PCG iterations in the gather loop's profile and
# timing, the GD document's iterations an increment (its tolerance lies
# above the loss, so each increment stops at the gate after iteration 10),
# and the bounds: u against float64 as phase 4; the gather and banded
# solves of one mesh within the grid bound of tests/test_torch_slice.py;
# one gather K u against kernel 1's within float32 rounding; a resumed run
# against the uninterrupted one.
SHUFFLE_SEED = 12
RCM_GRID = (20, 60)
GATHER_PROFILE_ITERS = 64
GATHER_TIMED_ITERS = 512
RESUME_GD_TOL = 1e9
RESUME_GD_ITERS = 40
GATHER_U_RTOL = 1e-3
GATHER_VS_BANDED_RTOL = 1e-4
GATHER_MATVEC_RTOL = 1e-6
RESUME_RTOL = 1e-5
BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FLOPS = 67e12           # H100 SXM FP32, outside the tensor cores
CSRC = "pinn_fem_tpu_torch/ops/kernels/csrc/"
KERNELS = {  # name: (source, TPU kernel it replaces)
    "dia_matvec": ("dia_cg.cu", "pinn_fem_tpu/ops/pallas/dia_kernel.py:100"),
    "dia_dir_matvec": ("dia_cg.cu",
                       "pinn_fem_tpu/ops/pallas/cg_kernel.py:97"),
    "cg_update": ("dia_cg.cu", "pinn_fem_tpu/ops/pallas/cg_kernel.py:115"),
    "material_coefficients": (
        "material.cu", "pinn_fem_tpu/ops/pallas/material_kernel.py:89"),
    "material_coefficients_backward": (
        "material.cu", "JAX autodiff of pinn_fem_tpu/ops/assembly.py:30 "
        "(material_values)"),
}
BANDED = ("dia_matvec", "dia_dir_matvec", "cg_update")
MATERIAL = ("material_coefficients", "material_coefficients_backward")
PHASE7 = {}   # phase 7's ms per GD iteration, beside phase 15(b)'s


def log(phase: str, **fields) -> None:
    print(phase, json.dumps(fields), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn over `reps` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card, flush=True)
    log("phase1_card", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        cuda_available=torch.cuda.is_available())
    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    return card


def phase_build():
    sys.path.insert(0, str(ROOT))
    from pinn_fem_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    log("phase2_build", seconds=time.perf_counter() - t0,
        library=os.path.relpath(_build.library_path(), ROOT))


def banded_system(problem, dev):
    from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
    from pinn_fem_tpu_torch.ops.dia import assemble_dia, dia_layout

    data = problem.to_device(dev)
    layout = dia_layout(data.dof_map.cpu().numpy(), problem.ndof)
    diags = assemble_dia(layout,
                         stiffness_coefficients(data, problem.material, 1.0),
                         data.gvec)
    return data, layout, diags


def misaligned(v):
    """A copy of v in a view that starts 4 bytes past a 16-byte
    boundary."""
    import torch

    buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
    buf[1:].copy_(v)
    return buf[1:]


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time for the work: bytes at the memory rate or operations
    at the FP32 rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / BYTES_PER_S, n_ops / FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def banded_bounds(layout, nb: int, update_blocks: int) -> dict:
    """Bounds of the three banded kernels: each input read once, each
    output written once; nd multiply-adds per row of the stencil.  nb: the
    direction kernel's blocks (its partials); update_blocks: the update's
    fixed grid."""
    nd, n = layout.n_diags, layout.ndof
    return {
        # diagonals and int32 offsets, u in; y out
        "dia_matvec": bound(4 * nd * n + 4 * nd + 4 * 2 * n, 2 * nd * n),
        # diagonals, int32 offsets, z, p, mask, beta in; p_new, ap and one
        # partial per block out
        "dia_dir_matvec": bound(4 * nd * n + 4 * nd + 4 * 5 * n + 4 * nb + 4,
                                (2 * nd + 5) * n),
        # x, r, p, ap, inv_diag and the direction partials (counted once)
        # in; x, r, z and two partials per block out; the 32-byte state in
        # and out.  Per row 2 for x, 2 for r, 1 for z, 4 for the two dots;
        # the sums of the partials besides.
        "cg_update": bound(4 * 8 * n + 4 * nb + 8 * update_blocks + 64,
                           9 * n + nb + 2 * update_blocks),
    }


def csr_of(layout, diags):
    """K of the banded layout as a torch CSR matrix (the library yardstick
    for the stencil)."""
    import torch

    n, dev = layout.ndof, diags.device
    rows = torch.arange(n, device=dev).repeat(layout.n_diags, 1)
    cols = rows + layout.offsets_on(dev)[:, None]
    keep = (cols >= 0) & (cols < n) & (diags != 0)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  diags[keep], (n, n)).coalesce()
    return coo.to_sparse_csr()


def mlp_ops(widths, backward: bool) -> int:
    """Operations per element of the three nets (transcendentals counted
    as one), from csrc/material.cu.  widths: [(h1, h2), ...], h2 = 0 with
    one hidden layer."""
    total = 0
    for h1, h2 in widths:
        last = h2 or h1
        fwd = 2 * 3 * h1 + 2 * h1 + (2 * h1 * h2 + 2 * h2) + 2 * last + 7
        total += fwd
        if backward:
            n_params = 4 * h1 + (h1 * h2 + h2) + last + 1
            # logistic and d_out, the deltas, and one multiply-add per
            # parameter term
            total += 6 + 4 * last + (2 * h1 * h2 + 3 * h1 if h2 else 0) \
                + 2 * n_params
    return total + (2 if not backward else 4)


def wide_band_layout(ndof: int):
    """63 diagonals at offsets 0, +-1290 j (j = 1..31): a band of 39,990
    rows, whose window no block's shared memory holds (the stencil
    kernel's unstaged path)."""
    import numpy as np

    from pinn_fem_tpu_torch.ops.dia import DiaLayout

    offs = np.array([1290 * j for j in range(-31, 32)], np.int64)
    return DiaLayout(offsets=offs, entry_slot=np.zeros((0, 2, 2), np.int64),
                     ndof=ndof, bandwidth=int(offs.max()))


def device_events(prof):
    """The profiler's device-side events (kernels and copies)."""
    import torch

    return [e for e in prof.events()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA
            and getattr(e, "device_time_total", 0) > 0]


def profiled(fn):
    """(host wall s, device events) of fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_events(prof)


KERNEL_SYMBOLS = {"dia_matvec": "stencil_kernel",
                  "dia_dir_matvec": "dia_dir_matvec_kernel",
                  "cg_update": "cg_update_kernel"}


def launched(name: str, symbol: str) -> bool:
    """Whether a profiler event's name is the kernel `symbol` (a
    template's name goes on with its arguments, "<...>")."""
    return symbol + "(" in name or symbol + "<" in name


def per_launch_us(events, name: str):
    """(launches, mean device us per launch) of one banded kernel."""
    symbol = KERNEL_SYMBOLS[name]
    mine = [e.device_time_total for e in events if launched(e.name, symbol)]
    return len(mine), (sum(mine) / len(mine) if mine else None)


def pcg_profile(layout, diags, rhs, mask, iters: int = 64) -> dict:
    """torch.profiler over `iters` fused PCG iterations at tol = 0 (setup
    included) and over the same call's setup alone (max_iter = 0): device
    kernels per iteration, other device operations the loop adds, busy and
    idle share of the window; on the device's timeline, from the first PCG
    kernel's start to the last one's end, ms per iteration and the idle
    share of the loop; and a window of `iters` stencil calls."""
    from pinn_fem_tpu_torch.ops.kernels import dia_matvec, fused_cg_solve

    def solve(n):
        return lambda: fused_cg_solve(layout, diags, rhs, mask, tol=0.0,
                                      max_iter=n)

    solve(iters)()                                    # warm-up
    wall0, ev0 = profiled(solve(0))
    for _ in range(3):  # a window may come back without some records
        wall, ev = profiled(solve(iters))
        n_dir, us_dir = per_launch_us(ev, "dia_dir_matvec")
        n_upd, us_upd = per_launch_us(ev, "cg_update")
        if n_dir + n_upd >= 2 * iters:
            break
    other = len(ev) - n_dir - n_upd - len(ev0)
    busy_ms = sum(e.device_time_total for e in ev) / 1e3
    pcg = [e for e in ev if any(KERNEL_SYMBOLS[k] + c in e.name
                                for k in ("dia_dir_matvec", "cg_update")
                                for c in "(<")]
    loop = {}
    if pcg:
        t0 = min(e.time_range.start for e in pcg)
        t1 = max(e.time_range.end for e in pcg)
        busy_us = sum(max(0.0, min(e.time_range.end, t1)
                          - max(e.time_range.start, t0)) for e in ev)
        loop = {"loop_span_ms": (t1 - t0) / 1e3,
                "loop_ms_per_iteration": (t1 - t0) / 1e3 / iters,
                "loop_device_busy_ms": busy_us / 1e3,
                "loop_device_idle_share": 1 - busy_us / (t1 - t0)}
    u = rhs.clone()
    _, ev_mv = profiled(lambda: [dia_matvec(layout, diags, u)
                                 for _ in range(iters)])
    n_mv, us_mv = per_launch_us(ev_mv, "dia_matvec")
    return {"iterations": iters, "wall_ms": 1e3 * wall,
            "setup_wall_ms": 1e3 * wall0,
            "pcg_kernels_per_iteration": (n_dir + n_upd) / iters,
            "other_device_ops_added_by_loop": other,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (1e3 * wall), **loop,
            "device_us": {"dia_matvec": us_mv, "dia_dir_matvec": us_dir,
                          "cg_update": us_upd},
            "launches_in_window": {"dia_matvec": n_mv,
                                   "dia_dir_matvec": n_dir,
                                   "cg_update": n_upd}}


def check_update(layout, dev, gen, pap, name):
    """Kernel 3, one step, against its twin (x, r, z, partials and the
    state, bit for bit); ms of kernel and twin."""
    import torch

    from pinn_fem_tpu_torch.ops.kernels import cg_kernel

    n = layout.ndof
    x, r, p, ap = (torch.randn(n, generator=gen, device=dev) for _ in range(4))
    inv_diag = torch.rand(n, generator=gen, device=dev) + 0.1
    state = cg_kernel.new_state(torch.dot(r, inv_diag * r), torch.dot(r, r),
                                torch.zeros((), device=dev), 2**31 - 1)
    outs = []
    for fn in (cg_kernel.cg_update, cg_kernel.cg_update_reference):
        xs, rs, st = x.clone(), r.clone(), state.clone()
        zs = torch.empty_like(x)
        parts = fn(pap, xs, rs, p, ap, inv_diag, zs, st, 2**31 - 1)
        outs.append((xs, rs, zs, parts, st))
    pairs = list(zip(*outs))
    err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
              for a, b in pairs[:4])
    require(err <= 1e-6, f"cg_update within 1e-6 on {name}")
    equal = all(torch.equal(a, b) for a, b in pairs)
    require(equal, f"cg_update bit-equal to its twin, state included, on "
            f"{name}")
    require(int(cg_kernel.state_views(outs[0][4])[1][0]) == 1,
            "the update's epilogue counted the iteration")
    # Timing: with ap = 0 the update leaves r, rz and rn2 as they are, so
    # every timed call is live and does the same work.
    # ms: the launch bound once, as the PCG loop calls it; wrapper_ms: the
    # wrapper, which checks its operands on every call.
    zero = torch.zeros_like(ap)
    xs, rs, zs, st = x.clone(), r.clone(), torch.empty_like(x), state.clone()
    launch, _ = cg_kernel.bind_cg_update(pap, xs, rs, p, zero, inv_diag, zs,
                                         st, 2**31 - 1)
    return dict(err=max(max_err(a, b) for a, b in pairs[:4]), bit_equal=equal,
                ms=cuda_ms(launch, 200),
                wrapper_ms=cuda_ms(lambda: cg_kernel.cg_update(
                    pap, xs, rs, p, zero, inv_diag, zs, st, 2**31 - 1), 200),
                plain_ms=cuda_ms(lambda: cg_kernel.cg_update_reference(
                    pap, xs, rs, p, zero, inv_diag, zs, st, 2**31 - 1), 20))


def phase_kernels(dev):
    import torch

    from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve_reference
    from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel
    from pinn_fem_tpu_torch.ops.kernels import fused_cg_solve
    from pinn_fem_tpu_torch.ops.kernels import fused_cg_solve_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {}
    systems = {"grid_40k": banded_system(grid_problem(*GRID), dev),
               "chain_2M": banded_system(chain_problem(CHAIN_NODES), dev)}
    for name, (data, layout, diags) in systems.items():
        n = layout.ndof
        u, z, p = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
        mask = data.free_mask

        # Kernel 1: bit-equal to its twin (same order, no FMA contraction),
        # also on a view of u that starts 4 bytes past a 16-byte boundary.
        plan = dia_kernel.stencil_plan(layout)
        y = dia_kernel.dia_matvec(layout, diags, u)
        y_ref = dia_kernel.dia_matvec_reference(layout, diags, u)
        require(torch.equal(y, y_ref), f"dia_matvec bit-equal on {name}")
        u_off = torch.randn(n + 1, generator=gen, device=dev)[1:]
        require(torch.equal(dia_kernel.dia_matvec(layout, diags, u_off),
                            dia_kernel.dia_matvec_reference(layout, diags,
                                                            u_off)),
                f"dia_matvec bit-equal on a misaligned view on {name}")
        k1 = dict(err=max_err(y, y_ref),
                  ms=cuda_ms(lambda: dia_kernel.dia_matvec(layout, diags, u), 200),
                  plain_ms=cuda_ms(lambda: dia_kernel.dia_matvec_reference(
                      layout, diags, u), 20))
        log("phase3_dia_matvec", mesh=name, ndof=n, n_diags=layout.n_diags,
            bandwidth=layout.bandwidth, plan=dict(
                threads=plan.threads, tile=plan.tile, blocks=plan.blocks,
                staged=plan.staged, shared_bytes=plan.shared_bytes),
            bit_equal=True, misaligned_bit_equal=True,
            max_abs_err=k1["err"], ms=k1["ms"], plain_ms=k1["plain_ms"])

        # Kernel 2, one step: bit-equal to its twin (p_new, ap and the
        # block partials), also on views of z, p and mask that start 4
        # bytes past a 16-byte boundary.
        beta = torch.tensor(0.37, device=dev)
        got = cg_kernel.dia_dir_matvec(beta, z, p, layout, diags, mask)
        want = cg_kernel.dir_matvec_reference(beta, z, p, layout, diags, mask)
        err2 = max(max_err(a, b) / float(b.abs().max())
                   for a, b in zip(got, want))
        require(err2 <= 1e-6, f"dia_dir_matvec within 1e-6 on {name}")
        equal2 = all(torch.equal(a, b) for a, b in zip(got, want))
        require(equal2, f"dia_dir_matvec bit-equal to its twin on {name}")
        zo, po, mo = (misaligned(t) for t in (z, p, mask))
        require(all(torch.equal(a, b) for a, b in zip(
            cg_kernel.dia_dir_matvec(beta, zo, po, layout, diags, mo),
            cg_kernel.dir_matvec_reference(beta, zo, po, layout, diags, mo))),
            f"dia_dir_matvec bit-equal on misaligned views on {name}")
        # ms: the launch bound once, as the PCG loop calls it; wrapper_ms:
        # the wrapper, which checks its operands on every call.
        out = tuple(torch.empty_like(t) for t in got)
        launch, _ = cg_kernel.bind_dir_matvec(beta, z, p, layout, diags, mask,
                                              out=out)
        k2 = dict(err=max(max_err(a, b) for a, b in zip(got, want)),
                  ms=cuda_ms(launch, 200),
                  wrapper_ms=cuda_ms(lambda: cg_kernel.dia_dir_matvec(
                      beta, z, p, layout, diags, mask, out=out), 200),
                  plain_ms=cuda_ms(lambda: cg_kernel.dir_matvec_reference(
                      beta, z, p, layout, diags, mask), 20))
        log("phase3_dia_dir_matvec", mesh=name, max_rel_err=err2,
            bit_equal=equal2, misaligned_bit_equal=True, ms=k2["ms"],
            wrapper_ms=k2["wrapper_ms"], plain_ms=k2["plain_ms"])

        # Kernel 3, one step, on kernel 2's partials.
        k3 = check_update(layout, dev, gen, got[2], name)
        log("phase3_cg_update", mesh=name, bit_equal=k3["bit_equal"],
            max_abs_err=k3["err"], ms=k3["ms"], wrapper_ms=k3["wrapper_ms"],
            plain_ms=k3["plain_ms"],
            update_blocks=cg_kernel.UPDATE_BLOCKS,
            direction_partials=got[2].numel())
        bounds = banded_bounds(layout, got[2].numel(), cg_kernel.UPDATE_BLOCKS)
        k1.update(bounds["dia_matvec"])
        k2.update(bounds["dia_dir_matvec"], library_ms=None)
        k3.update(bounds["cg_update"], library_ms=None)
        k_csr = csr_of(layout, diags)
        y_csr = k_csr @ u
        require(max_err(y_csr, y) <= 1e-5 * float(y.abs().max()),
                f"CSR yardstick computes the same K u on {name}")
        k1["library_ms"] = cuda_ms(lambda: k_csr @ u, 200)
        del k_csr
        log("phase3_bounds", mesh=name, **{
            k: {"bound_ms": v["bound_ms"], "bound_by": v["bound_by"]}
            for k, v in bounds.items()}, dia_matvec_csr_ms=k1["library_ms"])
        stats[name] = {"dia_matvec": k1, "dia_dir_matvec": k2,
                       "cg_update": k3}

    # Kernel 1's unstaged path: a band too wide for shared memory, with
    # ndof = 1 (mod 4), so diagonal rows of every alignment occur.
    wide = wide_band_layout(WIDE_NDOF)
    plan = dia_kernel.stencil_plan(wide)
    require(not plan.staged, "the wide band takes the unstaged path")
    d_wide = torch.randn(wide.n_diags, wide.ndof, generator=gen, device=dev)
    u_wide = torch.randn(wide.ndof + 1, generator=gen, device=dev)
    for uu in (u_wide[:-1], u_wide[1:]):
        y = dia_kernel.dia_matvec(wide, d_wide, uu)
        require(torch.equal(y, dia_kernel.dia_matvec_reference(wide, d_wide,
                                                               uu)),
                "dia_matvec bit-equal on the wide band")
    uu = u_wide[:-1]
    wide_ms = cuda_ms(lambda: dia_kernel.dia_matvec(wide, d_wide, uu), 50)
    log("phase3_dia_matvec_wide_band", ndof=wide.ndof, n_diags=wide.n_diags,
        bandwidth=wide.bandwidth, staged=plan.staged, bit_equal=True,
        misaligned_bit_equal=True, ms=wide_ms,
        plain_ms=cuda_ms(lambda: dia_kernel.dia_matvec_reference(
            wide, d_wide, uu), 5),
        bound_ms=banded_bounds(wide, 1, 1)["dia_matvec"]["bound_ms"])
    # Kernel 2's unstaged path on the same band: p_new rebuilt from z and p
    # at every neighbour, bit-equal, also on misaligned views.
    dplan = dia_kernel.direction_plan(wide)
    require(not dplan.staged, "kernel 2 takes the unstaged path on the "
            "wide band")
    zw, pw, mw = (torch.randn(wide.ndof, generator=gen, device=dev)
                  for _ in range(3))
    beta = torch.tensor(-0.37, device=dev)
    for args in ((zw, pw, mw), tuple(misaligned(t) for t in (zw, pw, mw))):
        got = cg_kernel.dia_dir_matvec(beta, args[0], args[1], wide, d_wide,
                                       args[2])
        want = cg_kernel.dir_matvec_reference(beta, args[0], args[1], wide,
                                              d_wide, args[2])
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                "dia_dir_matvec bit-equal on the wide band")
    log("phase3_dia_dir_matvec_wide_band", rows=dplan.rows,
        threads=dplan.threads, blocks=dplan.blocks, staged=dplan.staged,
        bit_equal=True, misaligned_bit_equal=True,
        ms=cuda_ms(lambda: cg_kernel.dia_dir_matvec(
            beta, zw, pw, wide, d_wide, mw, out=got), 50),
        bound_ms=banded_bounds(wide, dplan.blocks,
                               1)["dia_dir_matvec"]["bound_ms"])
    del d_wide, u_wide, uu, zw, pw, mw, got, want
    stats["wide_band"] = {"dia_matvec": {"err": 0.0},
                          "dia_dir_matvec": {"err": 0.0}}

    # Fused PCG on the grid, at the tolerances the Newton solve uses.
    data, layout, diags = systems["grid_40k"]
    cg_tol, cg_max = 0.1 * GRID_TOL, min(max(20 * layout.ndof, 1000), 100_000)
    runs = {}
    for label, solver in (("fused", fused_cg_solve),
                          ("twin", fused_cg_solve_reference),
                          ("plain", dia_cg_solve_reference)):
        solver(layout, diags, data.loads, data.free_mask, tol=cg_tol,
               max_iter=3)  # warm: the first call loads torch's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, res = solver(layout, diags, data.loads, data.free_mask,
                            tol=cg_tol, max_iter=cg_max)
        torch.cuda.synchronize()
        runs[label] = (x, int(it), float(res), time.perf_counter() - t0)
    xf, itf, resf, tf = runs["fused"]
    setup_s = []
    for _ in range(3):  # the same call's setup alone, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_cg_solve(layout, diags, data.loads, data.free_mask, tol=cg_tol,
                       max_iter=0)
        torch.cuda.synchronize()
        setup_s.append(time.perf_counter() - t0)
    setup_s = sorted(setup_s)[1]
    xt, itt, _, tt = runs["twin"]
    require(itf == itt, "fused PCG iterations equal the twin recurrence's")
    require(bool(torch.equal(xf, xt)), "fused PCG x bit-equal to the twin's")
    x_err = max_err(xf, xt) / float(xt.abs().max())
    prof_grid = pcg_profile(layout, diags, data.loads, data.free_mask)
    log("phase3_fused_cg_grid_40k", iterations=itf, twin_iterations=itt,
        plain_recurrence_iterations=runs["plain"][1], rel_residual=resf,
        x_rel_err=x_err, bit_equal=True, fused_s=tf,
        fused_ms_per_iter=1e3 * tf / max(itf, 1), fused_setup_s=setup_s,
        fused_loop_ms_per_iter=1e3 * (tf - setup_s) / max(itf, 1), twin_s=tt,
        plain_s=runs["plain"][3], profile=prof_grid)
    require(prof_grid["pcg_kernels_per_iteration"] == 2.0,
            "two device kernels per fused PCG iteration")
    require(prof_grid["other_device_ops_added_by_loop"]
            <= 64 // cg_kernel.CHECK_EVERY,
            "no device work in the loop besides the two kernels and the "
            "flag copies")

    # 300 PCG iterations at tol = 0 on the chain (benchmarks/scaling.py
    # cg_iteration_fused / cg_iteration_xla): x of node 0 and every y
    # pinned, the free end pulled.
    data, layout, diags = systems["chain_2M"]
    mask = torch.ones(layout.ndof, device=dev)
    mask[0] = 0.0
    mask[1::2] = 0.0
    rhs = torch.zeros(layout.ndof, device=dev)
    rhs[-2] = 1.0
    ms = {}
    order = ["plain", "fused", "twin", "twin", "fused", "plain"]
    solvers = {"fused": fused_cg_solve, "twin": fused_cg_solve_reference,
               "plain": dia_cg_solve_reference}
    for label in order:
        t = cuda_ms(lambda: solvers[label](layout, diags, rhs, mask, tol=0.0,
                                           max_iter=CG_ITERS), 1)
        ms.setdefault(label, []).append(t / CG_ITERS)
    x300, it300, _ = fused_cg_solve(layout, diags, rhs, mask, tol=0.0,
                                    max_iter=CG_ITERS)
    require(int(it300) == CG_ITERS, "300 iterations at tol = 0")
    xt300, itt300, _ = fused_cg_solve_reference(layout, diags, rhs, mask,
                                                tol=0.0, max_iter=CG_ITERS)
    require(int(itt300) == CG_ITERS and bool(torch.equal(x300, xt300)),
            "300 fused iterations bit-equal to the twin recurrence")
    prof_chain = pcg_profile(layout, diags, rhs, mask)
    log("phase3_cg_iteration_chain_2M", ndof=layout.ndof, iterations=CG_ITERS,
        bit_equal=True, fused_ms_per_iter=ms["fused"],
        twin_ms_per_iter=ms["twin"], plain_ms_per_iter=ms["plain"],
        profile=prof_chain)
    require(prof_chain["pcg_kernels_per_iteration"] == 2.0,
            "two device kernels per fused PCG iteration on the chain")
    for name in BANDED:
        stats["grid_40k"][name]["device_us"] = prof_grid["device_us"][name]
    # Kernel 2 at both sizes: its plan, ms of the bound launch, device us
    # per launch in the PCG window and the share of its bound.
    for mesh, prof in (("grid_40k", prof_grid), ("chain_2M", prof_chain)):
        k2 = stats[mesh]["dia_dir_matvec"]
        dplan = dia_kernel.direction_plan(systems[mesh][1])
        us = prof["device_us"]["dia_dir_matvec"]
        log("phase3_dia_dir_matvec_summary", mesh=mesh, rows=dplan.rows,
            threads=dplan.threads, tile=dplan.tile, blocks=dplan.blocks,
            staged=dplan.staged, shared_bytes=dplan.shared_bytes,
            warps_per_sm=dplan.blocks * dplan.threads / 32 / dia_kernel.SMS,
            ms=k2["ms"], device_us=us,
            bound_ms=k2["bound_ms"],
            share_of_bound=1e3 * k2["bound_ms"] / us if us else None)
    del systems
    torch.cuda.empty_cache()
    return stats


def float64_check(doc, u):
    """Host float64 residual of u, and u's distance from a float64 solve."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import (float64_solution,
                                                  float64_stiffness)

    f = np.asarray(doc["loads"], float)
    k = float64_stiffness(doc["nodes"], doc["elements"])  # E = A = 1
    free = np.setdiff1d(np.arange(f.size), doc["fixed_dofs"])
    residual = (np.linalg.norm((f - k @ u)[free])
                / np.linalg.norm(f[free]))
    u_ref = float64_solution(doc["nodes"], doc["elements"], f,
                             doc["fixed_dofs"])
    return residual, float(np.abs(u - u_ref).max() / np.abs(u_ref).max())


def phase_main_path(workdir: Path):
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.examples_grid import grid_document
    from pinn_fem_tpu_torch.ops import kernels

    doc = grid_document(*GRID, tolerance=GRID_TOL, n_increments=2)
    path = workdir / "grid100x200.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE

    # Cold: a fresh process (torch import, CUDA start, library load).
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pinn_fem_tpu_torch.cli.generic", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cold_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"cold CLI run exit code 0, got {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([str(path)])
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require(rc == 0, "CLI exit code 0")
    out = json.loads((workdir / "grid100x200.res.json").read_text())
    require(out["converged"] is True, "converged")
    for name in BANDED:
        require(launches[name] > 0, f"{name} launched on the main path")
    require(launches["dia_dir_matvec"] == launches["cg_update"],
            "one update per direction pass: two launches a PCG iteration")
    # Two stencils per Newton iteration and one per increment.  The count
    # is reported beside earlier runs', not gated: at tol 1e-5 Newton stops
    # at the float32 stall floor, where the step that fails to lower the
    # residual rides on the last bits of each PCG solution (ROADMAP fault
    # 3.5; PERF.md).
    newton_iterations = (launches["dia_matvec"] - 2) // 2

    t0 = time.perf_counter()
    require(main([str(path)]) == 0, "warm CLI run exit code 0")
    warm_s = time.perf_counter() - t0

    u = np.asarray(out["displacements"], float)
    require(bool(np.all(np.isfinite(u))) and u.size == 2 * GRID[0] * GRID[1],
            "finite displacements of the expected shape")
    residual, u_err = float64_check(doc, u)
    log("phase4_main_path", ndof=u.size, elements=len(doc["elements"]),
        converged=out["converged"], history=out["history"],
        float64_residual=residual, u_rel_err_vs_scipy=u_err,
        cold_process_s=cold_s, first_in_process_s=first_s, warm_s=warm_s,
        launches=launches, newton_iterations=newton_iterations,
        earlier_newton_iterations=EARLIER_NEWTON_ITERATIONS)
    require(residual <= GRID_TOL ** 0.5, "float64 residual <= sqrt(tol)")
    require(u_err <= 1e-3, "max|u - u_scipy| / max|u_scipy| <= 1e-3")
    return {k: launches[k] for k in BANDED}


def phase_dense(workdir: Path):
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main

    path = workdir / "example1.json"
    path.write_text((ROOT / "examples" / "json" / "example1.json").read_text())
    require(main([str(path)]) == 0, "example1 exit code 0")
    out = json.loads((workdir / "example1.res.json").read_text())
    err = float(np.abs(np.asarray(out["displacements"])
                       - [0, 0, 1, 0, 2, 0, 3, 0]).max())
    require(out["converged"] is True and err <= 2e-5,
            "example1 displacements within 2e-5")
    log("phase5_example1", converged=True, max_abs_err=err)


def mlp_material(hidden_layers: int, dev):
    """Three MLP fields at the PINN grid's widths (20, 15, 10), input_dim 3,
    seeded torch draws; the last layer is perturbed away from its constant
    start so that every parameter's gradient is exercised."""
    import torch

    from pinn_fem_tpu_torch import Material, make_mlp_field

    g = torch.Generator().manual_seed(hidden_layers)
    fields = []
    for width, scale in ((20, 2.0), (15, 0.5), (10, 7.0)):
        f = make_mlp_field(g, hidden_layers=hidden_layers,
                           neurons_per_layer=width, input_dim=3, scale=scale)
        w, b = f.layers[-1]
        f.layers[-1] = (w + 0.3 * torch.randn(w.shape, generator=g), b)
        fields.append(f)
    return Material(*fields).to(dev)


def phase_material(dev):
    """Kernel 4 forward and backward against the twin; ms of kernel, twin
    and torch form; the bounds at the grid's shapes."""
    import torch

    from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk
    from pinn_fem_tpu_torch.solvers.gd import get_theta

    meshes = {"grid_79k": grid_problem(*GRID).to_device(dev),
              "chain_1M": chain_problem(MAT_CHAIN_ELEMENTS + 1).to_device(dev)}
    stats = {name: {"err": 0.0} for name in MATERIAL}
    for mesh, data in meshes.items():
        n = data.nelm
        c = torch.randn(4, n, device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
        for hidden in (1, 2):
            mat = mlp_material(hidden, dev)
            params = torch.cat([t.reshape(-1)
                                for f in mk._fields(mat)
                                for t in f.trainable_params()])
            widths = mk._widths(mat)
            scales = torch.stack([f.scale for f in mk._fields(mat)])
            theta = [t for layers in get_theta(mat) for layer in layers
                     for t in layer]
            for lf in (0.3, 1.0):
                got = mk.material_coefficients(data.mid, data.inv_len, lf,
                                               params, scales, widths)
                require(all(torch.equal(a, b) for a, b in zip(
                    got, mk.material_coefficients(data.mid, data.inv_len, lf,
                                                  params, scales, widths))),
                        f"material forward bit for bit across two calls on "
                        f"{mesh}")
                with torch.enable_grad():
                    for t in theta:
                        t.requires_grad_(True)
                    want = mk.material_coefficients_reference(
                        data.mid, data.inv_len, lf, mat)
                    g_want = torch.cat([g.reshape(-1) for g in
                                        torch.autograd.grad(
                                            sum(torch.sum(ci * o) for ci, o
                                                in zip(c, want)), theta)])
                    for t in theta:
                        t.requires_grad_(False)
                want = [w.detach() for w in want]
                g_got = mk.material_coefficients_backward(
                    data.mid, data.inv_len, lf, params, scales, widths,
                    got[0], got[1], tuple(c))
                plain_rel = check_backward(mk, data, lf, params, scales,
                                           widths, got, tuple(c), g_got, mesh)
                s_only = (None, None, None, c[3])
                gs_got = mk.material_coefficients_backward(
                    data.mid, data.inv_len, lf, params, scales, widths,
                    got[0], got[1], s_only)
                s_rel = check_backward(mk, data, lf, params, scales, widths,
                                       got, s_only, gs_got, mesh)
                require(bool((gs_got[-mat.density.n_params():] == 0).all()),
                        f"s-only backward leaves the density block zero on "
                        f"{mesh}")
                rel = []
                for k, (a, b) in enumerate(zip(got, want)):
                    rtol = 3e-5 if k == 3 else 2e-5
                    require(bool(((a - b).abs() <= 1e-6 + rtol * b.abs()).all()),
                            f"material forward output {k} within rtol {rtol}"
                            f" / atol 1e-6 on {mesh}")
                    rel.append(max_err(a, b) / float(b.abs().max()))
                g_rel = max_err(g_got, g_want) / float(g_want.abs().max())
                require(g_rel <= 1e-4, "material backward within 1e-4 of "
                        f"max|grad| on {mesh}")
                stats["material_coefficients"]["err"] = max(
                    stats["material_coefficients"]["err"],
                    max(max_err(a, b) for a, b in zip(got, want)))
                stats["material_coefficients_backward"]["err"] = max(
                    stats["material_coefficients_backward"]["err"],
                    max_err(g_got, g_want))
                timing = {}
                if lf == 1.0:
                    timing = material_times(data, mat, lf, params, scales,
                                            widths, theta, c, got, reps=20)
                plan, occupancy = mk._forward_plan(data.mid.device, widths, n)
                log("phase6_material", mesh=mesh, elements=n,
                    hidden_layers=hidden, load_factor=lf,
                    forward_plan=plan._asdict(),
                    forward_blocks_per_sm=occupancy[0],
                    forward_registers=occupancy[2],
                    forward_local_bytes=occupancy[3],
                    forward_bit_equal_repeat=True,
                    max_rel_err_E_A_rho_s=rel, grad_max_rel_err=g_rel,
                    grad_max_rel_err_vs_plain=plain_rel,
                    s_only_grad_max_rel_err_vs_plain=s_rel,
                    backward_bit_equal_repeat=True, **timing)
                if hidden == 2 and lf == 1.0 and mesh == "grid_79k":
                    fw = [(h, h) for h in (20, 15, 10)]
                    io = 4 * (2 * n + n + 4 * n) + 4 * params.numel() + 12
                    stats["material_coefficients"].update(
                        ms=timing["kernel_ms"], plain_ms=timing["twin_ms"],
                        library_ms=None,
                        **bound(io, n * mlp_ops(fw, backward=False)))
                    stats["material_coefficients"].update(
                        device_us=timing["kernel_device_us"],
                        host_us=timing["kernel_host_us"])
                    # mid, 1/L, E, A and four upstream gradients in
                    io_b = 4 * (2 * n + 3 * n + 4 * n) + 8 * params.numel() + 12
                    # s alone: the young and area nets only; gs in, and
                    # the whole gradient out
                    io_s = (4 * (2 * n + 3 * n + n) + 4 * params.numel()
                            + 4 * (params.numel() - mat.density.n_params())
                            + 12)
                    s_bound = bound(io_s, n * mlp_ops(fw[:2], backward=True))
                    stats["material_coefficients_backward"].update(
                        ms=timing["kernel_backward_ms"],
                        plain_ms=timing["plain_backward_ms"],
                        twin_ms=timing["twin_backward_ms"], library_ms=None,
                        device_us=timing["kernel_backward_device_us"],
                        host_us=timing["kernel_backward_host_us"],
                        s_only_ms=timing["kernel_backward_s_only_ms"],
                        s_only_device_us=timing[
                            "kernel_backward_s_only_device_us"],
                        s_only_bound_ms=s_bound["bound_ms"],
                        **bound(io_b, n * mlp_ops(fw, backward=True)))
                    log("phase6_material_bounds", mesh=mesh,
                        forward=stats["material_coefficients"]["bound_ms"],
                        backward=stats["material_coefficients_backward"][
                            "bound_ms"], backward_s_only=s_bound["bound_ms"])
    del meshes
    torch.cuda.empty_cache()
    return stats


def check_backward(mk, data, lf, params, scales, widths, got, grads, g_got,
                   mesh) -> float:
    """Kernel 4b against its plain version (1e-5 of max|grad|) and against
    a second call (bit for bit); the relative error."""
    import torch

    g_plain = mk.material_coefficients_backward_reference(
        data.mid, data.inv_len, lf, params, scales, widths, got[0], got[1],
        grads)
    rel = max_err(g_got, g_plain) / float(g_plain.abs().max())
    require(rel <= 1e-5, "material backward within 1e-5 of max|grad| of its "
            f"plain version on {mesh}")
    require(bool(torch.equal(g_got, mk.material_coefficients_backward(
        data.mid, data.inv_len, lf, params, scales, widths, got[0], got[1],
        grads))), f"material backward bit for bit across two calls on {mesh}")
    return rel


def recorded_window(fn, tries: int = 3, enough=bool):
    """(device events, windows taken) of fn() under torch.profiler: the
    first of up to `tries` windows whose events satisfy `enough` (by
    default: any device event; on the card a window now and then comes
    back with none, or without many of its records)."""
    for window in range(1, tries + 1):
        _, ev = profiled(fn)
        if enough(ev):
            break
    return ev, window


def host_us(fn, reps: int = 200) -> float:
    """Host us per call of fn (time.perf_counter around `reps` calls after
    a synchronize; the calls only enqueue)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def material_times(data, mat, lf, params, scales, widths, theta, c, got,
                   reps):
    """ms of the forward and backward kernels, of the twin and of the
    torch form (each field's eval_batch on the assembly inputs, and the
    product), forward alone and backward alone."""
    import torch

    from pinn_fem_tpu_torch.models.fields import assembly_inputs
    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk

    def torch_form():
        x = assembly_inputs(data.mid, data.dimension, lf)
        e, a = mat.young.eval_batch(x), mat.area.eval_batch(x)
        return e, a, mat.density.eval_batch(x), e * a * data.inv_len

    def forward():
        return mk.material_coefficients(data.mid, data.inv_len, lf, params,
                                        scales, widths)

    def backward(grads=tuple(c)):
        return mk.material_coefficients_backward(
            data.mid, data.inv_len, lf, params, scales, widths, got[0],
            got[1], grads)

    s_only = (None, None, None, c[3])
    out = {
        "kernel_ms": cuda_ms(forward, 200),
        "twin_ms": cuda_ms(lambda: mk.material_coefficients_reference(
            data.mid, data.inv_len, lf, mat), reps),
        "torch_form_ms": cuda_ms(torch_form, reps),
        "kernel_backward_ms": cuda_ms(backward, 200),
        "kernel_backward_s_only_ms": cuda_ms(lambda: backward(s_only), 200),
        "plain_backward_ms": cuda_ms(
            lambda: mk.material_coefficients_backward_reference(
                data.mid, data.inv_len, lf, params, scales, widths, got[0],
                got[1], tuple(c)), 5),
        "kernel_host_us": host_us(forward),
        "kernel_backward_host_us": host_us(backward),
    }
    # Device us per launch (torch.profiler over 20 calls of each), and
    # device kernels per backward call.
    for label, fn, symbol in (
            ("kernel", forward, "material_forward_kernel"),
            ("kernel_backward", backward, "material_grad_kernel"),
            ("kernel_backward_s_only", lambda: backward(s_only),
             "material_grad_kernel")):
        ev, windows = recorded_window(
            lambda: [fn() for _ in range(20)],
            enough=lambda ev: sum(launched(e.name, symbol) for e in ev) >= 15)
        mine = [e.device_time_total for e in ev if launched(e.name, symbol)]
        others = sorted({e.name[:80] for e in ev
                         if not launched(e.name, symbol)})
        out[f"{label}_device_us"] = sum(mine) / max(len(mine), 1)
        out[f"{label}_device_ops_per_call"] = len(ev) / 20
        out[f"{label}_other_device_ops"] = others
        out[f"{label}_profiler_windows"] = windows
        # The profiler may drop the first records of a window (full runs
        # on the card saw 18 and 19 of the 20 launches), and adds none: so
        # every recorded device op must be this kernel, and most of the
        # launches must be there.
        require(not others and 15 <= len(mine) <= 20,
                f"one device kernel ({symbol}) per {label} call: {len(mine)} "
                f"launches and {len(ev)} device ops recorded in 20 calls, "
                f"others {others}")
    with torch.enable_grad():
        for t in theta:
            t.requires_grad_(True)
        for label, fn in (("twin", lambda: mk.material_coefficients_reference(
                data.mid, data.inv_len, lf, mat)), ("torch_form", torch_form)):
            loss = sum(torch.sum(ci * o) for ci, o in zip(c, fn()))
            out[f"{label}_backward_ms"] = cuda_ms(
                lambda: torch.autograd.grad(loss, theta, retain_graph=True),
                reps)
        for t in theta:
            t.requires_grad_(False)
    return out


def sync_cost_ms(dev, reps: int = 200) -> float:
    """Host ms of one small device result read back (the GD loop's one
    sync per iteration) on an otherwise idle card."""
    import torch

    x = torch.ones(6, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        (x * 2.0).tolist()
    return 1e3 * (time.perf_counter() - t0) / reps


def gd_profile(doc, dev, iters: int = 20) -> dict:
    """torch.profiler over `iters` GD iterations of the document: device
    busy time, wall time, and device time by kernel name (top 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.solvers.gd import solve_gd

    parsed = parse_problem_dict(doc)
    data = parsed.problem.to_device(dev)
    cfg = parsed.config.with_(max_iterations=iters)
    args = (parsed.measured_disp, parsed.measured_dofs)
    solve_gd(parsed.problem, cfg, *args, data=data)        # warm-up
    parsed = parse_problem_dict(doc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_gd(parsed.problem, cfg, *args, data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    host = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    return {"iterations": iters, "wall_ms": 1e3 * wall,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1 - busy_us / 1e3 / (1e3 * wall)
                                  if busy_us else None),
            "top_device_kernels_us": {e.key[:60]: e.device_time_total
                                      for e in top},
            "top_host_ops_self_us_calls": {
                e.key[:60]: [e.self_cpu_time_total, e.count] for e in host}}


def phase_gd_main_path(workdir: Path, dev):
    """The PINN grid document through main() on cuda: launches, loss,
    ms per GD iteration, the first CPU_ROWS rows against the CPU twin."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main, run
    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers.gd import solve_gd

    doc = pinn_grid_document(*GRID, max_iterations=GD_ITERS)
    path = workdir / "pinn_grid.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pinn_fem_tpu_torch.cli.generic", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cold_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"cold PINN CLI run exit code 0, got {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([str(path)])
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require(rc == 0, "PINN CLI exit code 0")
    out = json.loads((workdir / "pinn_grid.res.json").read_text())
    hist = out["history"]
    n_it = len(hist)
    require(n_it == GD_ITERS or out["converged"],
            "GD ran its budget or converged")
    require(launches["material_coefficients"] == n_it + 1,
            "one forward kernel per GD iteration, one for the reactions")
    require(launches["material_coefficients_backward"] == n_it,
            "one backward kernel per GD iteration")
    loss = [e["loss_total"] for e in hist]
    require(bool(np.all(np.isfinite(loss))) and loss[-1] < 0.2 * loss[0],
            "loss_total finite and falls")
    u = np.asarray(out["displacements"], float)
    require(bool(np.all(np.isfinite(u))) and u.size == 2 * GRID[0] * GRID[1],
            "finite displacements of the expected shape")
    measured = np.zeros(u.size)
    measured[doc["measured_displacements"]["global_dof"]] = \
        doc["measured_displacements"]["measured_u"]
    u_rel = float(np.abs(u - measured).max() / np.abs(measured).max())

    t0 = time.perf_counter()
    require(main([str(path)]) == 0, "warm PINN CLI run exit code 0")
    warm_s = time.perf_counter() - t0
    again = json.loads((workdir / "pinn_grid.res.json").read_text())
    repeat = again["history"] == hist

    # ms per GD iteration: the solver alone, 100 iterations, warm.
    parsed = parse_problem_dict(doc)
    data = parsed.problem.to_device(dev)
    cfg = parsed.config.with_(max_iterations=100)
    solve_gd(parse_problem_dict(doc).problem, cfg.with_(max_iterations=5),
             parsed.measured_disp, parsed.measured_dofs, data=data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_gd(parsed.problem, cfg, parsed.measured_disp,
                   parsed.measured_dofs, data=data)
    torch.cuda.synchronize()
    ms_per_iter = 1e3 * (time.perf_counter() - t0) / len(res.history)
    PHASE7["ms"] = ms_per_iter
    profile = gd_profile(doc, dev)

    # The same document on the CPU (the twin) for CPU_ROWS iterations.
    cpu_doc = dict(doc, pinn_config=dict(doc["pinn_config"],
                                         max_iterations=CPU_ROWS))
    cpu_path = workdir / "pinn_grid_cpu.json"
    cpu_path.write_text(json.dumps(cpu_doc))
    t0 = time.perf_counter()
    cpu = run(str(cpu_path), device="cpu")
    cpu_s = time.perf_counter() - t0
    keys = list(hist[0])
    hc = np.array([[e[k] for k in keys] for e in cpu["history"]])
    hg = np.array([[e[k] for k in keys] for e in hist[:CPU_ROWS]])
    scale = np.maximum(np.abs(hc).max(axis=0), 1e-30)
    col_err = np.abs(hg - hc).max(axis=0) / scale
    first_err = float((np.abs(hg[0] - hc[0]) / scale).max())
    rows_err = dict(zip(keys, col_err.tolist()))
    log("phase7_gd_main_path", ndof=u.size, elements=len(doc["elements"]),
        exit_code=rc, converged=out["converged"], history_length=n_it,
        first_loss_total=loss[0], last_loss_total=loss[-1],
        u_rel_err_vs_measured=u_rel, ms_per_gd_iteration=ms_per_iter,
        sync_ms=sync_cost_ms(dev), cold_process_s=cold_s,
        first_in_process_s=first_s, warm_s=warm_s,
        warm_history_bit_equal=repeat, launches=launches,
        cpu_twin_rows=len(cpu["history"]), cpu_twin_s=cpu_s,
        card_vs_cpu_max_rel_err=rows_err, card_vs_cpu_first_row=first_err,
        profile=profile)
    require(len(cpu["history"]) == CPU_ROWS, "CPU twin run length")
    require(first_err <= GD_FIRST_ROW_RTOL,
            f"first row within {GD_FIRST_ROW_RTOL} of the CPU twin")
    require(rows_err["theta_norm"] <= GD_THETA_RTOL,
            f"theta_norm within {GD_THETA_RTOL} of the CPU twin")
    require(max(col_err) <= GD_ROWS_RTOL,
            f"first {CPU_ROWS} rows within {GD_ROWS_RTOL} of the CPU twin")
    return {k: launches[k] for k in MATERIAL}


def phase_gd_corpus(workdir: Path):
    """Corpus example2 (scalar GD, 141 iterations) and example7-P (hybrid,
    three NN fields, the JAX CLI's initial weights) on cuda.  example7-P's
    count (96 on the CPU, as in JAX) is reported, not gated: the card's
    float32 sums steer Adam's first steps (PERF.md)."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.ops import kernels

    for name, bound_u, pinned in (("example2", 4e-3, 141),
                                  ("example7-P", 2e-4, None)):
        path = workdir / f"{name}.json"
        path.write_text((ROOT / "examples" / "json" / f"{name}.json")
                        .read_text())
        kernels.reset_launch_counts()
        require(main([str(path)]) == 0, f"{name} exit code 0")
        launches = kernels.launch_counts()
        out = json.loads((workdir / f"{name}.res.json").read_text())
        ux = np.asarray(out["displacements"]).reshape(-1, 2)[:, 0]
        err = float(np.abs(ux - np.arange(len(ux))).max())
        require(out["converged"] is True, f"{name} converged")
        require(err <= bound_u * max(1.0, len(ux) - 1),
                f"{name} displacements within {bound_u} x max(1, L)")
        if pinned is not None:
            require(out["iterations"] == pinned, f"{name} {pinned} iterations")
        log("phase8_corpus", document=name, converged=True,
            iterations=out["iterations"], max_abs_err=err,
            launches={k: launches[k] for k in MATERIAL})


class Spy:
    """Records (args, kwargs, result) of every call of module.name while
    in the with block."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.inner, self.calls = getattr(module, name), []

    def __enter__(self):
        def spy(*args, **kwargs):
            result = self.inner(*args, **kwargs)
            self.calls.append((args, kwargs, result))
            return result

        setattr(self.module, self.name, spy)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def corpus_copy(workdir: Path, name: str, **config) -> Path:
    """A corpus document written to workdir; config: solver_config and
    pinn_config entries to set."""
    doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                     .read_text())
    for key, value in config.items():
        section = "pinn_config" if key == "max_iterations" else "solver_config"
        doc.setdefault(section, {})[key] = value
    path = workdir / f"{name}.json"
    path.write_text(json.dumps(doc))
    return path


def value_launches(out, gn: bool) -> int:
    """Kernel 4 launches of one increment when every value-only evaluation
    takes it: one per flag read (full-NR: the row's loss, each LM trial
    loss; gn: the row's residual, each line-search try), gn's stall norm
    after a step no try accepted, and the reactions."""
    stall_norms = sum(not a for a in out.accepted) if gn else 0
    return out.host_syncs + stall_norms + 1


def full_nr_profile(objective_args, iters: int) -> dict:
    """torch.profiler over `iters` full-NR iterations: device busy time,
    wall time, idle share and device time by kernel name (top 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pinn_fem_tpu_torch.solvers.phases import full_nr_phase

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        full_nr_phase(*objective_args(iters))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    return {"iterations": iters, "wall_ms": 1e3 * wall,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1 - busy_us / 1e3 / (1e3 * wall)
                                  if busy_us else None),
            "top_device_kernels_us": {e.key[:60]: e.device_time_total
                                      for e in top}}


def phase_second_order(workdir: Path, dev):
    """Full-NR with NN fields and gn through main() on cuda, and the
    16 x 32 PINN grid as a full-NR document (section 9 of the module
    docstring).  Returns kernel 4's launches on each path."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main, run
    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.assembly import internal_force_and_strain
    from pinn_fem_tpu_torch.solvers import driver, full_newton, gauss_newton
    from pinn_fem_tpu_torch.solvers.gd import get_theta, set_theta
    from pinn_fem_tpu_torch.solvers.phases import FullNRLoss, ZSpace

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    launches = {}
    for name in ("example9", "example10"):
        path = corpus_copy(workdir, name)
        with Spy(driver, "solve_full_nr") as solves, \
                Spy(full_newton, "full_nr_phase") as phase_runs:
            kernels.reset_launch_counts()
            rc = main([str(path)])
            counts = kernels.launch_counts()
        out = json.loads((workdir / f"{name}.res.json").read_text())
        require(rc == 0 and out["converged"] is True,
                f"{name} exit code 0 and converged")
        problem = solves[-1][0][0]
        data = problem.to_device(dev)
        u = torch.as_tensor(out["displacements"], dtype=data.loads.dtype,
                            device=dev).reshape(-1)
        with torch.no_grad():
            f_int, _ = internal_force_and_strain(data, problem.material, u,
                                                 1.0)
            residual = float(torch.linalg.vector_norm(
                (f_int - data.loads) * data.free_mask))
        require(residual < FNR_RESIDUAL,
                f"{name} ||(f_int - f)_free|| < {FNR_RESIDUAL} on the card")
        expected = sum(value_launches(r, False) for _, _, r in phase_runs)
        fused = name == "example10"
        require(counts["material_coefficients"] == (expected if fused else 0),
                f"{name}: kernel 4 takes every value-only evaluation")
        require(counts["material_coefficients_backward"] == 0,
                f"{name}: kernel 4b never runs")
        log("phase9_full_nr", document=name, exit_code=rc, converged=True,
            free_residual_norm=residual,
            rows_per_increment=[len(r.history) for _, _, r in solves],
            host_syncs=sum(r.host_syncs for _, _, r in phase_runs),
            launches={k: counts[k] for k in MATERIAL})
        launches[name] = counts["material_coefficients"]

    for name in ("example3", "example7"):
        path = corpus_copy(workdir, name, method="gn", max_iterations=100)
        with Spy(gauss_newton, "gn_phase") as phase_runs:
            kernels.reset_launch_counts()
            rc = main([str(path)])
            counts = kernels.launch_counts()
        out = json.loads((workdir / f"{name}.res.json").read_text())
        ux = np.asarray(out["displacements"]).reshape(-1, 2)[:, 0]
        err = float(np.abs(ux - np.arange(len(ux))).max())
        require(rc == 0 and out["converged"] is True,
                f"gn {name} exit code 0 and converged")
        require(err <= 2e-4 * max(1.0, len(ux) - 1),
                f"gn {name} displacements within 2e-4 x max(1, L)")
        expected = sum(value_launches(r, True) for _, _, r in phase_runs)
        fused = name == "example7"
        require(counts["material_coefficients"] == (expected if fused else 0),
                f"gn {name}: kernel 4 takes every value-only evaluation")
        require(counts["material_coefficients_backward"] == 0,
                f"gn {name}: kernel 4b never runs")
        log("phase9_gn", document=name, exit_code=rc, converged=True,
            iterations=out["iterations"], max_abs_err=err,
            host_syncs=sum(r.host_syncs for _, _, r in phase_runs),
            launches={k: counts[k] for k in MATERIAL})
        launches[f"gn_{name}"] = counts["material_coefficients"]

    doc = pinn_grid_document(*FNR_GRID, max_iterations=FNR_GRID_ITERS)
    doc["solver_config"]["method"] = "full-nr"
    path = workdir / "fnr_grid.json"
    path.write_text(json.dumps(doc))
    torch.cuda.reset_peak_memory_stats(dev)
    with Spy(full_newton, "full_nr_phase") as phase_runs:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = main([str(path)])
        cli_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    require(rc == 0, "full-NR grid exit code 0")
    out = json.loads((workdir / "fnr_grid.res.json").read_text())
    zout = phase_runs[0][2]
    hist = out["history"]
    keys = list(hist[0])
    rows = np.array([[e[k] for k in keys] for e in hist])
    loss = rows[:, keys.index("loss_total")]
    require(len(hist) == FNR_GRID_ITERS or out["converged"],
            "full-NR grid ran its iterations or converged")
    require(bool(np.all(np.isfinite(rows))), "full-NR grid rows finite")
    require(all(loss[k + 1] < loss[k] for k in range(len(hist) - 1)
                if zout.accepted[k]),
            "full-NR grid loss falls at every accepted step")
    require(counts["material_coefficients"] == value_launches(zout, False),
            "full-NR grid: kernel 4 takes every value-only evaluation")
    require(counts["material_coefficients_backward"] == 0,
            "full-NR grid: kernel 4b never runs")
    launches["fnr_grid"] = counts["material_coefficients"]

    # ms per iteration by part, warm, one synchronize at each part's end.
    parsed = parse_problem_dict(doc)
    data = parsed.problem.to_device(dev)
    material = parsed.problem.material.to(dev)
    has_meas, mvals, mdofs = full_newton.measurements_on(
        data, parsed.measured_disp, parsed.measured_dofs)
    free_idx, u0 = full_newton.initial_state(parsed.problem, data, None)
    cfg = parsed.config

    def phase_args(iters, clock=None):
        return (data, material, set_theta, u0, get_theta(material), free_idx,
                1.0, mvals, mdofs, has_meas, iters, cfg.tolerance,
                cfg.full_nr_data_tolerance, cfg.learning_rate_u,
                cfg.learning_rate_theta, clock)

    seconds = {}
    mark = [0.0]

    def clock(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[part] = seconds.get(part, 0.0) + now - mark[0]
        mark[0] = now

    torch.cuda.synchronize()
    mark[0] = t0 = time.perf_counter()
    split_out = full_newton.full_nr_phase(*phase_args(FNR_SPLIT_ITERS, clock))
    split_s = time.perf_counter() - t0
    split_ms = {k: 1e3 * v / len(split_out.hist) for k, v in seconds.items()}
    # The gradient alone against the one call that gives H and g, at z0.
    space = ZSpace(data, material, set_theta, get_theta(material), free_idx)
    objective = FullNRLoss(space, 1.0, mvals, mdofs, has_meas)
    z0 = space.pack(u0)
    gradient = torch.func.grad(lambda z: objective.parts(z, True)[0])
    at_z0 = {"gradient_ms": cuda_ms(lambda: gradient(z0), 10),
             "gradient_and_hessian_ms": cuda_ms(
                 lambda: objective.hessian_and_gradient(z0), 5)}
    profile = full_nr_profile(phase_args, FNR_SPLIT_ITERS)

    # The same document on the CPU (the twin) for FNR_CPU_ROWS iterations.
    cpu_doc = dict(doc, pinn_config=dict(doc["pinn_config"],
                                         max_iterations=FNR_CPU_ROWS))
    cpu_path = workdir / "fnr_grid_cpu.json"
    cpu_path.write_text(json.dumps(cpu_doc))
    t0 = time.perf_counter()
    cpu = run(str(cpu_path), device="cpu")
    cpu_s = time.perf_counter() - t0
    hc = np.array([[e[k] for k in keys] for e in cpu["history"]])
    hg = rows[:FNR_CPU_ROWS]
    scale = np.maximum(np.abs(hc).max(axis=0), 1e-30)
    col_err = np.abs(hg - hc).max(axis=0) / scale
    first_err = float((np.abs(hg[0] - hc[0]) / scale).max())
    log("phase9_full_nr_grid", ndof=data.ndof, elements=data.nelm,
        n_z=int(free_idx.numel()) + sum(
            p.numel() for f in get_theta(material) for layer in f
            for p in layer),
        exit_code=rc, converged=out["converged"], history_length=len(hist),
        first_loss_total=float(loss[0]), last_loss_total=float(loss[-1]),
        accepted_steps=sum(zout.accepted), cli_s=cli_s,
        ms_per_iteration_cli=1e3 * cli_s / len(hist),
        ms_per_iteration_warm=1e3 * split_s / len(split_out.hist),
        ms_per_iteration_split=split_ms, ms_at_z0=at_z0,
        host_syncs_per_iteration=zout.host_syncs / len(hist),
        lm_tries_per_iteration=(zout.host_syncs - len(hist)) / len(hist),
        peak_memory_gib=peak_gb, launches={k: counts[k] for k in MATERIAL},
        profile=profile, cpu_twin_rows=len(cpu["history"]), cpu_twin_s=cpu_s,
        card_vs_cpu_max_rel_err=dict(zip(keys, col_err.tolist())),
        card_vs_cpu_first_row=first_err)
    require(len(cpu["history"]) == FNR_CPU_ROWS, "CPU twin run length")
    require(first_err <= FNR_FIRST_ROW_RTOL,
            f"full-NR first row within {FNR_FIRST_ROW_RTOL} of the CPU twin")
    require(float(col_err.max()) <= FNR_ROWS_RTOL,
            f"first {FNR_CPU_ROWS} full-NR rows within {FNR_ROWS_RTOL} of "
            "the CPU twin")
    return launches


def run_document(workdir: Path, name: str, doc: dict):
    """One document through main() twice: (result, displacements, the
    banded kernels' launches in the first run, its s, the warm run's s)."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.ops import kernels

    path = workdir / f"{name}.json"
    path.write_text(json.dumps(doc))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([str(path)])
    first_s = time.perf_counter() - t0
    launches = {k: kernels.launch_counts()[k] for k in BANDED}
    require(rc == 0, f"{name}: exit code 0")
    t0 = time.perf_counter()
    require(main([str(path)]) == 0, f"{name}: warm exit code 0")
    warm_s = time.perf_counter() - t0
    out = json.loads((workdir / f"{name}.res.json").read_text())
    u = np.asarray(out["displacements"], float).reshape(-1)
    require(bool(np.all(np.isfinite(u))) and u.size == len(doc["loads"]),
            f"{name}: finite displacements of the expected shape")
    for k in BANDED:
        require(launches[k] > 0, f"{name}: {k} launched")
    require(launches["dia_dir_matvec"] == launches["cg_update"],
            f"{name}: one update per direction pass")
    return out, u, launches, first_s, warm_s


def phase_truss_extensions(workdir: Path, dev, card: str):
    """Thermal and settlement documents on the 100 x 200 grid through
    main(), and the Green-Lagrange Newton at the dense limit (section 10
    of the module docstring).  Returns kernels 1-3's launches on each
    document."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import SolverConfig, TrussProblem, solve_nr
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.models.fields import Material

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    launches = {}

    doc = eg.thermal_grid_document(*GRID, tolerance=GRID_TOL, n_increments=2)
    out, u, counts, first_s, warm_s = run_document(workdir, "thermal", doc)
    th = doc["thermal"]
    f = np.asarray(doc["loads"], float) + eg.float64_thermal_loads(
        doc["nodes"], doc["elements"], th["alpha"], th["delta_t"])
    residual, u_err = float64_check(dict(doc, loads=f.tolist()), u)
    log("phase10_thermal", card=card, ndof=u.size,
        converged=out["converged"], history=out["history"],
        float64_residual=residual, u_rel_err_vs_scipy=u_err,
        first_in_process_s=first_s, warm_s=warm_s, launches=counts,
        # Two stencils a Newton iteration and one an increment (reactions).
        newton_iterations_both_increments=(counts["dia_matvec"] - 2) // 2,
        pcg_iterations=counts["cg_update"],
        max_alpha_dt=th["alpha"] * max(th["delta_t"]))
    require(out["converged"] is True, "thermal grid converged")
    require(residual <= GRID_TOL ** 0.5,
            "thermal float64 residual <= sqrt(tol)")
    require(u_err <= 1e-3, "thermal max|u - u_f64| / max|u_f64| <= 1e-3")
    launches["thermal"] = counts

    for name, top_load in (("settlement", SETTLE_TOP_LOAD),
                           ("settlement_only", 0.0)):
        doc = eg.settlement_grid_document(*GRID, top_load=top_load,
                                          tolerance=GRID_TOL)
        out, u, counts, first_s, warm_s = run_document(workdir, name, doc)
        u64, r64, _, _ = eg.float64_reference(doc)
        settled = np.asarray(doc["prescribed_displacements"]["dofs"])
        u_err = float(np.abs(u - u64).max() / np.abs(u64).max())
        r = np.asarray(out["reactions"], float).reshape(-1)
        r_err = float(np.abs(r[settled] - r64[settled]).max()
                      / np.abs(r64[settled]).max())
        log(f"phase10_{name}", card=card, ndof=u.size,
            converged=out["converged"], history=out["history"],
            u_rel_err_vs_scipy=u_err, settled_reactions_rel_err=r_err,
            settled_values_kept=bool(np.all(
                u[settled] == np.float32(doc["prescribed_displacements"]
                                         ["values"][0]))),
            first_in_process_s=first_s, warm_s=warm_s, launches=counts,
            newton_iterations=(counts["dia_matvec"] - 1) // 2,
            pcg_iterations=counts["cg_update"])
        require(u_err <= 1e-3, f"{name}: max|u - u_f64| / max|u_f64| <= 1e-3")
        require(r_err <= SETTLED_REACTIONS_RTOL,
                f"{name}: settled reactions within {SETTLED_REACTIONS_RTOL} "
                "of float64")
        if top_load:
            require(out["converged"] is True, f"{name} converged")
        else:
            # ROADMAP fault 3.9: no free load, so the banded residual is
            # divided by min_denominator and stays far above tol, as in
            # the JAX package.  Reported, not a failure.
            require(out["converged"] is False,
                    "settlement only: converged false, as the JAX package")
        launches[name] = counts

    nodes, elements, loads, fixed = eg.grid_arrays(*GL_GRID)
    problem = TrussProblem(nodes=nodes, elements=elements,
                           material=Material(young=1.0, area=1.0,
                                             density=1.0),
                           loads=loads * GL_LOAD, fixed_dofs=fixed,
                           dimension=2)
    require(problem.ndof <= 2048, "Green-Lagrange grid at the dense limit")
    cfg = SolverConfig(max_iterations=50, tolerance=1e-6)
    res = solve_nr(problem, cfg, 1.0, geometric_nonlinear=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_nr(problem, cfg, 1.0, geometric_nonlinear=True, device=dev)
    torch.cuda.synchronize()
    gl_s = time.perf_counter() - t0
    lin = solve_nr(problem, cfg, 1.0, device=dev)
    u = np.asarray(res.displacements, float).reshape(-1)
    f = problem.loads
    free = np.setdiff1d(np.arange(f.size), fixed)
    f_int = eg.float64_green_lagrange_force(nodes, elements, u)
    gl_residual = float(np.linalg.norm((f_int - f)[free])
                        / np.linalg.norm(f[free]))
    u_lin = np.asarray(lin.displacements, float).reshape(-1)
    gap = float(np.abs(u - u_lin).max() / np.abs(u).max())
    iters = res.history[0]["iterations"]
    singular = None
    try:
        solve_nr(TrussProblem(
            nodes=np.array([[0.0, 0.0], [1.0, 0.0]]),
            elements=np.array([[0, 1]]),
            material=Material(young=1.0, area=1.0, density=1.0),
            loads=np.array([0.0, 0.0, 1.0, 0.0]),
            fixed_dofs=np.array([0, 1]), dimension=2), device=dev)
    except RuntimeError as e:
        singular = str(e)
    log("phase10_green_lagrange", card=card, grid=list(GL_GRID),
        ndof=problem.ndof, converged=res.converged, history=res.history,
        float64_gl_residual=gl_residual, u_gap_vs_linear=gap, warm_s=gl_s,
        ms_per_newton_iteration=1e3 * gl_s / iters, singular_error=singular)
    require(res.converged, "Green-Lagrange grid converged")
    require(0.1 <= res.history[0]["max_strain"] <= 0.4,
            "Green-Lagrange strains of 10-40 %")
    require(gl_residual <= GL_RESIDUAL,
            f"float64 Green-Lagrange residual <= {GL_RESIDUAL}")
    require(gap >= 0.02, "Green-Lagrange u differs from the linear solve")
    require(singular == "Tangent stiffness became singular during solve",
            "singular tangent raises the JAX package's RuntimeError")
    return launches


def api_problem_payload(nodes, elements, loads, fixed, young, area) -> dict:
    """An api_* input document: dict nodes with the fixed / fixed_x /
    fixed_y flags of `fixed`, {"nodes": [i, j]} elements."""
    fixed = set(int(d) for d in fixed)
    node_dicts = []
    for i, (x, y) in enumerate(nodes):
        node = {"x": float(x), "y": float(y)}
        fx, fy = 2 * i in fixed, 2 * i + 1 in fixed
        if fx and fy:
            node["fixed"] = True
        elif fx or fy:
            node["fixed_x" if fx else "fixed_y"] = True
        node_dicts.append(node)
    return {"nodes": node_dicts,
            "elements": [{"nodes": [int(i), int(j)]} for i, j in elements],
            "material": {"young": young, "area": area},
            "loads": [float(v) for v in loads]}


def run_api(module, workdir: Path, name: str, payload: dict):
    """(exit code, output dict) of module.main([in, out]) on DEVICE."""
    inp, outp = workdir / f"{name}.in.json", workdir / f"{name}.out.json"
    inp.write_text(json.dumps(payload))
    rc = module.main([str(inp), str(outp)])
    return rc, json.loads(outp.read_text())


def idle_profile(fn) -> dict:
    """Device busy ms and idle share of fn() (torch.profiler)."""
    wall, events = profiled(fn)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (1e3 * wall) if events
            else None}


def phase_legacy_gd(dev, card: str) -> dict:
    """11(a): solve_pinn_gradient_descent on the 100 x 200 PINN grid."""
    import dataclasses

    import numpy as np
    import torch

    from pinn_fem_tpu_torch import (PINNGradientDescentConfig,
                                    solve_pinn_gradient_descent)
    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels

    doc = pinn_grid_document(*GRID)
    pc = doc["pinn_config"]
    parsed = parse_problem_dict(doc)
    problem, mat0 = parsed.problem, parsed.problem.material
    cfg = PINNGradientDescentConfig(
        max_iterations=LEGACY_GD_ITERS, tolerance=0.0,
        learning_rate_u=pc["learning_rate_u"],
        learning_rate_theta=pc["learning_rate_theta"],
        alpha_physics=pc["alpha_physics"], alpha_data=pc["alpha_data"])

    def run(iters, device):
        problem.material = mat0     # the JAX CLI's initial weights
        return solve_pinn_gradient_descent(
            problem, problem.loads, parsed.measured_disp,
            parsed.measured_dofs,
            dataclasses.replace(cfg, max_iterations=iters), device=device)

    def timed(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run(iters, dev)
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    run(5, dev)
    kernels.reset_launch_counts()
    res, wall = timed(LEGACY_GD_ITERS)
    launches = {k: kernels.launch_counts()[k] for k in MATERIAL}
    # The loop alone: the 300-iteration call less a 50-iteration one (the
    # call's setup, to_device and the weights' copy, cancels).
    _, wall_50 = timed(50)
    loop_ms = 1e3 * (wall - wall_50) / (LEGACY_GD_ITERS - 50)
    hist = res.history
    loss = [e["loss_total"] for e in hist]
    u = res.displacements.reshape(-1)
    profile = idle_profile(lambda: run(20, dev))
    t0 = time.perf_counter()
    cpu = run(LEGACY_CPU_ROWS, "cpu")
    cpu_s = time.perf_counter() - t0
    keys = list(hist[0])
    hc = np.array([[e[k] for k in keys] for e in cpu.history])
    hg = np.array([[e[k] for k in keys] for e in hist[:LEGACY_CPU_ROWS]])
    scale = np.maximum(np.abs(hc).max(axis=0), 1e-30)
    col_err = np.abs(hg - hc).max(axis=0) / scale
    first_err = float((np.abs(hg[0] - hc[0]) / scale).max())
    log("phase11a_legacy_gd", card=card, ndof=u.size,
        elements=len(doc["elements"]), iterations=len(hist),
        launches=launches, first_loss_total=loss[0],
        last_loss_total=loss[-1], wall_s=wall,
        ms_per_legacy_gd_iteration=loop_ms,
        call_ms_per_iteration=1e3 * wall / len(hist),
        call_setup_ms=1e3 * wall_50 - 50 * loop_ms,
        profile_20_iterations=profile, cpu_twin_rows=len(cpu.history),
        cpu_twin_s=cpu_s,
        card_vs_cpu_max_rel_err=dict(zip(keys, col_err.tolist())),
        card_vs_cpu_first_row=first_err)
    require(len(hist) == LEGACY_GD_ITERS, "legacy GD ran its budget")
    for name in MATERIAL:
        require(launches[name] == len(hist),
                f"{name}: one launch per legacy GD iteration")
    require(bool(np.all(np.isfinite(loss))) and loss[-1] < loss[0],
            "legacy GD loss finite and falls")
    require(bool(np.all(np.isfinite(u))) and u.size == 2 * GRID[0] * GRID[1],
            "legacy GD displacements finite, of the expected shape")
    require(len(cpu.history) == LEGACY_CPU_ROWS, "CPU twin run length")
    require(first_err <= GD_FIRST_ROW_RTOL,
            f"legacy GD first row within {GD_FIRST_ROW_RTOL} of the CPU twin")
    require(max(col_err) <= GD_ROWS_RTOL,
            f"legacy GD first {LEGACY_CPU_ROWS} rows within {GD_ROWS_RTOL} "
            "of the CPU twin")
    return launches


def phase_incremental_newton(workdir: Path, dev, card: str) -> dict:
    """11(b): api_fem_solver on the 32 x 32 grid, and
    solve_incremental_newton with three frozen MLP fields."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import (LegacySolverConfig, TrussProblem,
                                    solve_incremental_newton)
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.cli import _api_common, api_fem_solver
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels

    nodes, elements, loads, fixed = eg.grid_arrays(*LEGACY_GRID)
    loads = loads / LEGACY_GRID[0]
    payload = dict(api_problem_payload(nodes, elements, loads, fixed, 1.0,
                                       1.0),
                   solver_config={"n_increments": LEGACY_INCREMENTS,
                                  "max_iterations": 50, "tolerance": 1e-6})
    t0 = time.perf_counter()
    rc, out = run_api(api_fem_solver, workdir, "api_fem", payload)
    first_s = time.perf_counter() - t0
    require(rc == 0, "api_fem_solver exit code 0")
    t0 = time.perf_counter()
    require(run_api(api_fem_solver, workdir, "api_fem", payload)[0] == 0,
            "api_fem_solver warm exit code 0")
    warm_s = time.perf_counter() - t0
    u = np.asarray(out["displacements"], float)
    u64 = eg.float64_solution(nodes, elements, loads, fixed)
    _, strains64 = _api_common.element_stresses_2d(nodes, elements, u64, 1.0)
    u_err = float(np.abs(u - u64).max() / np.abs(u64).max())
    strains64 = np.asarray(strains64)
    s_err = float(np.abs(np.asarray(out["strains"]) - strains64).max()
                  / np.abs(strains64).max())
    hist = out["convergence_history"]
    newton = sum(int(e["iterations"]) for e in hist)
    log("phase11b_api_fem_solver", card=card, grid=list(LEGACY_GRID),
        ndof=u.size, converged=out["converged"], increments=len(hist),
        newton_iterations=newton, u_rel_err_vs_scipy=u_err,
        strains_rel_err_vs_float64=s_err, first_in_process_s=first_s,
        warm_s=warm_s, ms_per_increment=1e3 * warm_s / len(hist),
        ms_per_newton_iteration=1e3 * warm_s / newton)
    require(out["converged"] is True, "api_fem_solver converged")
    require(len(hist) == LEGACY_INCREMENTS,
            f"{LEGACY_INCREMENTS} history rows, one per increment")
    require(u_err <= LEGACY_U_RTOL,
            f"api_fem_solver u within {LEGACY_U_RTOL} of float64")
    require(s_err <= LEGACY_U_RTOL,
            f"api_fem_solver strains within {LEGACY_U_RTOL} of float64")

    material = parse_problem_dict(
        eg.pinn_grid_document(*LEGACY_GRID)).problem.material
    problem = TrussProblem(nodes=nodes, elements=elements, material=material,
                           loads=loads, fixed_dofs=fixed, dimension=2)
    cfg = LegacySolverConfig(n_increments=FROZEN_INCREMENTS)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_incremental_newton(problem, cfg, device=dev)
    torch.cuda.synchronize()
    frozen_s = time.perf_counter() - t0
    launches = {k: kernels.launch_counts()[k] for k in MATERIAL}
    cpu = solve_incremental_newton(problem, cfg, device="cpu")
    newton = sum(int(e["iterations"]) for e in res.history)
    uf, uc = res.displacements.reshape(-1), cpu.displacements.reshape(-1)
    frozen_err = float(np.abs(uf - uc).max() / np.abs(uc).max())
    log("phase11b_frozen_nn", card=card, grid=list(LEGACY_GRID),
        converged=res.converged, history=res.history,
        newton_iterations=newton, launches=launches,
        u_rel_err_vs_cpu_twin=frozen_err,
        cpu_iterations=[e["iterations"] for e in cpu.history],
        first_in_process_s=frozen_s)
    require(res.converged, "frozen-NN incremental Newton converged")
    require(launches["material_coefficients"] == newton + 1,
            "kernel 4 once per assembly: Newton iterations + reactions")
    require(launches["material_coefficients_backward"] == 0,
            "no kernel 4b on the frozen Newton path")
    require(frozen_err <= LEGACY_U_RTOL,
            f"frozen-NN u within {LEGACY_U_RTOL} of the CPU twin")
    return launches


def phase_scalar_identification(workdir: Path, dev, card: str):
    """11(c): api_pinn_nr and api_pinn_gd through main() on the card, and
    identify_scalars_gd's ms an iteration on the 40k grid."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import TrussProblem
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.cli import api_pinn_gd, api_pinn_nr
    from pinn_fem_tpu_torch.models.fields import Material
    from pinn_fem_tpu_torch.solvers.scalar_inverse import identify_scalars_gd

    si = {"nodes": [{"x": 0, "y": 0, "fixed": True},
                    {"x": 1, "y": 0, "fixed_y": True}],
          "elements": [{"nodes": [0, 1]}],
          "material": {"young": 100e9, "area": 0.01},
          "loads": [0, 0, 1e6, 0], "measured_disp": [5e-4],
          "measured_dofs": [2]}
    results = {}
    for name, module, config in (
            ("si_nr", api_pinn_nr, {"max_iterations": 60,
                                    "tolerance": 1e-10, "lambda_lm": 1e-3}),
            ("si_gd", api_pinn_gd, {"max_iterations": 2000,
                                    "learning_rate": 3e-3, "beta": 1e3})):
        rc, out = run_api(module, workdir, name,
                          dict(si, solver_config=config))
        require(rc == 0, f"{name}: exit code 0")
        ip = out["identified_params"]
        results[name] = ip["young"] * ip["area"]

    # The 16 x 32 grid in SI units: measurements on the right edge's
    # x-DOFs from a float64 solve at E A = SCALAR_EA.
    nodes, elements, loads, fixed = eg.grid_arrays(*SCALAR_GRID)
    loads = loads * 1e6 / SCALAR_GRID[0]
    u64 = eg.float64_solution(nodes, elements, loads, fixed) / SCALAR_EA
    mdofs = [2 * (r * SCALAR_GRID[1] + SCALAR_GRID[1] - 1)
             for r in range(SCALAR_GRID[0])]
    grid = dict(api_problem_payload(nodes, elements, loads, fixed, 100e9,
                                    0.01),
                measured_disp=u64[mdofs].tolist(), measured_dofs=mdofs,
                solver_config={"max_iterations": 30, "tolerance": 1e-10,
                               "lambda_lm": 1e-3})
    t0 = time.perf_counter()
    rc, out = run_api(api_pinn_nr, workdir, "grid_nr", grid)
    grid_s = time.perf_counter() - t0
    require(rc == 0, "api_pinn_nr on the grid: exit code 0")
    ip = out["identified_params"]
    results["grid_nr"] = ip["young"] * ip["area"]
    grid_rows = len(out["convergence_history"])
    grid_u_err = float(np.abs(np.asarray(out["displacements"]) - u64).max()
                       / np.abs(u64).max())

    rc, missing = run_api(api_pinn_gd, workdir, "no_meas",
                          {k: v for k, v in si.items()
                           if not k.startswith("measured")})

    # identify_scalars_gd on the 100 x 200 grid: no kernel, no host read
    # inside the loop.
    nodes, elements, loads, fixed = eg.grid_arrays(*GRID)
    loads = loads * 1e6 / GRID[0]
    u64 = eg.float64_solution(nodes, elements, loads, fixed) / SCALAR_EA
    free = np.setdiff1d(np.arange(loads.size), fixed)[::10]
    problem = TrussProblem(nodes=nodes, elements=elements,
                           material=Material(young=100e9, area=0.01,
                                             density=0.0),
                           loads=loads, fixed_dofs=fixed, dimension=2)
    kw = dict(u_measured=u64[free], measured_dofs=free, young_init=100e9,
              area_init=0.01, learning_rate=SCALAR_GD_LR, beta=1e3)
    identify_scalars_gd(problem, loads, n_iterations=5, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gd = identify_scalars_gd(problem, loads, n_iterations=SCALAR_GD_ITERS,
                             device=dev, **kw)
    torch.cuda.synchronize()
    gd_s = time.perf_counter() - t0
    profile = idle_profile(lambda: identify_scalars_gd(
        problem, loads, n_iterations=20, device=dev, **kw))
    loss = [e["loss_total"] for e in gd["history"]]
    rel = {k: abs(v - SCALAR_EA) / SCALAR_EA for k, v in results.items()}
    log("phase11c_scalar_identification", card=card,
        ea_rel_err=rel, grid=list(SCALAR_GRID), grid_nr_rows=grid_rows,
        grid_nr_s=grid_s, grid_nr_u_rel_err_vs_float64=grid_u_err,
        missing_measurements=[rc, missing],
        scalar_gd_grid=list(GRID), scalar_gd_iterations=len(loss),
        scalar_gd_first_loss=loss[0], scalar_gd_last_loss=loss[-1],
        scalar_gd_ea_rel_err=abs(gd["young_final"] * gd["area_final"]
                                 - SCALAR_EA) / SCALAR_EA,
        ms_per_scalar_gd_iteration=1e3 * gd_s / len(loss),
        profile_20_iterations=profile)
    for name, err in rel.items():
        require(err <= 1e-3, f"{name}: E A within 1e-3 of {SCALAR_EA}")
    require(rc == 1 and "measured_disp" in missing.get("error", ""),
            "api_pinn_gd without measurements exits 1 with the error")
    require(len(loss) == SCALAR_GD_ITERS and bool(np.all(np.isfinite(loss)))
            and loss[-1] < loss[0], "scalar GD ran its budget, loss falls")


def phase_legacy_generic(workdir: Path, card: str):
    """11(d): the legacy web NN payload (input_dim 1: the torch form)
    through legacy_generic.main() on the card."""
    import numpy as np

    from pinn_fem_tpu_torch.cli import legacy_generic
    from pinn_fem_tpu_torch.ops import kernels

    sub = workdir / "legacy"
    sub.mkdir()
    path = sub / "legacy_nn.json"
    path.write_text(json.dumps(LEGACY_WEB_NN))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = legacy_generic.main([str(path)])
    wall = time.perf_counter() - t0
    launches = {k: kernels.launch_counts()[k] for k in MATERIAL}
    logs = sorted(p.name for p in sub.glob("legacy_nn_????????_??????.log"))
    out = json.loads((sub / "legacy_nn.res.json").read_text())
    u = np.asarray(out["displacements"], float)
    err = float(np.abs(u[[2, 4, 6]] - [1.0, 2.0, 3.0]).max())
    log("phase11d_legacy_generic", card=card, exit_code=rc, logs=logs,
        iterations=out.get("iterations"), max_abs_err=err, wall_s=wall,
        launches=launches)
    require(rc == 0, "legacy_generic exit code 0")
    require(len(logs) == 1, "one timestamped legacy_nn log")
    require(err <= 1e-2, "legacy web NN u within 1e-2 of [1, 2, 3]")
    require("identified_properties" in out, "identified_properties written")
    require(launches["material_coefficients"] == 0,
            "input_dim 1 takes the torch form: kernel 4 not launched")


def phase_x64(workdir: Path, dev, card: str):
    """11(e): PINN_FEM_TPU_X64=1 on the card: the dense path in float64,
    the banded 40k document refused at kernel 1's dispatch."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.examples_grid import grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_file
    from pinn_fem_tpu_torch.ops import kernels

    sub = workdir / "x64"
    sub.mkdir()
    os.environ["PINN_FEM_TPU_X64"] = "1"
    path = sub / "example1.json"
    path.write_text((ROOT / "examples" / "json" / "example1.json")
                    .read_text())
    dtype = str(parse_problem_file(path).problem.to_device(dev).loads.dtype)
    rc = main([str(path)])
    out = json.loads((sub / "example1.res.json").read_text())
    err = float(np.abs(np.asarray(out["displacements"])
                       - [0, 0, 1, 0, 2, 0, 3, 0]).max())
    grid = sub / "grid.json"
    grid.write_text(json.dumps(grid_document(*GRID, tolerance=GRID_TOL)))
    kernels.reset_launch_counts()
    grid_rc = main([str(grid)])
    launches = kernels.launch_counts()
    refusal = [line for line in (sub / "grid.log").read_text().splitlines()
               if "[ERROR]" in line]
    del os.environ["PINN_FEM_TPU_X64"]
    log("phase11e_x64", card=card, dtype=dtype, example1_exit_code=rc,
        example1_max_abs_err=err, grid_exit_code=grid_rc,
        grid_refusal=refusal, launches=launches)
    require(dtype == "torch.float64", "X64: float64 arrays on the card")
    require(rc == 0 and out["converged"] is True and err <= 1e-12,
            "X64 example1 on the card within 1e-12 of [0, 1, 2, 3]")
    require(grid_rc == 1 and any("PINN_FEM_TPU_X64" in line
                                 and "dia_matvec" in line
                                 for line in refusal),
            "X64 40k grid document: exit 1 with the kernels' refusal")
    require(not any(launches.values()), "no kernel launched under X64")


def phase_api(workdir: Path, dev, card: str) -> dict:
    """Phase 11: the Node backend's JSON API entry points.  Returns kernel
    4 and 4b's launches on (a) and (b)."""
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    legacy = {"legacy_gd": phase_legacy_gd(dev, card)}
    legacy["incremental_newton"] = phase_incremental_newton(workdir, dev,
                                                            card)
    phase_scalar_identification(workdir, dev, card)
    phase_legacy_generic(workdir, card)
    phase_x64(workdir, dev, card)
    return legacy


def rel_err(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, float).reshape(-1), np.asarray(b, float).reshape(-1)
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_gather_cli(workdir: Path, dev, card: str, phase4: dict) -> dict:
    """12(a): the shuffled 100 x 200 grid document through main(): no
    banded layout, so the gather-based PCG; no repo kernel launches.
    Returns the document, its node order and u in the original
    numbering."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.examples_grid import (grid_document,
                                                  shuffled_document)
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import cg, kernels
    from pinn_fem_tpu_torch.ops.reorder import restore_field
    from pinn_fem_tpu_torch.solvers.newton import _dia_layout_of

    doc = grid_document(*GRID, tolerance=GRID_TOL, n_increments=2)
    sdoc, order = shuffled_document(doc, seed=SHUFFLE_SEED)
    problem = parse_problem_dict(sdoc).problem
    data = problem.to_device(dev)
    require(_dia_layout_of(problem, data) is None,
            "the shuffled grid has no banded layout")
    path = workdir / "shuffled.json"
    path.write_text(json.dumps(sdoc))
    kernels.reset_launch_counts()
    with Spy(cg, "cg_solve") as solves:
        t0 = time.perf_counter()
        rc = main([str(path)])
        first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require(rc == 0, "shuffled grid: exit code 0")
    t0 = time.perf_counter()
    require(main([str(path)]) == 0, "shuffled grid: warm exit code 0")
    warm_s = time.perf_counter() - t0
    out = json.loads((workdir / "shuffled.res.json").read_text())
    u = restore_field(np.asarray(out["displacements"], float), order, 2)
    require(bool(np.all(np.isfinite(u))) and u.size == 2 * GRID[0] * GRID[1],
            "shuffled grid: finite displacements of the expected shape")
    residual, u_err = float64_check(doc, u)
    pcg_iterations = sum(int(res[1]) for _, _, res in solves)

    # ms per PCG iteration, and the device's idle share over
    # GATHER_PROFILE_ITERS iterations, on the shuffled grid's first solve.
    s = cg.stiffness_coefficients(data, problem.material, 1.0)
    rhs = data.loads.clone()

    def solve(n):
        return lambda: cg.cg_solve(data, s, rhs, tol=0.0, max_iter=n)

    solve(GATHER_PROFILE_ITERS)()
    times = {}
    for n in (0, GATHER_TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(n)()
        torch.cuda.synchronize()
        times[n] = time.perf_counter() - t0
    ms_per_iteration = 1e3 * (times[GATHER_TIMED_ITERS] - times[0]) \
        / GATHER_TIMED_ITERS
    idle = idle_profile(solve(GATHER_PROFILE_ITERS))
    log("phase12_gather_cli", card=card, ndof=u.size,
        converged=out["converged"], history=out["history"],
        float64_residual=residual, u_rel_err_vs_scipy=u_err,
        first_in_process_s=first_s, warm_s=warm_s, launches=launches,
        newton_iterations=len(solves), pcg_iterations=pcg_iterations,
        phase4_newton_iterations=(phase4["dia_matvec"] - 2) // 2,
        phase4_pcg_iterations=phase4["cg_update"],
        ms_per_pcg_iteration=ms_per_iteration,
        gather_map_shape=list(data.gather_map.shape),
        profile_iterations=GATHER_PROFILE_ITERS, profile=idle)
    require(out["converged"] is True, "shuffled grid converged")
    require(not any(launches.values()),
            "the gather path launches no repo kernel")
    require(residual <= GRID_TOL ** 0.5, "float64 residual <= sqrt(tol)")
    require(u_err <= GATHER_U_RTOL,
            f"shuffled grid: u within {GATHER_U_RTOL} of float64")
    return {"doc": sdoc, "order": order, "u": u, "launches": launches}


def phase_rcm(workdir: Path, dev, card: str, gathered: dict) -> dict:
    """12(b): reorder_problem on the shuffled 100 x 200 grid (RCM's host
    time and implementation; its band against the diagonal budget) and
    its solve_nr, u mapped back; then the shuffled RCM_GRID grid, which RCM
    puts back on the banded operator: kernels 1-3, u against float64 and
    against its gather solve."""
    import numpy as np

    from pinn_fem_tpu_torch import SolverConfig, solve_nr
    from pinn_fem_tpu_torch.examples_grid import (float64_solution,
                                                  grid_document,
                                                  shuffled_document)
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.dia import dia_layout
    from pinn_fem_tpu_torch.ops.reorder import reorder_problem, restore_field
    from pinn_fem_tpu_torch.solvers.newton import _dia_layout_of
    from pinn_fem_tpu_torch.utils import native

    implementation = "native" if native.available() else "numpy"
    problem = parse_problem_dict(gathered["doc"]).problem
    t0 = time.perf_counter()
    reordered, order = reorder_problem(problem)
    rcm_s = time.perf_counter() - t0
    data = reordered.to_device(dev)
    band = dia_layout(data.dof_map.cpu().numpy(), reordered.ndof,
                      max_diags=10 ** 6)
    layout = _dia_layout_of(reordered, data)
    cfg = SolverConfig(tolerance=GRID_TOL, max_iterations=20)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_nr(reordered, cfg, 1.0, data=data)
    solve_s = time.perf_counter() - t0
    launches_40k = kernels.launch_counts()
    u = restore_field(restore_field(res.displacements, order, 2),
                      gathered["order"], 2)
    doc40k = grid_document(*GRID, tolerance=GRID_TOL)
    _, u_err = float64_check(doc40k, u)
    vs_a = rel_err(u, gathered["u"])
    log("phase12_rcm_40k", card=card, implementation=implementation,
        rcm_host_s=rcm_s, diagonals=band.n_diags, bandwidth=band.bandwidth,
        banded_layout=layout is not None, solve_s=solve_s,
        converged=res.converged, history=res.history,
        launches=launches_40k, u_rel_err_vs_scipy=u_err,
        u_rel_vs_gather_cli=vs_a)
    require(res.converged, "RCM 40k grid converged")
    require(u_err <= GATHER_U_RTOL, "RCM 40k grid: u within 1e-3 of float64")
    require(vs_a <= GATHER_VS_BANDED_RTOL,
            f"RCM 40k grid: u within {GATHER_VS_BANDED_RTOL} of 12(a)")

    doc, _ = shuffled_document(grid_document(*RCM_GRID, tolerance=GRID_TOL),
                               seed=SHUFFLE_SEED)
    problem = parse_problem_dict(doc).problem
    gather = solve_nr(problem, cfg, 1.0, device=dev)
    t0 = time.perf_counter()
    reordered, order = reorder_problem(problem)
    rcm_s = time.perf_counter() - t0
    data = reordered.to_device(dev)
    layout = _dia_layout_of(reordered, data)
    require(layout is not None, f"RCM {RCM_GRID}: a banded layout")
    kernels.reset_launch_counts()
    res = solve_nr(reordered, cfg, 1.0, data=data)
    launches = kernels.launch_counts()
    u = restore_field(res.displacements, order, 2)
    u64 = float64_solution(doc["nodes"], doc["elements"],
                           np.asarray(doc["loads"], float), doc["fixed_dofs"])
    u_err, vs_gather = rel_err(u, u64), rel_err(u, gather.displacements)
    log("phase12_rcm_banded", card=card, grid=list(RCM_GRID),
        implementation=implementation, rcm_host_s=rcm_s,
        diagonals=layout.n_diags, converged=res.converged,
        history=res.history, launches=launches, u_rel_err_vs_scipy=u_err,
        u_rel_vs_gather=vs_gather)
    require(res.converged and gather.converged, f"RCM {RCM_GRID} converged")
    for k in BANDED:
        require(launches[k] > 0, f"RCM {RCM_GRID}: {k} launched")
    require(launches["dia_dir_matvec"] == launches["cg_update"],
            f"RCM {RCM_GRID}: one update per direction pass")
    require(u_err <= GATHER_U_RTOL, f"RCM {RCM_GRID}: u within 1e-3 of "
            "float64")
    require(vs_gather <= GATHER_VS_BANDED_RTOL,
            f"RCM {RCM_GRID}: u within {GATHER_VS_BANDED_RTOL} of the "
            "gather solve")
    return {"rcm_40k": launches_40k, "rcm_banded": launches}


def phase_gather_vs_banded(dev, card: str) -> dict:
    """12(c): the gather and the banded Newton cores on one ProblemData of
    the natural 100 x 200 grid, and one gather K u against kernel 1's."""
    import torch

    from pinn_fem_tpu_torch import SolverConfig
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.cg import (apply_stiffness,
                                           stiffness_coefficients)
    from pinn_fem_tpu_torch.ops.dia import assemble_dia, dia_matvec
    from pinn_fem_tpu_torch.solvers.newton import (_dia_layout_of,
                                                   _nr_core_cg, _nr_dia_core)

    problem = grid_problem(*GRID)
    data = problem.to_device(dev)
    layout = _dia_layout_of(problem, data)
    cfg = SolverConfig(tolerance=GRID_TOL, max_iterations=20)
    lf = torch.tensor(1.0, device=dev)
    u0 = torch.zeros(problem.ndof, device=dev)
    args = (cfg.max_iterations, cfg.tolerance, cfg.min_denominator)
    cg_tol = max(cfg.tolerance * 0.1, 5e-8)
    runs, launches = {}, {}
    for name, core in (
            ("banded", lambda: _nr_dia_core(
                layout, data, problem.material, u0, lf, *args, cg_tol=cg_tol,
                cg_max_iter=min(max(20 * problem.ndof, 1000), 100_000))),
            ("gather", lambda: _nr_core_cg(
                data, problem.material, u0, lf, *args, cg_tol=cg_tol,
                cg_max_iter=max(20 * problem.ndof, 1000)))):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = core()
        torch.cuda.synchronize()
        runs[name] += (time.perf_counter() - t0,)
        launches[name] = kernels.launch_counts()
    u_b, u_g = runs["banded"][0], runs["gather"][0]
    # K u of a random u (at the solution K u is the load, a difference of
    # entries far larger than itself).
    s = stiffness_coefficients(data, problem.material, 1.0)
    gen = torch.Generator(device=dev).manual_seed(SHUFFLE_SEED)
    u = torch.randn(problem.ndof, generator=gen, device=dev)
    ku_stencil = dia_matvec(layout, assemble_dia(layout, s, data.gvec), u)
    ku_gather = apply_stiffness(data, s, u)
    matvec_err = rel_err(ku_gather.cpu(), ku_stencil.cpu())
    u_gap = rel_err(u_g.cpu(), u_b.cpu())
    log("phase12_gather_vs_banded", card=card, ndof=problem.ndof,
        newton_iterations={k: v[2] for k, v in runs.items()},
        residual={k: float(v[3]) for k, v in runs.items()},
        converged={k: v[4] for k, v in runs.items()},
        solve_s={k: v[6] for k, v in runs.items()}, launches=launches,
        u_rel_gap=u_gap, matvec_rel_err=matvec_err)
    require(runs["banded"][4] and runs["gather"][4],
            "natural grid: both cores converged")
    require(abs(runs["banded"][2] - runs["gather"][2]) <= 1,
            "natural grid: Newton counts within one (fault 3.5)")
    require(u_gap <= GATHER_VS_BANDED_RTOL,
            f"natural grid: gather u within {GATHER_VS_BANDED_RTOL} of banded")
    require(matvec_err <= GATHER_MATVEC_RTOL,
            f"gather K u within {GATHER_MATVEC_RTOL} of the stencil's")
    require(not any(launches["gather"].values()),
            "the gather core launches no repo kernel")
    return launches["banded"]


def phase_resume(workdir: Path, dev, card: str) -> dict:
    """12(d): checkpoint and resume on the card: the 100 x 200 grid as an
    nr run (2 increments) and the 100 x 200 PINN grid as a GD run."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import SolverConfig, solve
    from pinn_fem_tpu_torch.examples_grid import (grid_problem,
                                                  pinn_grid_document)
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers.gd import get_theta
    from pinn_fem_tpu_torch.utils.checkpoint import (load_increment_state,
                                                     save_increment_state)

    def nr(n_increments=2, lf=1.0, **kw):
        cfg = SolverConfig(method="nr", tolerance=GRID_TOL, max_iterations=20,
                           n_increments=n_increments, load_factor_final=lf)
        kernels.reset_launch_counts()
        res = solve(grid_problem(*GRID), cfg, verbose=False, device=dev, **kw)
        return res, kernels.launch_counts()

    whole, launches_whole = nr(checkpoint_dir=str(workdir / "nr_full"))
    meta = json.loads((workdir / "nr_full" / "meta.json").read_text())
    require((workdir / "nr_full" / "state.msgpack").exists()
            and meta["increment"] == 2, "nr: state.msgpack after increment 2")
    # The driver's own state after increment 1 (a one-increment run to lf
    # 0.5), resumed: the last increment runs from the same u as in the
    # uninterrupted run.
    ckpt = str(workdir / "nr_ckpt")
    nr(1, 0.5, checkpoint_dir=ckpt)
    resumed, launches_resumed = nr(checkpoint_dir=ckpt, resume=True)
    gap = rel_err(resumed.displacements, whole.displacements)
    newton = int(resumed.history[0]["iterations"])
    # As tests/test_aux.py writes it: increment 1 as half of the final u.
    save_increment_state(ckpt, 1, whole.displacements.reshape(-1) * 0.5, [])
    halved, _ = nr(checkpoint_dir=ckpt, resume=True)
    gap_halved = rel_err(halved.displacements, whole.displacements)

    doc = pinn_grid_document(*GRID, max_iterations=RESUME_GD_ITERS,
                             tolerance=RESUME_GD_TOL)
    doc["solver_config"] = {"n_increments": 2}
    gd_ckpt = str(workdir / "gd_ckpt")
    parsed = parse_problem_dict(doc)
    kernels.reset_launch_counts()
    gd = solve(parsed.problem, parsed.config, parsed.measured_disp,
               parsed.measured_dofs, verbose=False, device=dev,
               checkpoint_dir=gd_ckpt)
    launches_gd = kernels.launch_counts()
    saved = get_theta(parsed.problem.material)
    inc, _, theta = load_increment_state(gd_ckpt, saved)
    same = all(torch.equal(a, b) and a.device == b.device
               for la, lb in zip(theta, saved) for pa, pb in zip(la, lb)
               for a, b in zip(pa, pb))
    again = parse_problem_dict(doc)
    gd_resumed = solve(again.problem, again.config, again.measured_disp,
                       again.measured_dofs, verbose=False, device=dev,
                       checkpoint_dir=gd_ckpt, resume=True)
    log("phase12_resume", card=card, nr_launches_whole=launches_whole,
        nr_launches_resumed=launches_resumed,
        nr_resumed_newton_iterations=newton, nr_u_rel_gap=gap,
        nr_u_rel_gap_halved_state=gap_halved, gd_increment_saved=inc,
        gd_rows=[len(gd.history), len(gd_resumed.history)],
        gd_launches=launches_gd, gd_theta_bit_equal_on_card=same,
        theta_device=str(theta[0][0][0].device))
    require(resumed.converged and whole.converged, "nr runs converged")
    require(gap <= RESUME_RTOL, f"resumed nr u within {RESUME_RTOL}")
    require(gap_halved <= GATHER_U_RTOL,
            f"resumed from the halved state within {GATHER_U_RTOL}")
    require(launches_resumed["dia_matvec"] == 2 * newton + 1,
            "resume: kernel 1 only for the re-run increment")
    require(0 < launches_resumed["dia_dir_matvec"]
            < launches_whole["dia_dir_matvec"],
            "resume: kernel 2 only for the re-run increment")
    require(gd.converged and gd_resumed.converged and inc == 2,
            "GD increments converged and saved")
    require(same, "theta resumed on the card equals the saved theta")
    require(np.all(np.isfinite(gd_resumed.displacements)),
            "finite GD displacements after the resume")
    return {"resume_nr": launches_resumed, "resume_gd": launches_gd}


def phase_meshes(workdir: Path, dev, card: str, phase4: dict) -> dict:
    """Phase 12: meshes without a banded layout, RCM, and checkpoint /
    resume.  Returns the kernels' launches on each of its paths."""
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    gathered = phase_gather_cli(workdir, dev, card, phase4)
    launches = {"gather_cli": gathered["launches"]}
    launches.update(phase_rcm(workdir, dev, card, gathered))
    launches["banded_core_40k"] = phase_gather_vs_banded(dev, card)
    launches.update(phase_resume(workdir, dev, card))
    return launches


TRANSIENT_STEPS = 2000
TRANSIENT_EVERY = 20
TRANSIENT_CPU_STEPS = 200
TRANSIENT_F64_RTOL = 1e-3
TRANSIENT_CPU_RTOL = 1e-5
IDLE_STEPS = 200
CHAIN_STEPS = (4000, 400)
NEWMARK_STEPS = 200
NEWMARK_EVERY = 10
NEWMARK_DT_FACTOR = 10.0
NEWMARK_CPU_STEPS = 20
NEWMARK_CPU_RTOL = 2e-3
NEWMARK_F64_RTOL = 1e-3
MOVING_STEPS = 400
MOVING_CPU_STEPS = 200
MOVING_CPU_RTOL = 1e-4
CHECKPOINT_EVERY = 500
CHECKPOINT_RTOL = 1e-6
GL_DYN_GRID = (32, 32)
GL_DYN_LOAD = 0.05
GL_DYN_STEPS = 200
GL_NEWMARK_STEPS = 10
GL_DYN_RTOL = 1e-4
GL_NEWMARK_RTOL = 2e-3


def transient_document(workdir: Path, name: str, doc: dict, twice=False,
                       records=None):
    """A transient document through main() (twice: cold and warm):
    (result, all five kernels' launches in the first run, its s, the
    warm run's s or None).  records: the history's length (default all
    n_steps / record_every snapshots)."""
    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.ops import kernels

    path = workdir / f"{name}.json"
    path.write_text(json.dumps(doc))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([str(path)])
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require(rc == 0, f"{name}: exit code 0")
    warm_s = None
    if twice:
        t0 = time.perf_counter()
        require(main([str(path)]) == 0, f"{name}: warm exit code 0")
        warm_s = time.perf_counter() - t0
    out = json.loads((workdir / f"{name}.res.json").read_text())
    u = out["displacements"]
    an = doc["analysis"]
    n_rec = records or an["n_steps"] // an["record_every"]
    import numpy as np

    require(np.asarray(u).shape[0] == n_rec
            and bool(np.all(np.isfinite(u))),
            f"{name}: finite history of {n_rec} records")
    return out, launches, first_s, warm_s


def history_gap(a, b) -> float:
    """max |a - b| over max |b| of two records (u or v histories)."""
    return rel_err(a, b)


def cpu_twin(problem_doc: dict, n_steps: int, dt: float, **analysis):
    """The document's transient on the CPU (the kernels' twins) for
    n_steps at dt: the run_analysis result dict."""
    from pinn_fem_tpu_torch.io.analysis import run_analysis
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict

    an = dict(problem_doc["analysis"], n_steps=n_steps, dt=dt, **analysis)
    an.pop("checkpoint", None)
    return run_analysis(parse_problem_dict(problem_doc).problem, an, "cpu")


def phase_transient_grid(workdir: Path, dev, card: str) -> dict:
    """13(a): the 100 x 200 grid as a central transient document."""
    import numpy as np

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch import solve_transient
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict

    n, every = TRANSIENT_STEPS, TRANSIENT_EVERY
    doc = eg.transient_grid_document(*GRID, n_steps=n, record_every=every)
    out, launches, first_s, warm_s = transient_document(
        workdir, "transient_grid", doc, twice=True)
    t0 = time.perf_counter()
    ref = eg.float64_transient(doc, out["dt"])
    f64_s = time.perf_counter() - t0
    f64_gap = history_gap(out["displacements"], ref["displacements"])
    f64_v_gap = history_gap(out["velocities"], ref["velocities"])
    k = TRANSIENT_CPU_STEPS // every
    t0 = time.perf_counter()
    cpu = cpu_twin(doc, TRANSIENT_CPU_STEPS, out["dt"])
    cpu_s = time.perf_counter() - t0
    cpu_gap = history_gap(np.asarray(out["displacements"])[:k],
                          cpu["displacements"])
    problem = parse_problem_dict(doc).problem
    data = problem.to_device(dev)
    probe = np.asarray(out["probe_dofs"])

    def steps(count):
        return solve_transient(problem, out["dt"], count, data=data,
                               damping=tuple(doc["analysis"]["damping"]),
                               record_every=count, probe_dofs=probe,
                               fetch_state=False)

    steps(IDLE_STEPS)
    idle = idle_profile(lambda: steps(IDLE_STEPS))
    expected = 1 + n + 2 * n // every
    log("phase13_transient_grid", card=card, ndof=problem.ndof,
        dt=out["dt"], n_steps=n, record_every=every,
        first_in_process_s=first_s, warm_s=warm_s,
        warm_ms_per_step=1e3 * warm_s / n, launches=launches,
        predicted_dia_matvec=expected, u_rel_err_vs_float64=f64_gap,
        v_rel_err_vs_float64=f64_v_gap, float64_s=f64_s,
        u_rel_err_vs_cpu_twin_first_steps=cpu_gap, cpu_twin_s=cpu_s,
        profile_steps=IDLE_STEPS,
        ms_per_step_profiled=idle["wall_ms"] / IDLE_STEPS, **idle)
    require(launches["dia_matvec"] == expected,
            f"transient grid: kernel 1 launched 1 + n + 2n/r = {expected}")
    require(not any(launches[k] for k in launches if k != "dia_matvec"),
            "transient grid: kernels 2, 3, 4 and 4b not launched")
    require(f64_gap <= TRANSIENT_F64_RTOL,
            f"transient grid: u within {TRANSIENT_F64_RTOL} of float64")
    require(cpu_gap <= TRANSIENT_CPU_RTOL,
            f"transient grid: first {TRANSIENT_CPU_STEPS} steps within "
            f"{TRANSIENT_CPU_RTOL} of the CPU twin")
    return {"doc": doc, "out": out, "launches": launches}


def phase_transient_chain(dev, card: str) -> dict:
    """13(b): the 2,000,002-DOF chain at bench.py's setting, and the
    wave-front check of tests/test_dynamics.py after a short pulse."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import TrussProblem, solve_transient, stable_dt
    from pinn_fem_tpu_torch.examples_grid import chain_problem
    from pinn_fem_tpu_torch.ops import kernels

    p = chain_problem(CHAIN_NODES)
    data = p.to_device(dev)
    dt = stable_dt(p, data)
    probe = np.array([p.ndof - 2])

    def run(n):
        res = solve_transient(p, dt=dt, n_steps=n, method="central",
                              record_every=n, probe_dofs=probe, data=data,
                              fetch_state=False)
        return res.displacements

    long, short = CHAIN_STEPS
    kernels.reset_launch_counts()
    run(long)
    launches = kernels.launch_counts()
    run(short)

    def med(n):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t_long, t_short = med(long), med(short)
    ms_step = 1e3 * (t_long - t_short) / (long - short)
    idle = idle_profile(lambda: run(IDLE_STEPS))

    # Wave front: a 10-step pulse at node 1's x-DOF, 0.5 x stable_dt; the
    # front moves at c = 1 (E = rho = 1).
    loads = np.zeros(p.ndof)
    loads[2] = 1.0
    kick = TrussProblem(p.nodes, p.elements, p.material, loads,
                        p.fixed_dofs, 2)
    kick_data = kick.to_device(dev)
    n_wave = 200
    amp = np.zeros(n_wave)
    amp[:10] = 1.0
    wave_dt = 0.5 * dt
    axial = 2 * np.arange(2000)
    res = solve_transient(kick, wave_dt, n_wave, amplitude=amp,
                          record_every=n_wave, probe_dofs=axial,
                          data=kick_data, fetch_state=False)
    u = res.displacements[-1]
    front = int(np.ceil(wave_dt * n_wave)) + 2
    arrived = float(np.abs(u[:front]).max())
    beyond = float(np.abs(u[2 * front:]).max())
    log("phase13_transient_chain", card=card, ndof=p.ndof, dt=dt,
        steps=[long, short], median_s=[t_long, t_short],
        ms_per_step=ms_step, launches=launches,
        predicted_dia_matvec=long + 3, profile_steps=IDLE_STEPS,
        ms_per_step_profiled=idle["wall_ms"] / IDLE_STEPS, **idle,
        wave_front_node=front, wave_max_behind=arrived,
        wave_max_beyond_twice=beyond)
    require(launches["dia_matvec"] == long + 3,
            "chain: kernel 1 launched 1 + n + 2 times (one record)")
    require(bool(np.isfinite(arrived)) and arrived > 1e-6,
            "chain: the wave arrived behind the front")
    require(beyond < 1e-8, "chain: quiet beyond twice the front")
    return launches


def phase_newmark_grid(workdir: Path, dev, card: str) -> dict:
    """13(c): Newmark on the 100 x 200 grid through main()."""
    import numpy as np

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch import solve_transient, stable_dt
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict

    damping = [0.05, 1e-3]
    problem = eg.grid_problem(*GRID)
    dt = NEWMARK_DT_FACTOR * stable_dt(problem, damping=tuple(damping),
                                       device=dev)
    n, every = NEWMARK_STEPS, NEWMARK_EVERY
    doc = eg.transient_grid_document(*GRID, method="newmark", dt=dt,
                                     damping=damping, n_steps=n,
                                     record_every=every)
    out, launches, first_s, _ = transient_document(workdir, "newmark_grid",
                                                   doc)
    problem = parse_problem_dict(doc).problem
    data = problem.to_device(dev)
    import torch

    from pinn_fem_tpu_torch.ops import dia, kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with Spy(dia, "dia_cg_solve") as solves:
        solve_transient(problem, dt, n, method="newmark", data=data,
                        damping=tuple(damping), record_every=every,
                        probe_dofs=np.asarray(out["probe_dofs"]))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    stats_launches = kernels.launch_counts()
    iters = torch.stack([r[1] for _, _, r in solves]).cpu().numpy()
    # The fused PCG reads its flag every CHECK_EVERY = 32 iterations, so
    # it runs the iterations rounded up to 32 (the last rounds frozen).
    rounds = 32 * np.ceil(iters / 32)
    ref = eg.float64_transient(doc, dt)
    f64_gap = history_gap(out["displacements"], ref["displacements"])
    k = NEWMARK_CPU_STEPS // every
    t0 = time.perf_counter()
    cpu = cpu_twin(doc, NEWMARK_CPU_STEPS, dt)
    cpu_s = time.perf_counter() - t0
    cpu_gap = history_gap(np.asarray(out["displacements"])[:k],
                          cpu["displacements"])
    log("phase13_newmark_grid", card=card, ndof=problem.ndof, dt=dt,
        n_steps=n, first_in_process_s=first_s, warm_s=warm_s,
        warm_ms_per_step=1e3 * warm_s / n, launches=launches,
        launches_timed_run=stats_launches,
        pcg_iterations_per_step=[int(iters.min()), float(iters.mean()),
                                 int(iters.max())],
        pcg_rounds_per_step=float(rounds.mean()),
        flag_reads_per_step=float((rounds / 32 + 1).mean()),
        u_rel_err_vs_float64=f64_gap, u_rel_err_vs_cpu_twin=cpu_gap,
        cpu_twin_steps=NEWMARK_CPU_STEPS, cpu_twin_s=cpu_s)
    require(stats_launches["dia_dir_matvec"] == stats_launches["cg_update"]
            == int(rounds.sum()) and len(iters) == n,
            "newmark: kernels 2 and 3 once each per PCG round (the "
            "iterations rounded up to CHECK_EVERY), one PCG a step")
    require(launches["dia_dir_matvec"] == launches["cg_update"] > 0
            and launches["cg_update"] % 32 == 0,
            "newmark document: kernels 2 and 3 in whole rounds of 32")
    require(launches["dia_matvec"] > 0 and not launches[
        "material_coefficients"], "newmark: kernel 1, not kernel 4")
    require(cpu_gap <= NEWMARK_CPU_RTOL,
            f"newmark: u within {NEWMARK_CPU_RTOL} of the CPU twin")
    require(f64_gap <= NEWMARK_F64_RTOL,
            f"newmark: u within {NEWMARK_F64_RTOL} of float64")
    return launches


def phase_moving_prestressed(workdir: Path, dev, card: str) -> dict:
    """13(d): prestress (the banded static Newton) and a moving load
    across the top row of the 100 x 200 grid, through main(); then the
    same transient from the card's prestress state against the CPU twin,
    every DOF recorded (the document's right-edge probes are still at
    rest when the twin's run ends)."""
    import numpy as np

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch import moving_load_force_fn, solve_transient
    from pinn_fem_tpu_torch.io._common import _prestress_state
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict

    rows, cols = GRID
    top = (rows - 1) * cols + np.arange(cols)
    load = {"type": "moving", "path_nodes": top.tolist(), "speed": 0.5,
            "magnitude": -1e-2, "component": 1}
    doc = eg.transient_grid_document(*GRID, prestress=True, load=load,
                                     n_steps=MOVING_STEPS, record_every=20)
    del doc["analysis"]["amplitude"]
    out, launches, first_s, _ = transient_document(workdir, "moving_grid",
                                                   doc)
    problem = parse_problem_dict(doc).problem
    pre = _prestress_state(problem, True, dev)
    runs = {}
    for where in (dev, "cpu"):
        force = moving_load_force_fn(problem, top, 0.5, -1e-2, out["dt"],
                                     device=where)
        runs[str(where)] = solve_transient(
            problem, out["dt"], MOVING_CPU_STEPS, record_every=20,
            damping=(0.05, 0.0), prestress_u=pre, force_fn=force,
            device=where)
    gap = history_gap(runs[str(dev)].displacements,
                      runs["cpu"].displacements)
    log("phase13_moving_prestressed", card=card, dt=out["dt"],
        prestressed=out["prestressed"], load_type=out["load_type"],
        first_in_process_s=first_s, launches=launches,
        u_rel_err_vs_cpu_twin=gap, cpu_twin_steps=MOVING_CPU_STEPS)
    require(out["prestressed"] and out["moving_load"],
            "moving load on the prestressed grid")
    require(all(launches[k] > 0 for k in BANDED),
            "prestress: the banded static Newton on kernels 1-3")
    require(gap <= MOVING_CPU_RTOL,
            f"moving load: u within {MOVING_CPU_RTOL} of the CPU twin")
    return launches


def phase_transient_checkpoint(workdir: Path, card: str, grid: dict) -> dict:
    """13(e): (a)'s document with a checkpoint every CHECKPOINT_EVERY
    steps; a run stopped at half of its steps and resumed."""
    import numpy as np

    doc, whole = grid["doc"], grid["out"]
    n, every = TRANSIENT_STEPS, TRANSIENT_EVERY
    ckpt = workdir / "transient_ckpt"
    full = dict(doc, analysis=dict(doc["analysis"], checkpoint={
        "dir": str(ckpt), "every": CHECKPOINT_EVERY}))
    out, launches, first_s, _ = transient_document(workdir, "ckpt_full",
                                                   full)
    gap = history_gap(out["displacements"], whole["displacements"])
    meta = json.loads((ckpt / "transient_meta.json").read_text())
    with np.load(ckpt / "transient.npz") as z:
        files = {k: [list(z[k].shape), str(z[k].dtype)] for k in z.files}
    half = workdir / "transient_half"
    first = dict(doc, analysis=dict(doc["analysis"], n_steps=n // 2,
                                    checkpoint={"dir": str(half),
                                                "every": CHECKPOINT_EVERY}))
    transient_document(workdir, "ckpt_first_half", first)
    second = dict(doc, analysis=dict(doc["analysis"], checkpoint={
        "dir": str(half), "every": CHECKPOINT_EVERY}))
    k = n // 2 // every
    tail, _, _, _ = transient_document(workdir, "ckpt_resumed", second,
                                       records=n // every - k)
    tail_gap = history_gap(tail["displacements"],
                           np.asarray(whole["displacements"])[k:])
    log("phase13_checkpoint", card=card, first_in_process_s=first_s,
        launches=launches, u_rel_gap_vs_uncheckpointed=gap, meta=meta,
        npz=files, resumed_records=len(tail["displacements"]),
        resumed_tail_rel_gap=tail_gap)
    require(meta["step"] == n and files["u"][0] == files["v"][0]
            == [len(doc["loads"])], "transient.npz holds u and v, meta "
            "step n")
    require(gap <= CHECKPOINT_RTOL,
            f"checkpointed records within {CHECKPOINT_RTOL} of (a)'s")
    require(len(tail["displacements"]) == n // every - k
            and tail_gap <= CHECKPOINT_RTOL,
            "resumed run gives (a)'s tail")
    return launches


def phase_transient_green_lagrange(dev, card: str) -> dict:
    """13(f): Green-Lagrange central and Newmark on the 32 x 32 grid
    (2,048 DOFs, dense) against the CPU twin."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import TrussProblem, solve_transient, stable_dt
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.models.fields import Material
    from pinn_fem_tpu_torch.ops import kernels

    nodes, elements, loads, fixed = eg.grid_arrays(*GL_DYN_GRID)
    problem = TrussProblem(nodes=nodes, elements=elements,
                           material=Material(young=1.0, area=1.0,
                                             density=1.0),
                           loads=loads * GL_DYN_LOAD, fixed_dofs=fixed,
                           dimension=2)
    dt = 0.5 * stable_dt(problem)
    fields = {}
    kernels.reset_launch_counts()
    for method, n, every, bound in (
            ("central", GL_DYN_STEPS, 20, GL_DYN_RTOL),
            ("newmark", GL_NEWMARK_STEPS, 5, GL_NEWMARK_RTOL)):
        step = dt if method == "central" else 4.0 * dt
        kw = dict(method=method, record_every=every, damping=(0.05, 0.0),
                  geometric_nonlinear=True)
        solve_transient(problem, step, every, device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_res = solve_transient(problem, step, n, device=dev, **kw)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n
        cpu_res = solve_transient(problem, step, n, device="cpu", **kw)
        gap = history_gap(card_res.displacements, cpu_res.displacements)
        fields[method] = {"ms_per_step": ms, "u_rel_err_vs_cpu_twin": gap,
                          "max_u": float(np.abs(card_res.displacements)
                                         .max()), "n_steps": n}
        require(gap <= bound,
                f"Green-Lagrange {method}: within {bound} of the CPU twin")
    launches = kernels.launch_counts()
    log("phase13_green_lagrange", card=card, grid=list(GL_DYN_GRID),
        ndof=problem.ndof, dt=dt, launches=launches, **fields)
    require(not any(launches.values()),
            "Green-Lagrange dynamics (dense): no repo kernel")
    return launches


def phase_transient_x64(dev, card: str) -> None:
    """PINN_FEM_TPU_X64=1: a banded transient on the card is refused."""
    from pinn_fem_tpu_torch import solve_transient
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels

    os.environ["PINN_FEM_TPU_X64"] = "1"
    kernels.reset_launch_counts()
    try:
        solve_transient(grid_problem(*GRID), 0.1, 10, device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    finally:
        del os.environ["PINN_FEM_TPU_X64"]
    log("phase13_x64", card=card, refused=refused,
        launches=kernels.launch_counts())
    require(refused is not None and "PINN_FEM_TPU_X64" in refused
            and "dia_matvec" in refused,
            "float64 banded transient refused, naming the variable and "
            "kernel 1")
    require(not any(kernels.launch_counts().values()),
            "no launch before the refusal")


def phase_dynamics(workdir: Path, dev, card: str) -> dict:
    """Phase 13: truss dynamics on the card.  Returns the kernels'
    launches on each of its paths."""
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    grid = phase_transient_grid(workdir, dev, card)
    launches = {"transient_40k": grid["launches"]}
    launches["chain_2M"] = phase_transient_chain(dev, card)
    launches["newmark_40k"] = phase_newmark_grid(workdir, dev, card)
    launches["prestress_moving_40k"] = phase_moving_prestressed(
        workdir, dev, card)
    launches["checkpoint_40k"] = phase_transient_checkpoint(workdir, card,
                                                            grid)
    launches["green_lagrange_32x32"] = phase_transient_green_lagrange(
        dev, card)
    phase_transient_x64(dev, card)
    return launches


MG_TOL = 1e-6               # the PCG items' tolerance (tests/test_mg.py)
MG_CYCLE_RTOL = 1e-6
MG_U_RTOL = 1e-3
STRIP_LENGTHS = (2_000, 10_000)  # 2 x length nodes: 8,000, 40,000 DOFs
STRIP_MG_CAP = 300          # MG iterations at the 40,000-DOF strip
BIG_GRID = (707, 1414)      # 1,999,396 DOFs
BIG_BUDGET_S = (8.0, 10.0)  # 14(e): seconds for MG, for Jacobi (the cap)


def mg_levels(h) -> list:
    """ndof, diagonals, bandwidth and smoothing of each level."""
    return [{"ndof": lvl.ndof, "n_diags": len(lvl.offsets),
             "bandwidth": lvl.layout.bandwidth, "smoothed": lvl.smoothed}
            for lvl in h.levels]


def synced(fn):
    """(seconds, fn()) with the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


class Timed:
    """Wraps module.name so that each call runs synchronized and records
    (seconds, result), while in the with block."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.inner, self.calls = getattr(module, name), []

    def __enter__(self):
        def timed(*args, **kwargs):
            self.calls.append(synced(lambda: self.inner(*args, **kwargs)))
            return self.calls[-1][1]

        setattr(self.module, self.name, timed)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def mg_newton(dev, card: str) -> dict:
    """14(a): solve_nr on the 100 x 200 grid with cg_precond "mg" and
    "jacobi": u against float64, iterations, ms per hierarchy build and per
    MG-PCG iteration, warm wall, idle share, and kernel 1's exact launches
    (per MG solve (1 + V)(1 + iterations), V the level matvecs of a cycle,
    plus 2 a Newton iteration and 1 for the reactions)."""
    import numpy as np

    from pinn_fem_tpu_torch import SolverConfig
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.ops import dia, kernels, mg
    from pinn_fem_tpu_torch.solvers.newton import solve_nr

    nodes, elements, loads, fixed = eg.grid_arrays(*GRID)
    u_ref = eg.float64_solution(nodes, elements, loads, fixed)
    problem = eg.grid_problem(*GRID)
    data = problem.to_device(dev)
    config = SolverConfig(max_iterations=20, tolerance=GRID_TOL)
    out = {}
    for precond in ("mg", "jacobi"):
        def run():
            return solve_nr(problem, config, 1.0, data=data,
                            linear_solver="cg-dia", cg_precond=precond)

        first_s, _ = synced(run)
        kernels.reset_launch_counts()
        with Spy(dia, "dia_cg_solve") as solves, \
                Spy(mg, "build_hierarchy") as builds, \
                Spy(kernels, "fused_cg_solve") as fused:
            warm_s, res = synced(run)
        launches = kernels.launch_counts()
        u = res.displacements.reshape(-1)
        err = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
        newton = int(res.history[0]["iterations"])
        pcg = [int(r[1]) for _, _, r in (solves if precond == "mg"
                                         else fused)]
        fields = dict(converged=res.converged, newton_iterations=newton,
                      pcg_iterations=pcg, pcg_iterations_total=sum(pcg),
                      u_rel_err_vs_float64=err, first_in_process_s=first_s,
                      warm_s=warm_s, launches=launches,
                      history=res.history)
        if precond == "mg":
            cycle = [mg.cycle_matvecs(h) for _, _, h in builds]
            expected = sum((1 + v) * (1 + it) for v, it in zip(cycle, pcg)) \
                + 2 * len(pcg) + 1
            with Timed(mg, "build_hierarchy") as tb, \
                    Timed(dia, "dia_cg_solve") as ts:
                run()
            build_s = [t for t, _ in tb]
            solve_s = [t for t, _ in ts]
            its = [int(r[1]) for _, r in ts]
            run()
            idle = idle_profile(run)
            fields.update(
                levels=mg_levels(builds[0][2]), cycle_matvecs=cycle[0],
                predicted_dia_matvec=expected,
                ms_per_build=1e3 * sum(build_s) / len(build_s),
                ms_per_mg_pcg_iteration=1e3 * (sum(solve_s) - sum(build_s))
                / max(sum(its), 1), ms_per_solve=1e3 * sum(solve_s)
                / len(solve_s), profile=idle)
            require(len(builds) == len(pcg) == newton,
                    "mg Newton: one hierarchy and one MG-PCG a Newton "
                    "iteration")
            require(launches["dia_matvec"] == expected,
                    f"mg Newton: kernel 1 launched sum (1 + V)(1 + it) + "
                    f"2 N + 1 = {expected} times")
            require(not any(launches[k] for k in launches
                            if k != "dia_matvec"),
                    "mg Newton: no kernel but kernel 1")
        else:
            require(len(fused) == newton and not solves,
                    "jacobi Newton: the fused PCG a Newton iteration")
            require(launches["dia_dir_matvec"] == launches["cg_update"] > 0,
                    "jacobi Newton: kernels 2 and 3 launched")
        log(f"phase14_newton_{precond}", card=card, ndof=problem.ndof,
            **fields)
        require(res.converged, f"{precond} Newton converged")
        require(err <= MG_U_RTOL,
                f"{precond} Newton: u within {MG_U_RTOL} of float64")
        out[precond] = launches
    return out


def pcg_pair(layout, diags, rhs, mask, max_iter: dict) -> dict:
    """Jacobi (the fused kernels) and MG PCG at MG_TOL on one operator,
    max_iter[precond] iterations at most: iterations, relative residual,
    warm wall; x of each."""
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve

    out = {}
    for precond in ("jacobi", "mg"):
        def solve():
            return dia_cg_solve(layout, diags, rhs, mask, tol=MG_TOL,
                                max_iter=max_iter[precond], precond=precond,
                                components=2)

        solve()
        wall, (x, it, res) = synced(solve)
        out[precond] = {"iterations": int(it), "rel_residual": float(res),
                        "wall_s": wall, "x": x}
    return out


def true_residual(layout, diags, x, rhs, mask) -> float:
    import torch

    from pinn_fem_tpu_torch.ops.kernels import dia_kernel

    r = (rhs - dia_kernel.dia_matvec_reference(layout, diags, x)) * mask
    return float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(rhs * mask))


def mg_pcg_and_cycle(dev, card: str) -> dict:
    """14(b), (c): the PCG alone on the 40k operator, Jacobi against MG;
    the V-cycle on kernel 1 against v_cycle_reference; kernel 1 against its
    twin at each level's shape, timed beside its byte bound."""
    import torch

    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels, mg
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve
    from pinn_fem_tpu_torch.ops.kernels import dia_kernel

    data, layout, diags = banded_system(grid_problem(*GRID), dev)
    rhs, mask = data.loads, data.free_mask
    kernels.reset_launch_counts()
    pair = pcg_pair(layout, diags, rhs, mask,
                    {"jacobi": 100_000, "mg": 100_000})
    launches = kernels.launch_counts()
    builds = sorted(synced(lambda: mg.build_hierarchy(
        layout, diags, mask, components=2))[0] for _ in range(3))
    h = mg.build_hierarchy(layout, diags, mask, components=2)
    idle = idle_profile(lambda: dia_cg_solve(
        layout, diags, rhs, mask, tol=MG_TOL, max_iter=100_000,
        precond="mg", components=2))
    it_j, it_m = pair["jacobi"]["iterations"], pair["mg"]["iterations"]
    mg_iter_ms = 1e3 * (pair["mg"]["wall_s"] - builds[1]) / max(it_m, 1)
    log("phase14_pcg_40k", card=card, ndof=layout.ndof, tol=MG_TOL,
        levels=mg_levels(h), ms_per_build=1e3 * builds[1],
        jacobi={k: v for k, v in pair["jacobi"].items() if k != "x"},
        mg={k: v for k, v in pair["mg"].items() if k != "x"},
        mg_ms_per_iteration=mg_iter_ms,
        jacobi_ms_per_iteration=1e3 * pair["jacobi"]["wall_s"]
        / max(it_j, 1), launches=launches, mg_profile=idle)
    require(it_m * 8 < it_j, f"MG PCG iterations x 8 < Jacobi's "
            f"({it_m} x 8 vs {it_j})")
    require(pair["mg"]["rel_residual"] <= MG_TOL, "MG PCG reached tol")

    # 14(c): one V-cycle, kernel 1 on every level against the twin.
    gen = torch.Generator(device=dev).manual_seed(14)
    b = torch.randn(layout.ndof, generator=gen, device=dev)
    v = mg.v_cycle(h, b)
    v_ref = mg.v_cycle_reference(h, b)
    cycle_err = max_err(v, v_ref) / float(v_ref.abs().max())
    shapes = []
    for lvl in h.levels[:-1]:
        lay = lvl.layout
        u = torch.randn(lvl.ndof, generator=gen, device=dev)
        y = dia_kernel.dia_matvec(lay, lvl.diags, u)
        y_ref = dia_kernel.dia_matvec_reference(lay, lvl.diags, u)
        plan = dia_kernel.stencil_plan(lay)
        _, ev = profiled(lambda: [dia_kernel.dia_matvec(lay, lvl.diags, u)
                                  for _ in range(50)])
        shapes.append({
            "ndof": lvl.ndof, "n_diags": lay.n_diags,
            "bandwidth": lay.bandwidth, "bit_equal": bool(torch.equal(
                y, y_ref)), "max_abs_err": max_err(y, y_ref),
            "staged": plan.staged, "threads": plan.threads,
            "tile": plan.tile, "blocks": plan.blocks,
            "shared_bytes": plan.shared_bytes,
            "ms": cuda_ms(lambda: dia_kernel.dia_matvec(lay, lvl.diags, u),
                          200),
            "plain_ms": cuda_ms(lambda: dia_kernel.dia_matvec_reference(
                lay, lvl.diags, u), 20),
            "device_us": per_launch_us(ev, "dia_matvec")[1],
            **banded_bounds(lay, 1, 1)["dia_matvec"]})
        require(shapes[-1]["bit_equal"], f"kernel 1 bit-equal to its twin "
                f"at {lvl.ndof} DOFs, {lay.n_diags} diagonals")
    log("phase14_v_cycle_40k", card=card, rel_err=cycle_err,
        bit_equal=bool(torch.equal(v, v_ref)), level_shapes=shapes,
        cycle_ms=cuda_ms(lambda: mg.v_cycle(h, b), 20),
        plain_cycle_ms=cuda_ms(lambda: mg.v_cycle_reference(h, b), 5),
        cycle_host_us=host_us(lambda: mg.v_cycle(h, b), 20))
    require(cycle_err <= MG_CYCLE_RTOL,
            f"V-cycle on kernel 1 within {MG_CYCLE_RTOL} of the plain cycle")
    del data, diags, h
    torch.cuda.empty_cache()
    return {"pcg_40k": launches, "level_shapes": shapes}


def mg_strip(dev, card: str) -> dict:
    """14(d): the guided strip, 2 x length nodes numbered along its length:
    Jacobi against MG PCG (counts, walls, true residual and x against
    float64 recorded).  At STRIP_LENGTHS[0] the gate is MG's residual; at
    the 40,000-DOF length the float32 operator (cond ~ 4e8) is past what
    float32 resolves and MG-PCG diverges (ROADMAP fault 3.14), so MG runs
    STRIP_MG_CAP iterations there and nothing is gated."""
    import numpy as np

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.ops import kernels

    launches = {}
    for length in STRIP_LENGTHS:
        t0 = time.perf_counter()
        problem = eg.strip_problem(length)
        data, layout, diags = banded_system(problem, dev)
        gated = length == STRIP_LENGTHS[0]
        kernels.reset_launch_counts()
        pair = pcg_pair(layout, diags, data.loads, data.free_mask,
                        {"jacobi": 400_000,
                         "mg": 400_000 if gated else STRIP_MG_CAP})
        launches[length] = kernels.launch_counts()
        u_ref = eg.float64_solution(problem.nodes, problem.elements,
                                    problem.loads, problem.fixed_dofs)
        fields = {}
        for precond, r in pair.items():
            x = r.pop("x")
            fields[precond] = dict(r, true_rel_residual=true_residual(
                layout, diags, x, data.loads, data.free_mask),
                x_rel_err_vs_float64=float(
                    np.abs(x.cpu().numpy() - u_ref).max()
                    / np.abs(u_ref).max()))
        log("phase14_strip", card=card, length=length, ndof=layout.ndof,
            free_dofs=int(data.free_mask.sum()), n_diags=layout.n_diags,
            bandwidth=layout.bandwidth, tol=MG_TOL, gated=gated,
            launches=launches[length],
            wall_ratio_jacobi_over_mg=fields["jacobi"]["wall_s"]
            / fields["mg"]["wall_s"], item_s=time.perf_counter() - t0,
            **fields)
        if gated:
            require(fields["mg"]["rel_residual"] <= MG_TOL,
                    f"strip of length {length}: MG PCG reached tol")
    return launches


def mg_big_grid(dev, card: str) -> dict:
    """14(e): the ~2M-DOF grid, MG against Jacobi PCG, each capped by an
    iteration budget from a short probe so the item stays near 30 s; where
    each stops (tol, cap, or a breakdown: r.z not finite and positive) is
    recorded, nothing is gated."""
    import torch

    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels, mg
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve

    t_item = time.perf_counter()
    data, layout, diags = banded_system(grid_problem(*BIG_GRID), dev)
    rhs, mask = data.loads, data.free_mask
    setup_s = time.perf_counter() - t_item

    def build():
        return mg.build_hierarchy(layout, diags, mask, components=2)

    first_build_s, h = synced(build)
    build_s, h = synced(build)          # warm: level layouts and plans made
    levels = mg_levels(h)
    del h
    kernels.reset_launch_counts()
    out = {}
    for precond, budget, probe in (("mg", BIG_BUDGET_S[0], 4),
                                   ("jacobi", BIG_BUDGET_S[1], 300)):
        fixed_s = build_s if precond == "mg" else 0.0

        def solve(tol, n):
            return dia_cg_solve(layout, diags, rhs, mask, tol=tol,
                                max_iter=n, precond=precond, components=2)

        probe_s, _ = synced(lambda: solve(0.0, probe))
        # The probe runs `probe` iterations and the setup's matvec and
        # preconditioner apply (one more cycle), after MG's build.
        per_it = max(probe_s - fixed_s, 1e-6) / (probe + 1)
        cap = max(1, int((budget - fixed_s) / per_it))
        wall, (_, it, res) = synced(lambda: solve(MG_TOL, cap))
        stopped = ("tol" if float(res) <= MG_TOL
                   else "cap" if int(it) >= cap else "breakdown")
        out[precond] = {"iterations": int(it), "rel_residual": float(res),
                        "wall_s": wall, "iteration_cap": cap,
                        "stopped_by": stopped,
                        "probe_ms_per_iteration": 1e3 * per_it}
    launches = kernels.launch_counts()
    log("phase14_grid_2M", card=card, grid=list(BIG_GRID), ndof=layout.ndof,
        setup_s=setup_s, first_build_s=first_build_s, build_s=build_s,
        levels=levels, tol=MG_TOL, launches=launches,
        item_s=time.perf_counter() - t_item, **out)
    del data, diags
    torch.cuda.empty_cache()
    return launches


def mg_x64(dev, card: str) -> None:
    """14(f): float64 CUDA operands on the MG path are refused."""
    import torch

    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve
    from pinn_fem_tpu_torch.solvers.newton import solve_nr

    data, layout, diags = banded_system(grid_problem(8, 16), dev)
    refused = {}
    kernels.reset_launch_counts()
    try:
        dia_cg_solve(layout, diags.double(), data.loads.double(),
                     data.free_mask.double(), precond="mg", components=2)
    except ValueError as e:
        refused["dia_cg_solve"] = str(e)
    os.environ["PINN_FEM_TPU_X64"] = "1"
    try:
        solve_nr(grid_problem(*GRID), linear_solver="cg-dia",
                 cg_precond="mg", device=dev)
    except ValueError as e:
        refused["solve_nr"] = str(e)
    finally:
        del os.environ["PINN_FEM_TPU_X64"]
    launches = kernels.launch_counts()
    log("phase14_x64", card=card, refused=refused, launches=launches)
    for path in ("dia_cg_solve", "solve_nr"):
        msg = refused.get(path, "")
        require("PINN_FEM_TPU_X64" in msg and "dia_matvec" in msg,
                f"float64 MG {path} on the card refused, naming the "
                "variable and kernel 1")
    require(not any(launches.values()), "no launch before the refusal")
    del data, diags
    torch.cuda.empty_cache()


def phase_multigrid(dev, card: str) -> dict:
    """Phase 14: the banded multigrid on the card.  Returns kernel
    launches on each of its paths and kernel 1's level shapes."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    newton = mg_newton(dev, card)
    lap("a")
    launches = {"newton_mg_40k": newton["mg"],
                "newton_jacobi_40k": newton["jacobi"]}
    pcg = mg_pcg_and_cycle(dev, card)
    lap("b_c")
    launches["pcg_40k"] = pcg["pcg_40k"]
    for length, counts in mg_strip(dev, card).items():
        launches[f"strip_{4 * length}"] = counts
    lap("d")
    launches["grid_2M"] = mg_big_grid(dev, card)
    lap("e")
    mg_x64(dev, card)
    lap("f")
    log("phase14_done", seconds=seconds, total_s=sum(seconds.values()))
    return {"launches": launches, "level_shapes": pcg["level_shapes"]}


BATCH_MEMBERS = (1, 8, 32)      # 15(a): members of the batched kernels
BATCH_GD_MEMBERS = 8            # 15(b)
BATCH_GD_ITERS = 200
BATCH_GD_PROFILE_ITERS = 20
BATCH_GD_MEMBER = 3
# 15(b, d): a member of a batch against the member alone (a B = 1 batch,
# or driver.solve), u and theta relative to their largest entries.  On
# the CPU the two are bit-equal (tests/test_torch_batched.py), and the
# backward's float64 sums over another partition of the elements (the
# card's blocks a member change with B) moved u and theta 1.8e-7 in 200
# GD iterations (a 16 x 32 PINN grid, 15 against 4 blocks).  On the card
# 200 iterations of the 40k grid moved theta 7.5e-8 and u 8.9e-4: Adam
# turns last-bit noise in near-zero u gradients into full steps, as the
# card-vs-CPU drift of phase 7 shows (u_norm 6.3e-3 in 50 rows, theta_norm
# 1.9e-5).  Bounds: theta 1e-4 (phase 7's theta_norm gate), u 1e-2; a
# leak between members moves both by O(1).
BATCH_MEMBER_U_RTOL = 1e-2
BATCH_MEMBER_THETA_RTOL = 1e-4
NR_BATCH_GRID = (32, 32)        # 15(c): 2,048 DOFs, dense
NR_BATCH = 256                  # benchmarks/scaling.py:296-302's batch
NR_PER_MEMBER_BATCH = 16
NR_BATCH_RTOL = 1e-3
INC_GRID = (8, 16)              # 15(d)
INC_BATCH = 16
INC_ITERS = 100
INC_TOL = 1e-2                  # 4 of 16 members converge (the CPU)
INC_CHECK_MEMBERS = (3, 5)      # one converged, one frozen (the CPU)
ENSEMBLE_GRID = (32, 64)        # 15(e): 4,096 DOFs
ENSEMBLE_BATCH = 64
ENSEMBLE_STEPS = 2048           # 64 records of 32 steps
ENSEMBLE_EVERY = 32
ENSEMBLE_IDLE_STEPS = 200
# A row of the ensemble against the unbatched solve_transient (kernel 1
# on the banded operator) of its amplitude: the CPU measured 1.8e-6
# after 2,048 steps on this grid; bound 1e-5.
ENSEMBLE_ROW_RTOL = 1e-5
GL_ENSEMBLE_BATCH = 16
GL_ENSEMBLE_STEPS = 200


def member_operands(base, members: int, seed: int, n: int, dev):
    """(B, P) parameters (base perturbed by 10 % seeded noise a member),
    (B,) load factors in [0.2, 1.2) and (4, B, n) upstream gradients."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    params = (base * (1.0 + 0.1 * torch.randn(members, base.numel(),
                                              device=dev, generator=gen))
              ).contiguous()
    lfs = 0.2 + torch.rand(members, device=dev, generator=gen)
    c = torch.randn(4, members, n, device=dev, generator=gen)
    return params, lfs, c


def batched_kernels(dev, card: str) -> dict:
    """15(a): kernels 4 and 4b with a member axis at the PINN grid's
    79,102 midpoints (widths 20 / 15 / 10, two hidden layers), B = 1, 8,
    32: each member against the one-member kernels (forward bit-equal,
    backward within 1e-5 of max|grad|) and the plain batched backward,
    bit for bit across two calls, B = 1 bit-equal to the one-member
    launch; ms, device us per launch, B one-member launches' ms and the
    bound at B (B x the one-member bound)."""
    import torch

    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.kernels import material_kernel as mk

    data = grid_problem(*GRID).to_device(dev)
    n = data.nelm
    mat = mlp_material(2, dev)
    fields = mk._fields(mat)
    base = torch.cat([t.reshape(-1) for f in fields
                      for t in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields])
    widths = mk._widths(mat)
    p = base.numel()
    fw = [(h, h) for h in (20, 15, 10)]
    one_fwd = bound(4 * (2 * n + n + 4 * n) + 4 * p + 12,
                    n * mlp_ops(fw, backward=False))
    one_bwd = bound(4 * (2 * n + 3 * n + 4 * n) + 8 * p + 12,
                    n * mlp_ops(fw, backward=True))
    stats = {}
    for members in BATCH_MEMBERS:
        params, lfs, c = member_operands(base, members, 100 + members, n,
                                         dev)
        lf_host = lfs.tolist()

        def forward():
            return mk.material_coefficients_batched(
                data.mid, data.inv_len, lfs, params, scales, widths)

        kernels.reset_launch_counts()
        got = forward()

        def backward():
            return mk.material_coefficients_backward_batched(
                data.mid, data.inv_len, lfs, params, scales, widths, got[0],
                got[1], tuple(c))

        grad = backward()
        counts = kernels.launch_counts()
        require(counts["material_coefficients"] == 1
                and counts["material_coefficients_backward"] == 1,
                f"B = {members}: one launch of each kernel, got {counts}")
        require(all(torch.equal(a, b) for a, b in zip(got, forward()))
                and torch.equal(grad, backward()),
                f"B = {members}: bit for bit across two calls")
        plain = mk.material_coefficients_backward_batched_reference(
            data.mid, data.inv_len, lfs, params, scales, widths, got[0],
            got[1], tuple(c))
        twin = mk.material_coefficients_batched_reference(
            data.mid, data.inv_len, lfs, params, scales, widths)
        for k, (a, b) in enumerate(zip(got, twin)):
            rtol = 3e-5 if k == 3 else 2e-5
            require(bool(((a - b).abs() <= 1e-6 + rtol * b.abs()).all()),
                    f"B = {members}: forward output {k} within rtol {rtol} "
                    "/ atol 1e-6 of the batched twin")
        worst_single = worst_plain = 0.0
        for b in range(members):
            one = mk.material_coefficients(data.mid, data.inv_len,
                                           lf_host[b], params[b], scales,
                                           widths)
            require(all(torch.equal(x[b], y) for x, y in zip(got, one)),
                    f"B = {members}: member {b}'s forward bit-equal to the "
                    "one-member kernel")
            single = mk.material_coefficients_backward(
                data.mid, data.inv_len, lf_host[b], params[b], scales,
                widths, got[0][b], got[1][b], tuple(c[:, b]))
            scale = float(single.abs().max())
            worst_single = max(worst_single,
                               max_err(grad[b], single) / scale)
            worst_plain = max(worst_plain, max_err(grad[b], plain[b])
                              / float(plain[b].abs().max()))
            if members == 1:
                require(torch.equal(grad[0], single),
                        "B = 1: backward bit-equal to the one-member launch")
        require(worst_single <= 1e-5 and worst_plain <= 1e-5,
                f"B = {members}: each member's gradient within 1e-5 of "
                f"max|grad| of the one-member kernel ({worst_single}) and "
                f"of the plain batched version ({worst_plain})")
        entry = {}
        for label, fn, single_fn, symbol, one_bound in (
                ("forward", forward,
                 lambda: [mk.material_coefficients(
                     data.mid, data.inv_len, lf_host[b], params[b], scales,
                     widths) for b in range(members)],
                 "material_forward_kernel", one_fwd),
                ("backward", backward,
                 lambda: [mk.material_coefficients_backward(
                     data.mid, data.inv_len, lf_host[b], params[b], scales,
                     widths, got[0][b], got[1][b], tuple(c[:, b]))
                     for b in range(members)],
                 "material_grad_kernel", one_bwd)):
            ev, windows = recorded_window(
                lambda: [fn() for _ in range(10)], tries=5,
                enough=lambda ev: sum(launched(e.name, symbol)
                                      for e in ev) >= 8)
            mine = [e.device_time_total for e in ev
                    if launched(e.name, symbol)]
            entry[label] = {
                "ms": cuda_ms(fn, 50),
                # None: no profiler window recorded the kernel (on the
                # card a window now and then comes back without it).
                "device_us": sum(mine) / len(mine) if mine else None,
                "profiler_windows": windows,
                "single_launches_ms": cuda_ms(single_fn, 5),
                "bound_ms": members * one_bound["bound_ms"],
                "bound_by": one_bound["bound_by"]}
        card_dev = data.mid.device
        plan = mk._forward_plan(card_dev, widths, n, members)[0]
        gplan = mk._grad_plan(
            card_dev, torch.cuda.current_stream(card_dev).cuda_stream,
            widths, n, members)[0]
        entry.update(forward_blocks_a_member=plan.blocks,
                     forward_threads=plan.threads,
                     backward_blocks_a_member=gplan.blocks,
                     grad_rel_err_vs_one_member=worst_single,
                     grad_rel_err_vs_plain=worst_plain)
        stats[members] = entry
        log("phase15a_batched_kernels", card=card, elements=n,
            members=members, **entry)
    del data
    torch.cuda.empty_cache()
    return stats


def flat_theta(theta) -> "torch.Tensor":
    """(B, P) of a stacked theta (leaves (B, ...)), in theta order."""
    import torch

    leaves = [t for net in theta for layer in net for t in layer]
    return torch.cat([t.reshape(t.shape[0], -1) for t in leaves], dim=1)


def batch_losses(problem, data, material, loads, meas, mdofs, u, params,
                 config) -> list:
    """Each member's GD loss alpha_p ||r||^2 / 2 + alpha_d mean((meas -
    u_m)^2) at (u, params), load factor 1."""
    import torch

    from pinn_fem_tpu_torch.ops.assembly import \
        internal_force_and_strain_batched

    with torch.no_grad():
        lfs = torch.ones(u.shape[0], dtype=u.dtype, device=u.device)
        f_int, _ = internal_force_and_strain_batched(data, material, u, lfs,
                                                     params)
        r = (f_int - loads) * data.free_mask
        rd = meas - u[:, mdofs]
        loss = (config.alpha_physics * 0.5 * torch.sum(r * r, dim=1)
                + config.alpha_data * torch.mean(rd * rd, dim=1))
    return loss.tolist()


def batched_gd(dev, card: str, single_ms) -> dict:
    """15(b): solve_gd_batched on the 40k PINN grid, B = 8 members at load
    scales 0.5-2.0 with their float64 fields (the document's measured u
    scaled: a linear truss), 200 iterations: one launch of kernel 4 and
    one of 4b an iteration for all members (and kernel 4 once for the
    reactions), ms an iteration and the idle share beside phase 7's
    one-member GD, every member's loss falling, member 3 against a B = 1
    batch of member 3."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.parallel.batched import solve_gd_batched
    from pinn_fem_tpu_torch.solvers.phases import gd_phase_batched

    doc = pinn_grid_document(*GRID, max_iterations=BATCH_GD_ITERS)
    parsed = parse_problem_dict(doc)
    problem = parsed.problem
    scales = np.linspace(0.5, 2.0, BATCH_GD_MEMBERS)
    loads = scales[:, None] * problem.loads[None]
    meas = scales[:, None] * parsed.measured_disp[None]

    def run(rows, iters=BATCH_GD_ITERS):
        return solve_gd_batched(
            problem, loads[rows], parsed.config.with_(max_iterations=iters),
            measured_batch=meas[rows], measured_dofs=parsed.measured_dofs,
            device=dev)

    every = slice(None)
    run(every, 5)
    run([BATCH_GD_MEMBER], 5)
    kernels.reset_launch_counts()
    solve_s, out = synced(lambda: run(every))
    launches = kernels.launch_counts()
    iters = out["iterations"].tolist()
    require(iters == [BATCH_GD_ITERS] * BATCH_GD_MEMBERS,
            f"every member ran {BATCH_GD_ITERS} iterations: {iters}")
    require(launches["material_coefficients"] == BATCH_GD_ITERS + 1
            and launches["material_coefficients_backward"] == BATCH_GD_ITERS,
            "one kernel 4 and one kernel 4b launch an iteration for all "
            f"members, kernel 4 once for the reactions: {launches}")
    alone = run([BATCH_GD_MEMBER])

    # The phase alone (no setup, no reactions): ms an iteration and the
    # idle share, B members and one.
    data = problem.to_device(dev)
    material = problem.material.to(dev)
    loads_t = torch.as_tensor(loads, dtype=torch.float32, device=dev)
    meas_t = torch.as_tensor(meas, dtype=torch.float32, device=dev)
    mdofs = torch.as_tensor(parsed.measured_dofs, device=dev)
    base = torch.cat([t.reshape(-1) for t in material.trainable_params()])
    params0 = base.expand(BATCH_GD_MEMBERS, -1).contiguous()
    cfg = parsed.config

    def phase(rows, iters):
        return gd_phase_batched(
            data, material, loads_t[rows], torch.zeros_like(loads_t[rows]),
            params0[rows], torch.ones_like(loads_t[rows, 0]), meas_t[rows],
            mdofs, True, iters, cfg.tolerance, cfg.learning_rate_u,
            cfg.learning_rate_theta, cfg.alpha_physics, cfg.alpha_data)

    one = [BATCH_GD_MEMBER]
    seconds, _ = synced(lambda: phase(every, BATCH_GD_ITERS))
    one_s, _ = synced(lambda: phase(one, BATCH_GD_ITERS))
    profile = idle_profile(lambda: phase(every, BATCH_GD_PROFILE_ITERS))
    profile_one = idle_profile(lambda: phase(one, BATCH_GD_PROFILE_ITERS))
    first = batch_losses(problem, data, material, loads_t, meas_t, mdofs,
                         torch.zeros_like(loads_t), params0, parsed.config)
    last = batch_losses(problem, data, material, loads_t, meas_t, mdofs,
                        out["u"], flat_theta(out["theta"]), parsed.config)
    require(all(np.isfinite(last)) and all(b < a for a, b in
                                           zip(first, last)),
            f"every member's loss falls: {first} -> {last}")
    m = BATCH_GD_MEMBER
    u_gap = rel_err(out["u"][m].cpu().numpy(), alone["u"][0].cpu().numpy())
    th_b, th_1 = flat_theta(out["theta"])[m], flat_theta(alone["theta"])[0]
    th_gap = max_err(th_b, th_1) / float(th_1.abs().max())
    fields = dict(
        members=BATCH_GD_MEMBERS, iterations=BATCH_GD_ITERS,
        solve_s=solve_s, ms_per_iteration=1e3 * seconds / BATCH_GD_ITERS,
        ms_per_iteration_one_member_batch=1e3 * one_s / BATCH_GD_ITERS,
        ms_per_iteration_phase7_single=single_ms,
        member_iterations_per_s=BATCH_GD_MEMBERS * BATCH_GD_ITERS / seconds,
        profile=profile, profile_one_member_batch=profile_one,
        launches=launches, first_losses=first, last_losses=last,
        member_u_rel_err_vs_alone=u_gap,
        member_theta_rel_err_vs_alone=th_gap)
    log("phase15b_gd_batched", card=card, ndof=problem.ndof,
        elements=problem.nelm, **fields)
    require(u_gap <= BATCH_MEMBER_U_RTOL and th_gap <= BATCH_MEMBER_THETA_RTOL,
            f"member {m} within {BATCH_MEMBER_U_RTOL} (u: {u_gap}) and "
            f"{BATCH_MEMBER_THETA_RTOL} (theta: {th_gap}) of a batch of it "
            "alone")
    return launches


def batched_nr(dev, card: str) -> dict:
    """15(c): solve_nr_batched on the 32 x 32 grid (2,048 DOFs, dense):
    B = 256 load scales with one shared factorization (problems/s, every
    member converged, three rows within 1e-3 of float64), and B = 16
    distinct load factors (per-member tangents)."""
    import numpy as np

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.parallel.batched import solve_nr_batched

    nodes, elements, loads, fixed = eg.grid_arrays(*NR_BATCH_GRID)
    problem = eg.grid_problem(*NR_BATCH_GRID)
    u_unit = eg.float64_solution(nodes, elements, loads, fixed)
    scales = np.linspace(0.1, 2.0, NR_BATCH)
    loads_b = scales[:, None] * problem.loads[None]
    solve_nr_batched(problem, loads_b[:4], device=dev)
    launches = {}
    kernels.reset_launch_counts()
    times = []
    for _ in range(3):
        t, out = synced(lambda: solve_nr_batched(problem, loads_b,
                                                 device=dev))
        times.append(t)
    launches["nr_batched_32x32"] = kernels.launch_counts()
    u = out["u"].cpu().numpy()
    rows = (0, NR_BATCH // 2, NR_BATCH - 1)
    gaps = [rel_err(u[b], scales[b] * u_unit) for b in rows]
    conv = out["converged"].tolist()
    per = slice(0, NR_BATCH, NR_BATCH // NR_PER_MEMBER_BATCH)
    lfs = np.linspace(0.5, 1.5, NR_PER_MEMBER_BATCH)
    solve_nr_batched(problem, loads_b[per][:2], load_factors=lfs[:2],
                     device=dev)
    kernels.reset_launch_counts()
    t_per, per_out = synced(lambda: solve_nr_batched(
        problem, loads_b[per], load_factors=lfs, device=dev))
    launches["nr_per_member_32x32"] = kernels.launch_counts()
    u_per = per_out["u"].cpu().numpy()
    per_gaps = [rel_err(u_per[k], lfs[k] * scales[per][k] * u_unit)
                for k in range(NR_PER_MEMBER_BATCH)]
    t_med = float(np.median(times))
    log("phase15c_nr_batched", card=card, ndof=problem.ndof,
        members=NR_BATCH, seconds=times, problems_per_s=NR_BATCH / t_med,
        iterations=sorted(set(out["iterations"].tolist())),
        u_rel_err_vs_float64_rows=dict(zip(map(str, rows), gaps)),
        per_member_members=NR_PER_MEMBER_BATCH, per_member_s=t_per,
        per_member_problems_per_s=NR_PER_MEMBER_BATCH / t_per,
        per_member_iterations=per_out["iterations"].tolist(),
        per_member_max_u_rel_err=max(per_gaps), launches=launches)
    require(all(conv) and all(per_out["converged"].tolist()),
            "every batched Newton member converged")
    require(max(gaps) <= NR_BATCH_RTOL and max(per_gaps) <= NR_BATCH_RTOL,
            f"batched Newton rows within {NR_BATCH_RTOL} of float64")
    return launches


def batched_incremental(dev, card: str) -> dict:
    """15(d): solve_gd_batched_incremental, B = 16 load scales of the
    8 x 16 PINN grid, 2 increments of at most 100 iterations: converged and
    total_iterations per member; members 3 and 5 against the port's
    driver.solve(method="gd") of the same row on the card."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.parallel.batched import \
        solve_gd_batched_incremental
    from pinn_fem_tpu_torch.solvers.driver import solve

    doc = pinn_grid_document(*INC_GRID, max_iterations=INC_ITERS,
                             tolerance=INC_TOL)
    doc["solver_config"] = {"n_increments": 2}
    parsed = parse_problem_dict(doc)
    scales = np.linspace(0.1, 2.0, INC_BATCH)
    loads = scales[:, None] * parsed.problem.loads[None]
    meas = scales[:, None] * parsed.measured_disp[None]
    kernels.reset_launch_counts()
    seconds, out = synced(lambda: solve_gd_batched_incremental(
        parsed.problem, loads, parsed.config, measured_batch=meas,
        measured_dofs=parsed.measured_dofs, device=dev))
    launches = kernels.launch_counts()
    conv = out["converged"].tolist()
    total = out["total_iterations"].tolist()
    gaps = {}
    for m in INC_CHECK_MEMBERS:
        single = parse_problem_dict(doc)
        single.problem.loads = loads[m]
        res = solve(single.problem, single.config, meas[m],
                    single.measured_dofs, verbose=False, device=dev)
        require(res.converged == conv[m],
                f"member {m}: converged as driver.solve ({res.converged})")
        gaps[m] = rel_err(out["u"][m].cpu().numpy(),
                          res.displacements.reshape(-1))
    log("phase15d_gd_incremental", card=card, members=INC_BATCH,
        seconds=seconds, converged=conv, total_iterations=total,
        u_rel_err_vs_driver=gaps, launches=launches)
    require(any(conv) and not all(conv),
            "some members converge, others freeze at a failed increment")
    require(max(gaps.values()) <= BATCH_MEMBER_U_RTOL,
            f"members' u within {BATCH_MEMBER_U_RTOL} of driver.solve")
    return launches


def batched_transients(workdir: Path, dev, card: str) -> dict:
    """15(e): the ensemble through cli.generic (B = 64 seeded amplitude
    histories, 2,048 central steps recorded every 32 at 4 probe DOFs, the
    32 x 64 grid), ms a step and the idle share, two rows against the
    unbatched solve_transient, the envelope; a Green-Lagrange ensemble
    (B = 16, 32 x 32 grid) against the unbatched Green-Lagrange run; an
    include_stress_envelope single run."""
    import numpy as np

    from pinn_fem_tpu_torch import TrussProblem, solve_transient, stable_dt
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.models.fields import Material
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.parallel.batched import solve_transient_batched

    launches = {}
    rng = np.random.default_rng(15)
    amps = rng.uniform(0.0, 1.5, (ENSEMBLE_BATCH, ENSEMBLE_STEPS))
    doc = eg.transient_grid_document(
        *ENSEMBLE_GRID, n_steps=ENSEMBLE_STEPS, record_every=ENSEMBLE_EVERY,
        amplitudes=amps.tolist())
    doc["analysis"].pop("amplitude")
    nid = np.arange(ENSEMBLE_GRID[0] * ENSEMBLE_GRID[1]).reshape(
        ENSEMBLE_GRID)
    doc["analysis"]["probe_nodes"] = [int(nid[0, -1]), int(nid[-1, -1])]
    path = workdir / "ensemble.json"
    path.write_text(json.dumps(doc))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([str(path)])
    cli_s = time.perf_counter() - t0
    launches["ensemble_32x64"] = kernels.launch_counts()
    require(rc == 0, "ensemble document: exit code 0")
    out = json.loads((workdir / "ensemble.res.json").read_text())
    n_rec = ENSEMBLE_STEPS // ENSEMBLE_EVERY
    disp = np.asarray(out["displacements"])
    env = np.asarray(out["max_stress"])
    problem = parse_problem_dict(doc).problem
    require(out["ensemble"] is True and out["batch"] == ENSEMBLE_BATCH
            and disp.shape == (ENSEMBLE_BATCH, n_rec, 4)
            and bool(np.all(np.isfinite(disp))),
            "ensemble: finite records of (B, n_rec, 4)")
    require(env.shape == (ENSEMBLE_BATCH, problem.nelm)
            and bool(np.all(np.isfinite(env))) and float(env.min()) >= 0.0,
            "ensemble: the envelope written, finite, non-negative")
    dt, probe = out["dt"], np.asarray(out["probe_dofs"])
    damping = tuple(doc["analysis"]["damping"])
    data = problem.to_device(dev)

    def steps(count):
        return solve_transient_batched(
            problem, dt, count, amplitudes=amps[:, :count], damping=damping,
            probe_dofs=probe, record_every=count, device=dev)

    steps(ENSEMBLE_IDLE_STEPS)
    seconds, _ = synced(lambda: steps(ENSEMBLE_STEPS))
    idle = idle_profile(lambda: steps(ENSEMBLE_IDLE_STEPS))
    row_gaps = []
    for b in (0, ENSEMBLE_BATCH - 1):
        res = solve_transient(problem, dt, ENSEMBLE_STEPS,
                              amplitude=amps[b], damping=damping,
                              record_every=ENSEMBLE_EVERY, probe_dofs=probe,
                              data=data)
        row_gaps.append(rel_err(disp[b], res.displacements))

    nodes, elements, loads, fixed = eg.grid_arrays(*GL_DYN_GRID)
    gl = TrussProblem(nodes=nodes, elements=elements,
                      material=Material(young=1.0, area=1.0, density=1.0),
                      loads=loads * GL_DYN_LOAD, fixed_dofs=fixed,
                      dimension=2)
    gl_dt = 0.5 * stable_dt(gl)
    gl_amps = rng.uniform(0.0, 1.0, (GL_ENSEMBLE_BATCH, GL_ENSEMBLE_STEPS))
    kw = dict(damping=(0.05, 0.0), record_every=20,
              probe_dofs=np.array([gl.ndof - 2, gl.ndof - 1]))
    kernels.reset_launch_counts()
    gl_s, gl_out = synced(lambda: solve_transient_batched(
        gl, gl_dt, GL_ENSEMBLE_STEPS, amplitudes=gl_amps,
        geometric_nonlinear=True, device=dev, **kw))
    launches["green_lagrange_ensemble_32x32"] = kernels.launch_counts()
    gl_one = solve_transient(gl, gl_dt, GL_ENSEMBLE_STEPS,
                             amplitude=gl_amps[0], geometric_nonlinear=True,
                             device=dev, **kw)
    gl_gap = rel_err(gl_out["displacements"][0].cpu().numpy(),
                     gl_one.displacements)

    env_doc = eg.transient_grid_document(
        *ENSEMBLE_GRID, n_steps=400, record_every=20,
        include_stress_envelope=True)
    env_path = workdir / "envelope.json"
    env_path.write_text(json.dumps(env_doc))
    kernels.reset_launch_counts()
    require(main([str(env_path)]) == 0, "envelope document: exit code 0")
    launches["envelope_32x64"] = kernels.launch_counts()
    single_env = np.asarray(json.loads(
        (workdir / "envelope.res.json").read_text())["max_stress"])
    log("phase15e_ensemble", card=card, ndof=problem.ndof,
        members=ENSEMBLE_BATCH, n_steps=ENSEMBLE_STEPS,
        record_every=ENSEMBLE_EVERY, dt=dt, cli_s=cli_s,
        ms_per_step=1e3 * seconds / ENSEMBLE_STEPS,
        member_steps_per_s=ENSEMBLE_BATCH * ENSEMBLE_STEPS / seconds,
        idle=idle, row_rel_err_vs_unbatched=row_gaps,
        max_envelope=float(env.max()),
        green_lagrange={"members": GL_ENSEMBLE_BATCH,
                        "n_steps": GL_ENSEMBLE_STEPS,
                        "ms_per_step": 1e3 * gl_s / GL_ENSEMBLE_STEPS,
                        "row0_rel_err_vs_unbatched": gl_gap},
        envelope_single={"elements": int(single_env.size),
                         "max": float(single_env.max())},
        launches=launches)
    require(max(row_gaps) <= ENSEMBLE_ROW_RTOL,
            f"ensemble rows within {ENSEMBLE_ROW_RTOL} of the unbatched run")
    require(gl_gap <= GL_DYN_RTOL
            and all(bool(t.isfinite().all()) for t in gl_out.values()),
            f"Green-Lagrange ensemble row within {GL_DYN_RTOL} of the "
            "unbatched run")
    require(single_env.shape == (problem.nelm,)
            and bool(np.all(np.isfinite(single_env)))
            and float(single_env.min()) >= 0.0,
            "include_stress_envelope: one finite envelope an element")
    return launches


def batched_api(workdir: Path, card: str) -> dict:
    """15(f): cli.api_batch on the card: an nr and a gd payload exit 0 with
    the four keys, an unresolvable measured_batch exits 1 with {error,
    type}."""
    import numpy as np

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.cli import api_batch
    from pinn_fem_tpu_torch.ops import kernels

    keys = ["batch", "converged", "iterations", "displacements"]
    nr_doc = eg.grid_document(*NR_BATCH_GRID)
    nr_loads = np.asarray(nr_doc["loads"])
    gd_doc = eg.pinn_grid_document(*INC_GRID, max_iterations=50)
    gd_loads = np.asarray(gd_doc["loads"])
    gd_meas = np.asarray(gd_doc["measured_displacements"]["measured_u"])
    payloads = {
        "api_batch_nr": {"problem": nr_doc, "loads_batch": [
            (s * nr_loads).tolist() for s in np.linspace(0.5, 2.0, 16)]},
        "api_batch_gd": {"problem": gd_doc, "loads_batch": [
            (s * gd_loads).tolist() for s in (0.5, 1.0, 1.5, 2.0)],
            "measured_batch": [(s * gd_meas).tolist()
                               for s in (0.5, 1.0, 1.5, 2.0)]},
        "api_batch_unresolvable": {
            "problem": dict(gd_doc, solver_type="fem"),
            "loads_batch": [gd_loads.tolist()],
            "measured_batch": [gd_meas.tolist()]},
    }
    launches, fields = {}, {}
    for name, payload in payloads.items():
        kernels.reset_launch_counts()
        rc, out = run_api(api_batch, workdir, name, payload)
        launches[name] = kernels.launch_counts()
        fields[name] = {"exit_code": rc, "keys": list(out)}
        if name == "api_batch_unresolvable":
            require(rc == 1 and list(out) == ["error", "type"]
                    and out["type"] == "ValueError",
                    f"{name}: exit 1 with {{error, type}}, got {rc} {out}")
            continue
        require(rc == 0 and list(out) == keys
                and out["batch"] == len(payload["loads_batch"]),
                f"{name}: exit 0 with {keys}, got {rc} {list(out)}")
        fields[name].update(converged=out["converged"],
                            iterations=out["iterations"])
    require(all(launches["api_batch_gd"][k] > 0 for k in MATERIAL),
            "the gd payload runs kernels 4 and 4b")
    log("phase15f_api_batch", card=card, launches=launches, **fields)
    return {k: v for k, v in launches.items()
            if k != "api_batch_unresolvable"}


def batched_refusals(dev, card: str) -> None:
    """15(g): float64 CUDA operands at the batched material dispatch raise
    the ValueError naming PINN_FEM_TPU_X64 and kernels 4 / 4b; mesh=
    raises NotImplementedError."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.parallel import batched

    doc = pinn_grid_document(4, 6, max_iterations=3)
    refused = {}
    os.environ["PINN_FEM_TPU_X64"] = "1"
    kernels.reset_launch_counts()
    try:
        parsed = parse_problem_dict(doc)
        batched.solve_gd_batched(
            parsed.problem, np.stack([parsed.problem.loads] * 2),
            parsed.config, device=dev)
        refused["x64"] = None
    except ValueError as e:
        refused["x64"] = str(e)
    finally:
        del os.environ["PINN_FEM_TPU_X64"]
    x64_launches = kernels.launch_counts()
    parsed = parse_problem_dict(doc)
    for fn in ("solve_gd_batched", "solve_nr_batched",
               "solve_gd_batched_incremental"):
        try:
            getattr(batched, fn)(parsed.problem, parsed.problem.loads[None],
                                 mesh=object(), device=dev)
            refused[fn] = None
        except NotImplementedError as e:
            refused[fn] = str(e)
    log("phase15g_refusals", card=card, refused=refused,
        x64_launches=x64_launches)
    require(refused["x64"] is not None and "PINN_FEM_TPU_X64" in refused["x64"]
            and "kernels 4 and 4b" in refused["x64"],
            "float64 batched material dispatch refused, naming the variable "
            "and kernels 4 / 4b")
    require(not any(x64_launches.values()), "no launch before the refusal")
    require(all(refused[fn] and "item 15" in refused[fn]
                for fn in refused if fn != "x64"), "mesh= refused")


def phase_batched(workdir: Path, dev, card: str) -> dict:
    """Phase 15: batched solving on the card.  Returns the kernels'
    launches on each of its paths and (a)'s member-axis times."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    members = batched_kernels(dev, card)
    lap("a")
    launches = {"gd_batched_40k": batched_gd(dev, card, PHASE7.get("ms"))}
    lap("b")
    launches.update(batched_nr(dev, card))
    lap("c")
    launches["gd_incremental_8x16"] = batched_incremental(dev, card)
    lap("d")
    launches.update(batched_transients(workdir, dev, card))
    lap("e")
    launches.update(batched_api(workdir, card))
    lap("f")
    batched_refusals(dev, card)
    lap("g")
    log("phase15_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches, "members": members}


# Phase 16: modal and buckling analyses.
EIGEN_DOCS = {"dyn-modal": ("eigenvalues", "omegas", "frequencies_hz"),
              "dyn-buckling": ("load_factors", "axial_forces", "u_base")}
EIGEN_DOC_RTOL = 1e-10          # card against the port's CPU run, float64
EIGEN_SHAPE_ATOL = 1e-8         # |phi|, card against CPU (signs arbitrary)
MODAL_MODES = 6                 # 16(b): n_iter 25, cg_tol 1e-8 (defaults)
MODAL_ITERS = 25
MODAL_RTOL = 1e-2               # pinn_fem_tpu/solvers/modal.py:29-31
BUCKLING_STRIP = (32, 36)       # 16(c): 2,304 DOFs, kappa(K_ff) ~ 1.4e4
BUCKLING_YOUNG = 100.0
BUCKLING_MODES = 2
BUCKLING_ITERS = 30             # buckling_analysis's default
EPS32 = 2.0 ** -23
MODAL_TRANSIENT_STEPS = 2000    # 16(d)
MODAL_TRANSIENT_EVERY = 20
MODAL_TRANSIENT_ALPHA = 2e-4    # Rayleigh alpha: zeta_1 ~ 0.08
MODAL_CENTRAL_U_ATOL = 2e-3     # tests/test_dynamics.py:380-390's bounds,
MODAL_CENTRAL_KE_ATOL = 1e-2    # of max |u| and of max KE


def pcg_rounds(solves) -> int:
    """Kernels 2 and 3's launches over fused PCG solves (Spy records):
    whole rounds of CHECK_EVERY iterations until the flag read finds the
    solve stopped."""
    from pinn_fem_tpu_torch.ops.kernels import cg_kernel

    every = cg_kernel.CHECK_EVERY
    return sum(every * -(-int(res[1]) // every) for _, _, res in solves)


def solve_stats(solves) -> dict:
    its = [int(res[1]) for _, _, res in solves]
    return {"solves": len(its), "pcg_iterations": sum(its),
            "largest_column": max(its), "smallest_column": min(its),
            "max_iter": solves[0][1]["max_iter"],
            "stalled": sum(it >= solves[0][1]["max_iter"] for it in its)}


def eigen_documents(workdir: Path, card: str) -> dict:
    """16(a): dyn-modal.json and dyn-buckling.json through main() on the
    card (the dense float64 path: torch on the card, no repo kernel),
    each against the port's own CPU run of the document."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.analysis import run_analysis
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    launches, gaps = {}, {}
    for name, keys in EIGEN_DOCS.items():
        doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                         .read_text())
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(doc))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        require(main([str(path)]) == 0, f"{name}: exit code 0")
        card_s = time.perf_counter() - t0
        launches[name] = kernels.launch_counts()
        got = json.loads((workdir / f"{name}.res.json").read_text())
        want = run_analysis(parse_problem_dict(doc).problem,
                            doc["analysis"], "cpu")
        shapes = "mode_shapes" if "modal" in name else "buckling_modes"
        gaps[name] = {key: rel_err(got[key], want[key]) for key in keys}
        gaps[name]["abs_shapes"] = float(np.abs(
            np.abs(np.asarray(got[shapes])) - np.abs(np.asarray(
                want[shapes]))).max())
        gaps[name]["s"] = card_s
        require(list(got) == list(want) and got["ok"] == want["ok"] is True,
                f"{name}: the CPU run's keys and ok")
        require(max(gaps[name][key] for key in keys) <= EIGEN_DOC_RTOL,
                f"{name}: within {EIGEN_DOC_RTOL} of the CPU run")
        require(gaps[name]["abs_shapes"] <= EIGEN_SHAPE_ATOL,
                f"{name}: |shapes| within {EIGEN_SHAPE_ATOL} of the CPU run")
    log("phase16a_documents", card=card, gaps=gaps, launches=launches)
    return launches


def float64_grid_modes(problem, n_modes: int):
    """The lowest (eigenvalues, M-orthonormal shapes (ndof, n)) of the
    E = A = rho = 1 grid by scipy's shift-invert Lanczos in float64."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    from pinn_fem_tpu_torch.examples_grid import (float64_lumped_mass,
                                                  float64_stiffness)

    k = float64_stiffness(problem.nodes, problem.elements)
    m = float64_lumped_mass(problem.nodes, problem.elements)
    free = problem.free_fixed()[0]
    w, v = spl.eigsh(k[free][:, free].tocsc(), k=n_modes,
                     M=sp.diags(m[free]).tocsc(), sigma=0, which="LM")
    order = np.argsort(w)
    shapes = np.zeros((problem.ndof, n_modes))
    shapes[free] = v[:, order]
    return w[order], shapes, m


def modal_grid(dev, card: str) -> dict:
    """16(b): banded modal analysis of the 100 x 200 grid at the JAX
    defaults (lumped, n_iter 25, cg_tol 1e-8), against float64 eigsh."""
    import numpy as np

    from pinn_fem_tpu_torch import modal_analysis
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import dia, kernels
    from pinn_fem_tpu_torch.ops.kernels import fused_cg_solve_reference
    from pinn_fem_tpu_torch.solvers import modal

    problem = grid_problem(*GRID)
    data = problem.to_device(dev)
    k = min(2 * MODAL_MODES + 4, problem.free_fixed()[0].size)
    with Spy(dia, "dia_cg_solve") as solves, \
            Spy(modal, "_subspace_iteration") as subspace:
        kernels.reset_launch_counts()
        wall, res = synced(lambda: modal_analysis(
            problem, n_modes=MODAL_MODES, data=data))
        launches = kernels.launch_counts()
    stats = solve_stats(solves)
    ritz_change = subspace[0][2][2].cpu().numpy()
    t0 = time.perf_counter()
    w64, shapes64, mass = float64_grid_modes(problem, MODAL_MODES)
    f64_s = time.perf_counter() - t0
    gap = np.abs(res.eigenvalues / w64 - 1.0)
    mac = np.diag(modal.mac(res.shapes, shapes64))
    args, kwargs, (x, it, _) = solves[-1]
    twin_s, (x_twin, it_twin, _) = synced(
        lambda: fused_cg_solve_reference(*args, **kwargs))
    expected = {"dia_matvec": MODAL_ITERS * k + MODAL_MODES,
                "dia_dir_matvec": pcg_rounds(solves),
                "cg_update": pcg_rounds(solves)}
    log("phase16b_modal_grid", card=card, ndof=problem.ndof,
        n_modes=MODAL_MODES, n_iter=MODAL_ITERS, block_columns=k, wall_s=wall,
        ms_per_pcg_iteration=1e3 * wall / max(stats["pcg_iterations"], 1),
        launches=launches, predicted=expected, **stats,
        eigenvalues=res.eigenvalues.tolist(), float64=w64.tolist(),
        rel_gap=gap.tolist(), mac_vs_float64=mac.tolist(),
        residuals=res.residuals.tolist(), ok=res.ok,
        ritz_change=ritz_change.tolist(), float64_s=f64_s,
        twin_column={"iterations": int(it_twin), "s": twin_s,
                     "bit_equal": bool(torch_equal(x, x_twin))})
    require(launches == dict(expected, material_coefficients=0,
                             material_coefficients_backward=0),
            "16(b): kernels 1-3 launched as the block solves count")
    require(int(it) == int(it_twin) and torch_equal(x, x_twin),
            "16(b): a block solve bit-equal to the twin recurrence")
    require(float(gap.max()) <= MODAL_RTOL,
            f"16(b): eigenvalues within {MODAL_RTOL} of float64 eigsh")
    require(bool(np.all(np.isfinite(res.shapes)))
            and res.shapes.shape == (problem.ndof, MODAL_MODES),
            "16(b): finite shapes of the expected shape")
    return {"launches": launches, "shapes64": shapes64, "mass": mass}


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def float64_strip_buckling(problem, young: float, n_modes: int):
    """(load factors, kappa(K_ff)) of a 2D truss with A = 1 and Young's
    modulus `young`, by a sparse float64 static solve and scipy's dense
    generalized eigh of (-K_g, K) on the free block."""
    import numpy as np
    import scipy.linalg as sl
    import scipy.sparse.linalg as spl

    from pinn_fem_tpu_torch.examples_grid import float64_stiffness

    nodes, el = problem.nodes, problem.elements
    k = young * float64_stiffness(nodes, el)
    free = problem.free_fixed()[0]
    u = np.zeros(problem.ndof)
    u[free] = spl.spsolve(k[free][:, free].tocsc(), problem.loads[free])
    dx = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = np.linalg.norm(dx, axis=1)
    g = np.concatenate([-dx, dx], axis=1) / length[:, None]
    dof = np.concatenate([2 * el[:, :1], 2 * el[:, :1] + 1,
                          2 * el[:, 1:], 2 * el[:, 1:] + 1], axis=1)
    n_e = young * np.sum(g * u[dof], axis=1) / length
    eye = np.eye(2)
    pattern = np.block([[eye, -eye], [-eye, eye]])
    kg = np.zeros((problem.ndof, problem.ndof))
    np.add.at(kg, (dof[:, :, None], dof[:, None, :]),
              (n_e / length)[:, None, None] * pattern)
    k_ff = k[free][:, free].toarray()
    mu = sl.eigh(-kg[np.ix_(free, free)], k_ff, eigvals_only=True)[::-1]
    w = sl.eigvalsh(k_ff)
    return 1.0 / mu[mu > 0][:n_modes], float(w[-1] / w[0])


def buckling_strip(dev, card: str) -> dict:
    """16(c): banded buckling of a compressed cross-braced strip above the
    dense limit, against dense float64."""
    import numpy as np

    from pinn_fem_tpu_torch import Material, TrussProblem, buckling_analysis
    from pinn_fem_tpu_torch.examples_grid import grid_arrays
    from pinn_fem_tpu_torch.ops import dia, kernels
    from pinn_fem_tpu_torch.ops.kernels import fused_cg_solve_reference
    from pinn_fem_tpu_torch.solvers import newton

    rows, cols = BUCKLING_STRIP
    nodes, elements, _, fixed = grid_arrays(rows, cols)
    loads = np.zeros(2 * rows * cols)
    loads[2 * (np.arange(rows) * cols + cols - 1)] = -1.0   # compression
    problem = TrussProblem(nodes, elements,
                           Material(young=BUCKLING_YOUNG, area=1.0,
                                    density=1.0), loads, fixed, 2)
    require(problem.ndof > newton.DENSE_DOF_LIMIT,
            "16(c): the strip is above the dense limit")
    data = problem.to_device(dev)
    k = min(2 * BUCKLING_MODES + 4, problem.free_fixed()[0].size)
    with Spy(dia, "dia_cg_solve") as solves:
        kernels.reset_launch_counts()
        wall, res = synced(lambda: buckling_analysis(
            problem, n_modes=BUCKLING_MODES, data=data))
        launches = kernels.launch_counts()
    stats = solve_stats(solves)
    t0 = time.perf_counter()
    lam64, kappa = float64_strip_buckling(problem, BUCKLING_YOUNG,
                                          BUCKLING_MODES)
    f64_s = time.perf_counter() - t0
    gap = np.abs(res.load_factors / lam64 - 1.0)
    bound_ = max(1e-3, 10.0 * EPS32 * kappa)
    args, kwargs, (x, it, _) = solves[-1]
    x_twin, it_twin, _ = fused_cg_solve_reference(*args, **kwargs)
    expected = {"dia_matvec": 4 * BUCKLING_ITERS * k,
                "dia_dir_matvec": pcg_rounds(solves),
                "cg_update": pcg_rounds(solves)}
    log("phase16c_buckling_strip", card=card, rows=rows, cols=cols,
        ndof=problem.ndof, n_modes=BUCKLING_MODES, n_iter=BUCKLING_ITERS,
        block_columns=k, wall_s=wall, launches=launches, predicted=expected,
        **stats, load_factors=res.load_factors.tolist(),
        float64=lam64.tolist(), rel_gap=gap.tolist(), kappa_k_ff=kappa,
        eps32_kappa=EPS32 * kappa, gate=bound_, ok=res.ok, float64_s=f64_s,
        twin_column_bit_equal=torch_equal(x, x_twin))
    require(EPS32 * kappa <= 1e-2, "16(c): eps32 kappa(K_ff) <= 1e-2")
    require(launches == dict(expected, material_coefficients=0,
                             material_coefficients_backward=0),
            "16(c): kernels 1-3 launched as the solves and products count")
    require(int(it) == int(it_twin) and torch_equal(x, x_twin),
            "16(c): a block solve bit-equal to the twin recurrence")
    require(float(gap.max()) <= bound_,
            "16(c): load factors within max(1e-3, 10 eps32 kappa) of "
            "dense float64")
    require(res.ok and bool(np.all(np.isfinite(res.modes))),
            "16(c): converged, finite modes")
    return launches


def modal_transient_grid(dev, card: str, shapes64, mass) -> dict:
    """16(d): solve_transient(method="modal") on the 100 x 200 grid against
    the central method's probe history, under a load in the span of the
    three lowest float64 modes (M phi_1 + M phi_2 / 2 + M phi_3 / 4), so
    that the six retained modes carry the whole response."""
    import numpy as np

    from pinn_fem_tpu_torch import TrussProblem, solve_transient, stable_dt
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import dynamics

    base = grid_problem(*GRID)
    loads = mass * (shapes64[:, :3] @ np.array([1.0, 0.5, 0.25]))
    problem = TrussProblem(base.nodes, base.elements, base.material, loads,
                           base.fixed_dofs, 2)
    data = problem.to_device(dev)
    nid = np.arange(GRID[0] * GRID[1]).reshape(GRID)
    probe = np.array([2 * nid[-1, -1], 2 * nid[-1, -1] + 1,
                      2 * nid[GRID[0] // 2, -1] + 1])
    dt = stable_dt(problem, data=data)
    kw = dict(record_every=MODAL_TRANSIENT_EVERY, probe_dofs=probe,
              damping=(MODAL_TRANSIENT_ALPHA, 0.0), data=data)
    n = MODAL_TRANSIENT_STEPS
    central_s, central = synced(lambda: solve_transient(
        problem, dt, n, method="central", **kw))
    with Spy(dynamics, "_modal_run") as runs:
        kernels.reset_launch_counts()
        wall, modal = synced(lambda: solve_transient(
            problem, dt, n, method="modal", n_modes=MODAL_MODES, **kw))
        launches = kernels.launch_counts()
    args, kwargs, _ = runs[0]
    kernels.reset_launch_counts()
    run_s, _ = synced(lambda: dynamics._modal_run(*args, **kwargs))
    run_launches = kernels.launch_counts()
    idle = idle_profile(lambda: dynamics._modal_run(*args, **kwargs))
    scale = float(np.abs(central.displacements).max())
    u_gap = float(np.abs(modal.displacements - central.displacements).max())
    ke_gap = float(np.abs(modal.kinetic_energy
                          - central.kinetic_energy).max())
    ke_scale = float(central.kinetic_energy.max())
    log("phase16d_modal_transient", card=card, ndof=problem.ndof, dt=dt,
        n_steps=n, record_every=MODAL_TRANSIENT_EVERY, n_modes=MODAL_MODES,
        modal_s=wall, central_s=central_s, integration_s=run_s,
        ms_per_step=1e3 * run_s / n,
        central_ms_per_step=1e3 * central_s / n, launches=launches,
        integration_launches=run_launches,
        u_gap_over_max=u_gap / scale, ke_gap_over_max=ke_gap / ke_scale,
        **idle)
    require(bool(np.all(np.isfinite(modal.displacements)))
            and modal.displacements.shape == central.displacements.shape,
            "16(d): finite records of the central run's shape")
    require(u_gap <= MODAL_CENTRAL_U_ATOL * scale,
            f"16(d): u within {MODAL_CENTRAL_U_ATOL} of max |u| of central")
    require(ke_gap <= MODAL_CENTRAL_KE_ATOL * ke_scale,
            f"16(d): KE within {MODAL_CENTRAL_KE_ATOL} of central's max")
    require(not any(run_launches.values()),
            "16(d): the modal integration launches no repo kernel")
    return launches


def eigen_refusals(dev, card: str) -> None:
    """16(e): float64 CUDA operands on the banded modal and buckling paths
    raise the ValueError naming PINN_FEM_TPU_X64 and kernels 1-3."""
    import torch

    from pinn_fem_tpu_torch import buckling_analysis, modal_analysis
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels

    problem = grid_problem(*GRID)
    data = problem.to_device(dev, torch.float64)
    refused = {}
    kernels.reset_launch_counts()
    for fn in (modal_analysis, buckling_analysis):
        try:
            fn(problem, n_modes=2, data=data)
            refused[fn.__name__] = None
        except ValueError as e:
            refused[fn.__name__] = str(e)
    launches = kernels.launch_counts()
    log("phase16e_refusals", card=card, refused=refused, launches=launches)
    for name, msg in refused.items():
        require(msg is not None and "PINN_FEM_TPU_X64" in msg
                and "kernels 1-3" in msg,
                f"16(e): float64 {name} refused, naming the variable and "
                "kernels 1-3")
    require(not any(launches.values()), "16(e): no launch before refusal")


def phase_eigen(workdir: Path, dev, card: str) -> dict:
    """Phase 16: modal and buckling analyses on the card.  Returns the
    kernels' launches on each of its paths."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches = eigen_documents(workdir, card)
    lap("a")
    grid = modal_grid(dev, card)
    launches["modal_40k"] = grid["launches"]
    lap("b")
    launches["buckling_strip"] = buckling_strip(dev, card)
    lap("c")
    launches["modal_transient_40k"] = modal_transient_grid(
        dev, card, grid["shapes64"], grid["mass"])
    lap("d")
    eigen_refusals(dev, card)
    lap("e")
    log("phase16_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return launches


# Phase 17: frequency-domain analyses.
FREQ_DOCS = ("dyn-harmonic", "dyn-random", "dyn-fatigue", "dyn-spectrum")
FREQ_DOC_RTOL = 1e-10           # card against the port's CPU run, float64
ZERO_FORCE = 1e-10              # below it a member's stress RMS is noise
HARMONIC_MODES = 12             # 17(b): run_harmonic's default n_modes
FREQ_ZETA = 0.05                # Rayleigh, on modes 1 and 12
HARMONIC_FREQS = 200
# Phase 16(b)'s worst eigenvalue gap from eigsh (4.4e-4, lambda_1) over
# 2 zeta is 4.4e-3 of a peak; the gate keeps a margin of 4.5 over it.
HARMONIC_RTOL = 2e-2
HARMONIC_RESIDUAL_ATOL = 1e-3
RANDOM_MODES = 6                # 17(c)
RANDOM_PSD = 1.0                # white noise S0
RANDOM_RTOL = 2e-2
DAMAGE_RTOL = 3 * RANDOM_RTOL   # Basquin m = 3 triples a stress error
SN = {"exponent": 3.0, "coefficient": 1e10}
SPECTRUM_MODES = 4              # 17(d)
# The grid on its side: 200 rows of 100 nodes, 40,000 DOFs and 79,102
# elements as GRID, pinned along its long edge.  GRID's own lambda_1 /
# lambda_bound is 6.4e-7, below response_spectrum's mechanism guard
# (1e-6, the JAX contract), which refuses it in both packages; this
# orientation's is 1.2e-5.
SPECTRUM_GRID = (200, 100)
SPECTRUM_RTOL = 1e-2
MASS_FRACTION_ATOL = 1e-3
SPECTRUM_TABLE = {"omegas": [0.0, 0.01, 0.05, 0.2, 1.0],
                  "values": [1.0, 2.5, 2.0, 0.8, 0.2]}
DIRECT_GRID = (32, 32)          # 17(e): 2,048 DOFs, the dense limit
DIRECT_FREQS = 120
DIRECT_MODES = 10
DIRECT_ZETA = 0.02
DIRECT_RTOL = 1e-2
FATIGUE_STEPS = 2000            # 17(f): full-rate records for rainflow
# A sine load at 0.05 rad/s, above the grid's 12 lowest modes (omega_1 =
# 1.2e-3): about 18 load cycles in the 2,000 auto steps (dt 1.16 s).
FATIGUE_LOAD_HZ = 0.008
FATIGUE_FORCE_RTOL = 1e-6
FATIGUE_CPU_STEPS = 200
FATIGUE_CPU_RTOL = 2e-3


def zero_launches(launches: dict) -> bool:
    return not any(launches.values())


def freq_probes():
    """(4 probe nodes, 8 probe elements) of the 100 x 200 grid, each with a
    response above 5 % of the largest of its kind in the float64
    reference (the gates hold each to its own peak; a near-zero one, such
    as a y DOF next to the mid-height line or the diagonal into a loaded
    corner, 1e-3 and 4e-5 of the largest, sits at the float32 floor): the
    loaded edge's bottom, quarter height and top and the quarter height's
    middle; horizontal members at the pinned edge (rows 0, 50, 99), the
    two diagonals of its bottom bay, a vertical at the centre, a
    horizontal at the bottom's middle and a diagonal at the quarter
    height's middle."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import grid_arrays

    rows, cols = GRID
    _, elements, _, _ = grid_arrays(rows, cols)
    nid = np.arange(rows * cols).reshape(rows, cols)
    r2, r4, c2 = rows // 2, rows // 4, cols // 2
    pairs = [(nid[0, 0], nid[0, 1]), (nid[r2, 0], nid[r2, 1]),
             (nid[-1, 0], nid[-1, 1]), (nid[0, 0], nid[1, 1]),
             (nid[0, 1], nid[1, 0]), (nid[r2, c2], nid[r2 + 1, c2]),
             (nid[0, c2], nid[0, c2 + 1]), (nid[r4, c2], nid[r4 + 1, c2 + 1])]
    index = {(int(a), int(b)): e for e, (a, b) in enumerate(elements)}
    elms = [index[(int(a), int(b))] for a, b in pairs]
    nodes = [nid[0, -1], nid[r4, -1], nid[-1, -1], nid[r4, c2]]
    return [int(n) for n in nodes], elms


def element_force_rows(nodes, elements, elms):
    """(dofs (n, 4), g / L (n, 4)): N_e = (g / L) . u_e of E = A = 1
    members, in float64."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import _dofs_2d

    nodes = np.asarray(nodes, float)
    el = np.asarray(elements)[elms]
    dx = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = np.linalg.norm(dx, axis=1)
    g = np.concatenate([-dx, dx], axis=1) / length[:, None]
    return _dofs_2d(el), g / length[:, None]


def float64_frf(w2, shapes, mass, loads, mask, om, damping, probe, dofs,
                g_over_l):
    """Float64 modal superposition of eigsh's modes with exact Rayleigh
    modal damping: (X at the probe DOFs, member forces, truncation
    residual ||F - M Phi q|| / ||F||), X and forces (n_freq, n) complex."""
    import numpy as np

    alpha, beta = damping
    f = loads * mask
    q = shapes.T @ f
    den = (w2[None, :] - (om * om)[:, None]
           + 1j * om[:, None] * (alpha + beta * w2)[None, :])
    c = q[None, :] / den                                   # (n_freq, J)
    x = c @ shapes[probe].T
    modal_forces = np.einsum("ek,ekj->ej", g_over_l, shapes[dofs])
    forces = c @ modal_forces.T
    residual = np.linalg.norm(f - mass * mask * (shapes @ q)) \
        / np.linalg.norm(f)
    return x, forces, residual


# Result keys that are relative errors or residual norms, at float64
# noise on a converged run: compared by their absolute difference.
ABSOLUTE = ("rel_error", "max_residual")


def tree_gaps(got, want, path=""):
    """{path: max |got - want| / max |want|} over the numeric lists of two
    result dicts, keys and other values required equal; modal
    participations by magnitude (signs are arbitrary); a zero-force
    member's fatigue statistics left out; ABSOLUTE keys by max |got -
    want|."""
    import numpy as np

    gaps = {}
    if isinstance(want, dict):
        require(list(got) == list(want), f"{path}: the CPU run's keys")
        live = None
        if "stress_rms" in want:
            rms = np.asarray(want["stress_rms"], float)
            live = rms > ZERO_FORCE * rms.max()
        for key in want:
            g, w = got[key], want[key]
            if key == "participation":
                g, w = np.abs(g).tolist(), np.abs(w).tolist()
            if live is not None and key in (
                    "nu0_hz", "nu_peak_hz", "alpha2", "damage_rate",
                    "life_s", "peak_factor", "expected_peak_stress"):
                g = np.asarray(g, float)[live].tolist()
                w = np.asarray(w, float)[live].tolist()
            gaps.update(tree_gaps(g, w, f"{path}/{key}"))
    elif isinstance(want, list) and want and isinstance(want[0], dict):
        require(len(got) == len(want), f"{path}: the CPU run's length")
        for i, (g, w) in enumerate(zip(got, want)):
            gaps.update(tree_gaps(g, w, f"{path}[{i}]"))
    elif isinstance(want, list) and want and not isinstance(want[0], str):
        a, b = np.asarray(got, float), np.asarray(want, float)
        require(a.shape == b.shape, f"{path}: shape of the CPU run's")
        scale = 1.0 if path.endswith(ABSOLUTE) else np.abs(b).max()
        gaps[path] = (float(np.abs(a - b).max() / max(scale, 1e-300))
                      if b.size else 0.0)
    elif isinstance(want, float):
        scale = 1.0 if path.endswith(ABSOLUTE) else abs(want)
        gaps[path] = abs(got - want) / max(scale, 1e-300)
    else:
        require(got == want, f"{path}: equal to the CPU run's")
    return gaps


def frequency_documents(workdir: Path, card: str) -> dict:
    """17(a): the four corpus documents through main() on the card (the
    dense float64 tiers: torch on the card, no repo kernel), each against
    the port's own CPU run."""
    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.analysis import run_analysis
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    launches, gaps = {}, {}
    for name in FREQ_DOCS:
        doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                         .read_text())
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(doc))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        require(main([str(path)]) == 0, f"{name}: exit code 0")
        card_s = time.perf_counter() - t0
        launches[name] = kernels.launch_counts()
        got = json.loads((workdir / f"{name}.res.json").read_text())
        want = run_analysis(parse_problem_dict(doc).problem,
                            doc["analysis"], "cpu")
        doc_gaps = tree_gaps(got, json.loads(json.dumps(want)))
        gaps[name] = {"max": max(doc_gaps.values()),
                      "worst": max(doc_gaps, key=doc_gaps.get), "s": card_s}
        require(gaps[name]["max"] <= FREQ_DOC_RTOL,
                f"17(a) {name}: within {FREQ_DOC_RTOL} of the CPU run")
        require(zero_launches(launches[name]),
                f"17(a) {name}: no repo kernel")
    log("phase17a_documents", card=card, gaps=gaps, launches=launches)
    return launches


def run_cli_document(workdir: Path, name: str, doc: dict):
    """(result, kernels' launches, seconds, dia_cg_solve records, seconds
    in modal_analysis) of one document through main() on the card."""
    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.ops import dia, kernels
    from pinn_fem_tpu_torch.solvers import modal

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    path = workdir / f"{name}.json"
    path.write_text(json.dumps(doc))
    with Spy(dia, "dia_cg_solve") as solves, \
            Timed(modal, "modal_analysis") as modal_calls:
        kernels.reset_launch_counts()
        wall, rc = synced(lambda: main([str(path)]))
        launches = kernels.launch_counts()
    require(rc == 0, f"{name}: exit code 0")
    out = json.loads((workdir / f"{name}.res.json").read_text())
    return out, launches, wall, solves, sum(s for s, _ in modal_calls)


def banded_expected(n_modes: int, solves) -> dict:
    """Kernels' launches of one banded modal solve: kernel 1 n_iter k +
    n_modes, kernels 2 and 3 whole rounds of 32 over the block solves."""
    k = 2 * n_modes + 4
    return {"dia_matvec": MODAL_ITERS * k + n_modes,
            "dia_dir_matvec": pcg_rounds(solves),
            "cg_update": pcg_rounds(solves),
            "material_coefficients": 0,
            "material_coefficients_backward": 0}


def harmonic_grid(workdir: Path, card: str, ref: dict) -> dict:
    """17(b): a "harmonic" document on the 100 x 200 grid, method "modal"
    with 12 modes (28 block columns), Rayleigh zeta 0.05 on modes 1 and
    12, 200 frequencies from 0.5 omega_1 to 1.2 omega_12, 4 probe nodes
    and 8 probe elements, through main(); against the float64
    superposition of eigsh's 12 modes."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.examples_grid import grid_document

    w64 = np.sqrt(ref["w2"])
    damping = ref["damping"]
    om = np.linspace(0.5 * w64[0], 1.2 * w64[HARMONIC_MODES - 1],
                     HARMONIC_FREQS)
    doc = grid_document(*GRID)
    doc["analysis"] = {
        "type": "harmonic", "method": "modal", "n_modes": HARMONIC_MODES,
        "damping": list(damping), "omegas": om.tolist(),
        "probe_nodes": ref["nodes"], "probe_elements": ref["elms"]}
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32,
            "17(b): TF32 off for the float32 contractions")
    out, launches, wall, solves, modal_s = run_cli_document(
        workdir, "harmonic_grid", doc)
    stats = solve_stats(solves)
    probe = np.asarray(out["probe_dofs"])
    x64, n64, res64 = float64_frf(
        ref["w2"][:HARMONIC_MODES], ref["shapes"][:, :HARMONIC_MODES],
        ref["mass"], ref["loads"], ref["mask"], om, damping, probe,
        ref["dofs"], ref["g_over_l"])
    amp, famp = (np.asarray(out[k]) for k in ("amplitude",
                                               "force_amplitude"))
    amp_gap = np.abs(amp - np.abs(x64)).max(0) / np.abs(x64).max(0)
    force_gap = np.abs(famp - np.abs(n64)).max(0) / np.abs(n64).max(0)
    res_gap = float(np.abs(np.asarray(out["residual"]) - res64).max())
    expected = banded_expected(HARMONIC_MODES, solves)
    log("phase17b_harmonic_grid", card=card, ndof=2 * GRID[0] * GRID[1],
        n_modes=HARMONIC_MODES, block_columns=2 * HARMONIC_MODES + 4,
        n_freq=HARMONIC_FREQS, damping=list(damping), wall_s=wall,
        modal_solve_s=modal_s, sweep_and_output_s=wall - modal_s,
        ms_per_pcg_iteration=1e3 * modal_s / max(stats["pcg_iterations"], 1),
        launches=launches, predicted=expected, **stats,
        amplitude_gap_per_probe=amp_gap.tolist(),
        force_gap_per_element=force_gap.tolist(),
        probe_peak_over_largest=(np.abs(x64).max(0)
                                 / np.abs(x64).max()).tolist(),
        element_peak_over_largest=(np.abs(n64).max(0)
                                   / np.abs(n64).max()).tolist(),
        residual=out["residual"][0], residual_float64=res64,
        flagged=len(out["flagged_indices"]),
        eigen_gap_12_13=float(ref["w2"][12] / ref["w2"][11] - 1.0))
    require(launches == expected,
            "17(b): kernels 1-3 launched as the block solves count")
    require(bool(np.all(np.isfinite(amp))) and amp.shape == x64.shape,
            "17(b): finite amplitudes of the expected shape")
    require(float(amp_gap.max()) <= HARMONIC_RTOL
            and float(force_gap.max()) <= HARMONIC_RTOL,
            f"17(b): amplitudes within {HARMONIC_RTOL} of each probe's "
            "peak, against float64")
    require(res_gap <= HARMONIC_RESIDUAL_ATOL,
            f"17(b): residual within {HARMONIC_RESIDUAL_ATOL} of float64")
    return launches


def random_grid(workdir: Path, card: str, ref: dict) -> dict:
    """17(c): a "random" document, white noise over 200 frequencies, 6
    modes, 8 probe elements with a Dirlik fatigue block (m = 3) and a
    first-passage block, through main(); rms and damage rates against the
    float64 superposition of eigsh's 6 modes."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import grid_document
    from pinn_fem_tpu_torch.solvers.fatigue import spectral_fatigue

    w64 = np.sqrt(ref["w2"])
    om = np.linspace(0.5 * w64[0], 1.2 * w64[RANDOM_MODES - 1],
                     HARMONIC_FREQS)
    probe = np.stack([2 * np.asarray(ref["nodes"]),
                      2 * np.asarray(ref["nodes"]) + 1], 1).reshape(-1)
    x64, n64, _ = float64_frf(
        ref["w2"][:RANDOM_MODES], ref["shapes"][:, :RANDOM_MODES],
        ref["mass"], ref["loads"], ref["mask"], om, ref["damping"], probe,
        ref["dofs"], ref["g_over_l"])
    psd64 = np.abs(x64) ** 2 * RANDOM_PSD
    rms64 = np.sqrt(np.trapezoid(psd64, om, axis=0))
    stress_psd64 = np.abs(n64) ** 2 * RANDOM_PSD        # A = 1
    sf64 = spectral_fatigue(om, stress_psd64, SN["exponent"],
                            SN["coefficient"], method="dirlik")
    doc = grid_document(*GRID)
    doc["analysis"] = {
        "type": "random", "method": "modal", "n_modes": RANDOM_MODES,
        "psd": RANDOM_PSD, "damping": list(ref["damping"]),
        "omegas": om.tolist(), "probe_nodes": ref["nodes"],
        "probe_elements": ref["elms"],
        "fatigue": {"sn": SN, "method": "dirlik", "duration": 3600.0},
        "first_passage": {"barrier": (3.0 * rms64).tolist(),
                          "duration": 3600.0}}
    out, launches, wall, solves, modal_s = run_cli_document(
        workdir, "random_grid", doc)
    stats = solve_stats(solves)
    rms_gap = rel_err(out["rms"], rms64)
    damage = np.asarray(out["fatigue"]["damage_rate"])
    damage_gap = np.abs(damage / sf64.damage_rate - 1.0)
    pf = np.asarray(out["first_passage"]["pf"])
    expected = banded_expected(RANDOM_MODES, solves)
    log("phase17c_random_grid", card=card, n_modes=RANDOM_MODES,
        wall_s=wall, modal_solve_s=modal_s, launches=launches,
        predicted=expected, **stats, rms_gap=rms_gap,
        force_rms_gap=rel_err(out["force_rms"],
                              np.sqrt(np.trapezoid(stress_psd64, om,
                                                   axis=0))),
        damage_rate=damage.tolist(),
        damage_rate_float64=sf64.damage_rate.tolist(),
        damage_rel_gap=damage_gap.tolist(), first_passage_pf=pf.tolist())
    require(launches == expected,
            "17(c): kernels 1-3 launched as the block solves count")
    require(rms_gap <= RANDOM_RTOL,
            f"17(c): rms within {RANDOM_RTOL} of float64")
    require(float(damage_gap.max()) <= DAMAGE_RTOL,
            f"17(c): damage rates within {DAMAGE_RTOL} of float64 Dirlik")
    require(bool(np.all((pf >= 0) & (pf <= 1))) and pf.size == probe.size,
            "17(c): first-passage probabilities in [0, 1]")
    return launches


class Memo:
    """module.name returning its first result for every later call while
    in the with block (the spectrum variants reuse one modal solve)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.inner, self.result = getattr(module, name), None

    def __enter__(self):
        def memo(*args, **kwargs):
            if self.result is None:
                self.result = self.inner(*args, **kwargs)
            return self.result

        setattr(self.module, self.name, memo)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def float64_spectrum(ref: dict, sa, combination: str):
    """(peak displacements, member forces of every element, mass
    fraction) of the float64 modal combination of eigsh's modes in `ref`
    (SPECTRUM_GRID's) under ground motion along x."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import grid_arrays

    w2, phi, m = ref["w2"], ref["shapes"], ref["mass"]
    w = np.sqrt(w2)
    r = np.tile([1.0, 0.0], phi.shape[0] // 2) * ref["mask"]
    gamma = phi.T @ (m * r)
    peaks = (gamma * sa(w) / w2)[:, None] * phi.T
    nodes, elements, _, _ = grid_arrays(*SPECTRUM_GRID)
    dofs, g_over_l = element_force_rows(nodes, elements,
                                        np.arange(len(elements)))
    forces = np.einsum("ek,jek->je", g_over_l, peaks[:, dofs])
    if combination == "srss":
        rho = np.eye(w.size)
    else:
        z = FREQ_ZETA
        ratio = w[None, :] / w[:, None]
        rho = (8.0 * z * z * (1.0 + ratio) * ratio ** 1.5
               / ((1.0 - ratio ** 2) ** 2
                  + 4.0 * z * z * ratio * (1.0 + ratio) ** 2))
    combine = (lambda p: np.sqrt(np.maximum(
        np.einsum("ij,ik,jk->k", rho, p, p), 0.0)))
    return (combine(peaks), combine(forces),
            float(np.sum(gamma ** 2) / np.sum(m * r * r)))


def spectrum_grid(workdir: Path, card: str) -> dict:
    """17(d): a "spectrum" document on SPECTRUM_GRID, 4 modes (12 block
    columns), CQC on a tabulated Sa, through main(); then SRSS and the
    history form of Sa on the same modes (modal_analysis memoized: the
    combinations are host work); each against the float64 combination of
    eigsh's 4 modes."""
    import numpy as np

    from pinn_fem_tpu_torch.examples_grid import grid_document, grid_problem
    from pinn_fem_tpu_torch.solvers import modal
    from pinn_fem_tpu_torch.solvers.spectrum import spectrum_from_history

    problem = grid_problem(*SPECTRUM_GRID)
    t0 = time.perf_counter()
    w2, shapes, mass = float64_grid_modes(problem, SPECTRUM_MODES)
    mask = np.ones(problem.ndof)
    mask[problem.fixed_dofs] = 0.0
    ref = {"w2": w2, "shapes": shapes, "mass": mass, "mask": mask}
    f64_s = time.perf_counter() - t0
    w1 = float(np.sqrt(w2[0]))
    history = {"history": {"type": "sine",
                           "frequency_hz": w1 / (2.0 * np.pi)},
               "dt": 0.25 * 2.0 * np.pi / w1 / 20.0, "n_steps": 1600,
               "scale": 0.5}
    record = history["scale"] * np.sin(
        w1 * history["dt"] * np.arange(history["n_steps"]))
    variants = {
        "cqc_tabulated": ("cqc", SPECTRUM_TABLE,
                          lambda om: np.interp(om, SPECTRUM_TABLE["omegas"],
                                               SPECTRUM_TABLE["values"])),
        "srss_tabulated": ("srss", SPECTRUM_TABLE,
                           lambda om: np.interp(om, SPECTRUM_TABLE["omegas"],
                                                SPECTRUM_TABLE["values"])),
        "cqc_history": ("cqc", history,
                        lambda om: spectrum_from_history(
                            record, history["dt"], om, FREQ_ZETA).psa),
    }
    result, launches = {}, None
    with Memo(modal, "modal_analysis"):
        for name, (combination, sa, sa64) in variants.items():
            doc = grid_document(*SPECTRUM_GRID)
            doc["analysis"] = {
                "type": "spectrum", "sa": sa, "direction": [1.0, 0.0],
                "n_modes": SPECTRUM_MODES, "combination": combination,
                "damping_ratio": FREQ_ZETA}
            out, counts, wall, solves, modal_s = run_cli_document(
                workdir, f"spectrum_{name}", doc)
            u64, n64, frac64 = float64_spectrum(ref, sa64, combination)
            gaps = {"displacements": rel_err(out["displacements"], u64),
                    "axial_forces": rel_err(out["axial_forces"], n64),
                    "mass_fraction_gap": abs(out["mass_fraction"] - frac64)}
            result[name] = {"wall_s": wall, "modal_solve_s": modal_s,
                            "launches": counts, **gaps,
                            "mass_fraction": out["mass_fraction"],
                            "modal_ok": out["modal_ok"]}
            if launches is None:
                launches = counts
                expected = banded_expected(SPECTRUM_MODES, solves)
                result[name].update(solve_stats(solves), predicted=expected)
                require(counts == expected,
                        "17(d): kernels 1-3 launched as the block solves "
                        "count")
            require(gaps["displacements"] <= SPECTRUM_RTOL
                    and gaps["axial_forces"] <= SPECTRUM_RTOL,
                    f"17(d) {name}: peaks within {SPECTRUM_RTOL} of "
                    "float64")
            require(gaps["mass_fraction_gap"] <= MASS_FRACTION_ATOL,
                    f"17(d) {name}: mass fraction within "
                    f"{MASS_FRACTION_ATOL} of float64")
    log("phase17d_spectrum_grid", card=card, grid=list(SPECTRUM_GRID),
        n_modes=SPECTRUM_MODES, eigenvalues_float64=w2.tolist(),
        float64_s=f64_s, variants=result)
    return launches


def direct_sweep(card: str, dev) -> dict:
    """17(e): harmonic_response(method="direct", host=False) on the 32 x 32
    grid (2,048 DOFs): 120 frequencies over the lowest 10 resonances, 4
    chunks of 32 float32 block systems of 4,096 x 4,096; the residuals
    against float64 recomputations from the returned X, the unflagged
    points against the float64 dense tier."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import (harmonic_response, modal_analysis,
                                    rayleigh_coefficients)
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import host as H
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import newton

    problem = grid_problem(*DIRECT_GRID)
    require(problem.ndof == newton.DENSE_DOF_LIMIT,
            "17(e): the grid sits at the dense limit")
    w = modal_analysis(problem, n_modes=DIRECT_MODES, device=dev).omegas
    damping = rayleigh_coefficients(w[0], DIRECT_ZETA, w[-1], DIRECT_ZETA)
    om = np.linspace(0.5 * w[0], 1.2 * w[-1], DIRECT_FREQS)
    data = problem.to_device(dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    wall, res = synced(lambda: harmonic_response(
        problem, om, damping=damping, host=False, data=data))
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    f64_s, ref = synced(lambda: harmonic_response(
        problem, om, damping=damping, device=dev))
    x = res.real.astype(float) + 1j * res.imag.astype(float)
    x64 = ref.real + 1j * ref.imag
    mask = H.host_masks(problem)
    k = H.host_stiffness(problem) * mask[:, None] * mask[None, :]
    m = H.host_lumped_mass(problem) * mask
    f = problem.loads * mask
    alpha, beta = damping
    kx, mx = x @ k.T, x * m[None, :]
    r = (kx * (1.0 + 1j * om[:, None] * beta)
         + mx * (1j * om[:, None] * alpha - (om * om)[:, None])
         - f[None, :])
    res64 = np.linalg.norm(r, axis=1) / np.linalg.norm(f)
    ratio = res.residual / res64
    honest = ((np.abs(res.residual - res64) <= 1e-6)
              | ((ratio <= 2.0) & (ratio >= 0.5)))
    keep = ~res.flagged
    gap = (float(np.abs(x[keep] - x64[keep]).max() / np.abs(x64).max())
           if keep.any() else 0.0)
    log("phase17e_direct_sweep", card=card, ndof=problem.ndof,
        n_freq=DIRECT_FREQS, chunks=-(-DIRECT_FREQS // 32),
        damping=list(damping), wall_s=wall,
        ms_per_frequency=1e3 * wall / DIRECT_FREQS, peak_memory_gb=peak_gb,
        float64_tier_s=f64_s, flagged=int(res.flagged.sum()),
        residual_max=float(res.residual.max()),
        residual_float64_max=float(res64.max()),
        residual_ratio_range=[float(ratio.min()), float(ratio.max())],
        unflagged_gap=gap, launches=launches)
    require(bool(np.all(honest)),
            "17(e): each residual within a factor 2 (or 1e-6) of float64")
    require(gap <= DIRECT_RTOL,
            f"17(e): unflagged points within {DIRECT_RTOL} of max |X64|")
    require(zero_launches(launches), "17(e): no repo kernel")
    return launches


def transient_fatigue_grid(workdir: Path, dev, card: str) -> dict:
    """17(f): the 100 x 200 grid's central transient under a sine load,
    2,000 steps recorded every step, 8 probe elements and a rainflow
    fatigue block, through
    main(): kernel 1's launches 1 + n + 2n/r, the force histories against
    a float64 recovery from the same run's recorded element DOFs, damage
    against rainflow_damage on those histories, u against the CPU twin."""
    import numpy as np

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.io import transient_io
    from pinn_fem_tpu_torch.solvers.fatigue import rainflow_damage

    _, elms = freq_probes()
    n = FATIGUE_STEPS
    doc = eg.transient_grid_document(
        *GRID, n_steps=n, record_every=1, probe_elements=elms,
        amplitude={"type": "sine", "frequency_hz": FATIGUE_LOAD_HZ},
        fatigue={"sn": SN, "method": "rainflow"})
    with Spy(transient_io, "_element_force_histories") as recovered:
        out, launches, first_s, _ = transient_document(
            workdir, "transient_fatigue", doc)
    (_, disp, rec_probe, _, _), _, _ = recovered[0]
    dofs, g_over_l = element_force_rows(doc["nodes"], doc["elements"], elms)
    n64 = np.einsum("ek,tek->te", g_over_l,
                    disp[:, np.searchsorted(rec_probe, dofs)])
    forces = np.asarray(out["force_histories"])
    force_gap = rel_err(forces, n64)
    fat = out["fatigue"]
    again = [rainflow_damage(forces[:, e], fat["duration"], SN["exponent"],
                             SN["coefficient"]) for e in range(len(elms))]
    cpu = cpu_twin(doc, FATIGUE_CPU_STEPS, out["dt"])
    k = FATIGUE_CPU_STEPS
    u_gap = history_gap(np.asarray(out["displacements"])[:k],
                        cpu["displacements"])
    cpu_force_gap = history_gap(forces[:k], cpu["force_histories"])
    expected = 1 + n + 2 * n
    log("phase17f_transient_fatigue", card=card, n_steps=n, dt=out["dt"],
        wall_s=first_s, ms_per_step=1e3 * first_s / n, launches=launches,
        predicted_dia_matvec=expected, force_gap_vs_float64=force_gap,
        damage_rate=fat["damage_rate"], cycle_count=fat["cycle_count"],
        u_gap_vs_cpu_twin=u_gap, force_gap_vs_cpu_twin=cpu_force_gap)
    require(launches["dia_matvec"] == expected
            and not any(launches[key] for key in launches
                        if key != "dia_matvec"),
            f"17(f): kernel 1 launched 1 + n + 2n/r = {expected}, no other")
    require(force_gap <= FATIGUE_FORCE_RTOL,
            f"17(f): force histories within {FATIGUE_FORCE_RTOL} of the "
            "float64 recovery")
    require([d for d, _ in again] == fat["damage_rate"]
            and [c for _, c in again] == fat["cycle_count"],
            "17(f): damage equal to rainflow_damage on the histories")
    require(u_gap <= FATIGUE_CPU_RTOL,
            f"17(f): u within {FATIGUE_CPU_RTOL} of the CPU twin")
    return launches


def frequency_refusals(dev, card: str) -> None:
    """17(g): float64 CUDA operands on the banded modal sweep (harmonic,
    random and spectrum) raise the ValueError naming PINN_FEM_TPU_X64 and
    kernels 1-3; mesh= raises NotImplementedError (item 15)."""
    import torch

    from pinn_fem_tpu_torch import (harmonic_response, random_response,
                                    response_spectrum)
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels

    problem = grid_problem(*GRID)
    data = problem.to_device(dev, torch.float64)
    calls = {
        "harmonic_response": lambda: harmonic_response(
            problem, [0.01, 0.02], damping=(0.01, 0.0), method="modal",
            n_modes=2, data=data),
        "random_response": lambda: random_response(
            problem, 1.0, [0.01, 0.02], damping=(0.01, 0.0), method="modal",
            n_modes=2, data=data),
        "response_spectrum": lambda: response_spectrum(
            problem, 1.0, n_modes=2, data=data),
    }
    refused = {}
    kernels.reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    launches = kernels.launch_counts()
    try:
        harmonic_response(problem, [0.01], mesh=object(), device=dev)
        mesh = None
    except NotImplementedError as e:
        mesh = str(e)
    log("phase17g_refusals", card=card, refused=refused, mesh=mesh,
        launches=launches)
    for name, msg in refused.items():
        require(msg is not None and "PINN_FEM_TPU_X64" in msg
                and "kernels 1-3" in msg,
                f"17(g): float64 {name} refused, naming the variable and "
                "kernels 1-3")
    require(zero_launches(launches), "17(g): no launch before refusal")
    require(mesh is not None and "item 15" in mesh,
            "17(g): mesh= refused, naming item 15")


def frequency_reference(dev) -> dict:
    """The 100 x 200 grid's float64 reference shared by 17(b) and 17(c):
    eigsh's 13 lowest modes (12 shapes), the lumped mass, the mask and
    loads, the Rayleigh damping and the probes' element rows."""
    import numpy as np

    from pinn_fem_tpu_torch import rayleigh_coefficients
    from pinn_fem_tpu_torch.examples_grid import grid_arrays, grid_problem

    problem = grid_problem(*GRID)
    t0 = time.perf_counter()
    w2, shapes, mass = float64_grid_modes(problem, HARMONIC_MODES + 1)
    nodes, elms = freq_probes()
    nodes_xy, elements, loads, fixed = grid_arrays(*GRID)
    dofs, g_over_l = element_force_rows(nodes_xy, elements, elms)
    mask = np.ones(problem.ndof)
    mask[fixed] = 0.0
    w = np.sqrt(w2)
    damping = rayleigh_coefficients(w[0], FREQ_ZETA, w[HARMONIC_MODES - 1],
                                    FREQ_ZETA)
    return {"w2": w2, "shapes": shapes[:, :HARMONIC_MODES], "mass": mass,
            "mask": mask, "loads": loads, "damping": damping,
            "nodes": nodes, "elms": elms, "dofs": dofs,
            "g_over_l": g_over_l, "s": time.perf_counter() - t0}


def phase_frequency(workdir: Path, dev, card: str) -> dict:
    """Phase 17: frequency-domain analyses on the card.  Returns the
    kernels' launches on each of its paths."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches = frequency_documents(workdir, card)
    lap("a")
    ref = frequency_reference(dev)
    lap("reference")
    launches["harmonic_modal_40k"] = harmonic_grid(workdir, card, ref)
    lap("b")
    launches["random_modal_40k"] = random_grid(workdir, card, ref)
    lap("c")
    launches["spectrum_modal_40k"] = spectrum_grid(workdir, card)
    lap("d")
    launches["harmonic_direct_2k"] = direct_sweep(card, dev)
    lap("e")
    launches["transient_fatigue_40k"] = transient_fatigue_grid(workdir, dev,
                                                               card)
    lap("f")
    frequency_refusals(dev, card)
    lap("g")
    log("phase17_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return launches


# Phase 18: elastoplastic statics and transients, continuation, reduction.
NONLINEAR_DOCS = ("dyn-plastic", "dyn-continuation", "dyn-reduction")
NONLINEAR_DOC_RTOL = 1e-10      # card against the port's CPU run, float64
PLASTIC_GRID = (40, 80)         # 18(b): 6,400 DOFs, above the dense limit
# sigma_y 0.75 on the grid's unit members (E = A = 1): the loaded corners
# yield from lf 0.75 on, 24 members in the step to lf = 1 and again at
# the reversal's peak (18(b), NVIDIA H100 80GB HBM3, 700.00 W).
PLASTIC_SIGMA_Y = 0.75
PLASTIC_H_ISO = 0.05
PLASTIC_H_KIN = 0.05
# The float32 residual floor of this grid lies above the device tier's
# 1e-5 (max(tol, 1e-5), the JAX contract): u reaches 56 (E = A = 1), and
# its differences over unit members lose ~eps32 * 56 to cancellation.  At
# 1e-5 the float32 Newton stalls at 3.0e-5 (tools/measure_float32_floors.py;
# ROADMAP fault 3.19), so the run passes 1e-4.
PLASTIC_TOL = 1e-4
PLASTIC_U_RTOL = 1e-3
YIELD_SURFACE_RTOL = 1e-4       # a member this near may yield in one run only
PT_STEPS = 2000                 # 18(c): the 100 x 200 grid
PT_EVERY = 20
# sigma_y 1.0 against the grid's dynamic stresses under a trapezoid
# (rise 600 steps, hold 200, fall 600): about 15 % of the members yield
# (18(c) on the card: 11,996 of 79,102).
PT_SIGMA_Y = 1.0
PT_RISE, PT_HOLD, PT_FALL = 600, 200, 600
PT_BETA = 0.1                   # s; zeta 0.1 at omega = 2 / dt
PT_U_RTOL = 2e-3
PT_ENERGY_RTOL = 2e-2           # tests/test_plasticity.py:266-271
PT_IDLE_STEPS = 200
ARCH_PANELS = 1499              # 18(d): 4 (n + 1) = 6,000 DOFs
ARCH_DEPTH = 0.04               # chord spacing / span
ARCH_RISE = 0.1                 # rise / span (sine arch)
# The first limit load of this shape is lambda ~ 3.32e-3 for a unit crown
# load; the path takes arcs of a fixed length (max_dl_growth 1), the
# first of 8e-5 in lambda, so the largest lambda on the path lies within
# 3e-5 of the vertex of the parabola through it and its neighbours in
# both runs (18(d), NVIDIA H100 80GB HBM3, 700.00 W).
ARCH_DLAMBDA = 8e-5
ARCH_STEPS = 200
# Float32 cannot meet the corrector test's 1e-8 |f| here (ROADMAP fault
# 3.19): at the limit point |f_int32 - f_int64| is 3.1e-5, 0.9 % of the
# applied load (u up to 27 on unit members: their elongations lose
# ~eps32 |u| to cancellation).  The float32 run passes 3e-5, between the
# 2e-5 and 5e-5 that bracket it (tools/measure_float32_floors.py: at 5e-5
# predictor-only steps drift and the path fails past the peak); the
# float64 run takes the JAX default 1e-8.
ARCH_TOL_F32 = 3e-5
ARCH_LIMIT_RTOL = 1e-3
TOWER_STORIES = 500             # 18(e): 2,004 DOFs, below the dense limit
CB_MODES = 8
CB_OMEGA_RTOL = 1e-10


def plastic_history():
    import numpy as np

    return np.concatenate([np.linspace(0.125, 1.0, 8),
                           np.linspace(0.875, -1.0, 16),
                           np.linspace(-0.875, 0.0, 8)])


def sign_rule(got: dict, want: dict) -> dict:
    """A reduction result with its Craig-Bampton modal rows and columns of
    k_red and m_red flipped to want's signs (read from m_red's
    master-modal coupling; eigh's signs differ between LAPACK and
    cuSOLVER)."""
    import numpy as np

    if "m_red" not in want:
        return got
    n_m = len(want["master_dofs"])
    mg, mw = np.asarray(got["m_red"]), np.asarray(want["m_red"])
    s = np.ones(mw.shape[0])
    s[n_m:] = np.sign(np.sum(mg[:n_m, n_m:] * mw[:n_m, n_m:], axis=0))
    require(bool(np.all(s != 0)), "18(a): a modal column's sign")
    out = dict(got)
    for key in ("k_red", "m_red"):
        a = np.asarray(got[key])
        out[key] = (s[:, None] * a * s[None, :]).tolist()
    return out


class Tally:
    """Records keep(*args) of every call of module.name while in the with
    block (unlike Spy, holds no reference to the call's tensors)."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, keep
        self.inner, self.calls = getattr(module, name), []

    def __enter__(self):
        def tally(*args, **kwargs):
            self.calls.append(self.keep(*args))
            return self.inner(*args, **kwargs)

        setattr(self.module, self.name, tally)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def nonlinear_documents(workdir: Path, card: str) -> dict:
    """18(a): dyn-plastic, dyn-continuation and dyn-reduction through
    main() on the card (the dense float64 tiers: torch on the card, no
    repo kernel), each against the port's own CPU run, the sign rule on
    Craig-Bampton's modal rows and columns."""
    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.analysis import run_analysis
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import kernels

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    launches, gaps = {}, {}
    for name in NONLINEAR_DOCS:
        doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                         .read_text())
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(doc))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        require(main([str(path)]) == 0, f"{name}: exit code 0")
        card_s = time.perf_counter() - t0
        launches[name] = kernels.launch_counts()
        got = json.loads((workdir / f"{name}.res.json").read_text())
        want = json.loads(json.dumps(run_analysis(
            parse_problem_dict(doc).problem, doc["analysis"], "cpu")))
        doc_gaps = tree_gaps(sign_rule(got, want), want)
        gaps[name] = {"max": max(doc_gaps.values()),
                      "worst": max(doc_gaps, key=doc_gaps.get), "s": card_s,
                      "success": got["success"]}
        require(got["success"], f"18(a) {name}: success")
        require(gaps[name]["max"] <= NONLINEAR_DOC_RTOL,
                f"18(a) {name}: within {NONLINEAR_DOC_RTOL} of the CPU run")
        require(zero_launches(launches[name]),
                f"18(a) {name}: no repo kernel")
    log("phase18a_documents", card=card, gaps=gaps, launches=launches)
    return launches


def yield_differences(f32, f64) -> dict:
    """Members whose yielding at a step (alpha rising) differs between the
    float32 and float64 runs, and whether each lies within
    YIELD_SURFACE_RTOL of the yield surface in the float64 state: a
    member that yields in float64 only by a trial excess f_tr = dalpha
    (E + H_iso + H_kin) within that share of the radius, or stays elastic
    in float64 with |sigma - q| within it of the radius."""
    import numpy as np

    a32, a64 = f32.alpha, f64.alpha
    prev32 = np.vstack([np.zeros_like(a32[:1]), a32[:-1]])
    prev64 = np.vstack([np.zeros_like(a64[:1]), a64[:-1]])
    y32, y64 = a32 > prev32, a64 > prev64
    radius = PLASTIC_SIGMA_Y + PLASTIC_H_ISO * prev64
    excess = (a64 - prev64) * (1.0 + PLASTIC_H_ISO + PLASTIC_H_KIN)
    gap = np.abs(f64.stresses - f64.back_stress) - radius
    near = np.where(y64, excess <= YIELD_SURFACE_RTOL * radius,
                    -gap <= YIELD_SURFACE_RTOL * radius)
    differ = y32 != y64
    return {"differ": int(differ.sum()),
            "differ_off_surface": int((differ & ~near).sum()),
            "yielded_f64_per_step": y64.sum(axis=1).tolist()}


def plastic_statics(dev, card: str) -> dict:
    """18(b): solve_elastoplastic on the 40 x 80 grid (6,400 DOFs, the
    default dispatch's float32 device tier) under 0 -> 1 -> -1 -> 0 in 32
    steps at tol PLASTIC_TOL, against the same history in float64 on the
    card (the device tier on float64 data, tol 1e-9); ms a Newton
    iteration, the LU's share (a second, synchronized run), iterations a
    step, peak memory."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import solve_elastoplastic
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import plasticity

    problem = grid_problem(*PLASTIC_GRID)
    kw = dict(sigma_y=PLASTIC_SIGMA_Y, hardening_iso=PLASTIC_H_ISO,
              hardening_kin=PLASTIC_H_KIN, load_factors=plastic_history(),
              tol=PLASTIC_TOL)
    solve_elastoplastic(problem, device=dev, **dict(
        kw, load_factors=kw["load_factors"][:2]))     # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    wall, f32 = synced(lambda: solve_elastoplastic(problem, device=dev,
                                                   **kw))
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    with Timed(plasticity, "masked_solve") as lu_calls:
        wall_timed, _ = synced(lambda: solve_elastoplastic(
            problem, device=dev, **kw))
    f64_s, f64 = synced(lambda: solve_elastoplastic(
        problem, data=problem.to_device(dev, torch.float64),
        **dict(kw, tol=1e-9)))
    iters = int(f32.iterations.sum())
    u_scale = np.abs(f64.displacements).max(axis=1)
    u_gap = (np.abs(f32.displacements - f64.displacements).max(axis=1)
             / np.abs(f64.displacements).max())
    yields = yield_differences(f32, f64)
    lu_s = sum(s for s, _ in lu_calls)
    log("phase18b_plastic_statics", card=card, ndof=problem.ndof,
        steps=len(f32.load_factors), converged=f32.converged,
        iterations=f32.iterations.tolist(),
        iterations_f64=f64.iterations.tolist(),
        newton_iterations=iters, wall_s=wall,
        ms_per_newton_iteration=1e3 * wall / max(iters, 1),
        lu_share=lu_s / wall_timed, lu_ms=1e3 * lu_s / max(len(lu_calls), 1),
        lu_calls=len(lu_calls), peak_device_gb=peak_gb,
        max_residual=float(f32.residuals.max()),
        u_gap_vs_float64=float(u_gap.max()), u_max=float(u_scale.max()),
        n_plastic=f32.n_plastic.tolist(),
        n_plastic_f64=f64.n_plastic.tolist(), float64_s=f64_s,
        float64_converged=f64.converged, launches=launches, **yields)
    require(f32.converged, "18(b): every float32 step converged")
    require(f64.converged, "18(b): every float64 step converged")
    require(int(f64.n_plastic[:8].sum()) > 0,
            "18(b): part of the grid yields by lf = 1")
    require(float(u_gap.max()) <= PLASTIC_U_RTOL,
            f"18(b): u within {PLASTIC_U_RTOL} of max |u_f64| every step")
    require(yields["differ_off_surface"] == 0,
            f"18(b): yielded sets equal but within {YIELD_SURFACE_RTOL} of "
            "the surface")
    require(zero_launches(launches), "18(b): no repo kernel")
    return launches


def pt_setup(dev):
    """The 100 x 200 grid, its data and the trapezoid amplitude at the
    damped stable step."""
    from pinn_fem_tpu_torch import stable_dt
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.io._common import _amplitude_array

    problem = grid_problem(*GRID)
    data = problem.to_device(dev)
    dt = stable_dt(problem, data=data, damping=(0.0, PT_BETA))
    amp = _amplitude_array({"type": "trapezoid", "t_rise": PT_RISE * dt,
                            "t_hold": PT_HOLD * dt, "t_fall": PT_FALL * dt},
                           PT_STEPS, dt)
    return problem, data, dt, amp


def pt_probes():
    rows, cols = GRID
    nid = [[r * cols + c for c in range(cols)] for r in range(rows)]
    nodes = [nid[0][-1], nid[rows // 2][-1], nid[-1][-1],
             nid[rows // 4][cols // 2]]
    return [2 * n + k for n in nodes for k in (0, 1)]


def float64_plastic_replay(problem, dt, amp, n_steps, beta, probe, dev):
    """The device tier's recurrence on float64 data on the card, K0 v by
    kernel 1's plain version (dia_matvec_reference) in float64: the
    records of solve_transient_plastic's device tier."""
    import torch

    from pinn_fem_tpu_torch.ops.assembly import material_values
    from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
    from pinn_fem_tpu_torch.ops.dia import assemble_dia
    from pinn_fem_tpu_torch.ops.kernels.dia_kernel import (
        dia_matvec_reference)
    from pinn_fem_tpu_torch.ops.mass import lumped_mass
    from pinn_fem_tpu_torch.ops.scatter import segment_sum_dofs
    from pinn_fem_tpu_torch.solvers import newton, plasticity

    f64 = torch.float64
    data = problem.to_device(dev, f64)
    material = problem.material.to(dev)
    layout = newton._dia_layout_of(problem, data)
    diags = assemble_dia(layout, stiffness_coefficients(data, material, 1.0),
                         data.gvec)
    gather = data.ensure_gather_map()
    young, area = material_values(data, material, 1.0)
    params = plasticity._params(*plasticity.params_arrays(
        problem.nelm, PT_SIGMA_Y, PLASTIC_H_ISO, PLASTIC_H_KIN), f64, dev)
    outs = plasticity._plastic_central_run(
        data, young, area, lumped_mass(data, material), data.loads,
        amp[:n_steps], params, dt, 0.0, beta,
        lambda v: dia_matvec_reference(layout, diags, v),
        lambda fe: segment_sum_dofs(fe, gather),
        torch.as_tensor(probe, device=dev), n_steps // PT_EVERY, PT_EVERY)
    return [o.cpu().numpy() for o in outs]


def plastic_transient(dev, card: str) -> dict:
    """18(c): solve_transient_plastic on the 100 x 200 grid (banded),
    central, 2,000 steps under a trapezoid load that yields and unloads
    part of the grid: with beta != 0 kernel 1 launches once a step and its
    plain version never; probe u against a float64 replay on the card; the
    energy balance (with beta = 0: the beta term's dissipation is not in
    the balance); ms a step and the idle share with and without beta."""
    import numpy as np

    from pinn_fem_tpu_torch import solve_transient_plastic
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.kernels import dia_kernel

    problem, data, dt, amp = pt_setup(dev)
    probe = pt_probes()
    kw = dict(sigma_y=PT_SIGMA_Y, hardening_iso=PLASTIC_H_ISO,
              hardening_kin=PLASTIC_H_KIN, dt=dt, record_every=PT_EVERY,
              probe_dofs=probe, data=data)
    runs, stats = {}, {}
    for name, beta in (("beta", PT_BETA), ("beta0", 0.0)):
        solve_transient_plastic(problem, n_steps=PT_EVERY,
                                amplitude=amp[:PT_EVERY],
                                damping=(0.0, beta), **kw)   # warm-up
        with Spy(dia_kernel, "dia_matvec_reference") as plain:
            kernels.reset_launch_counts()
            wall, res = synced(lambda: solve_transient_plastic(
                problem, n_steps=PT_STEPS, amplitude=amp,
                damping=(0.0, beta), **kw))
            launches = kernels.launch_counts()
        idle = idle_profile(lambda: solve_transient_plastic(
            problem, n_steps=PT_IDLE_STEPS, amplitude=amp[:PT_IDLE_STEPS],
            damping=(0.0, beta), **kw))
        runs[name] = (res, launches)
        stats[name] = {"wall_s": wall, "ms_per_step": 1e3 * wall / PT_STEPS,
                       "idle_ms_per_step": idle["wall_ms"] / PT_IDLE_STEPS,
                       "device_idle_share": idle["device_idle_share"],
                       "plain_calls": len(plain), "launches": launches,
                       "yielded": int(np.count_nonzero(res.final_alpha))}
    res, launches = runs["beta"]
    t0 = time.perf_counter()
    rep = float64_plastic_replay(problem, dt, amp, PT_STEPS, PT_BETA, probe,
                                 dev)
    replay_s = time.perf_counter() - t0
    u_gap = rel_err(res.displacements, rep[0])
    r0 = runs["beta0"][0]
    balance = (np.abs(r0.kinetic_energy + r0.strain_energy
                      + r0.plastic_work - r0.external_work).max()
               / np.abs(r0.external_work).max())
    log("phase18c_plastic_transient", card=card, ndof=problem.ndof,
        n_steps=PT_STEPS, dt=dt, beta=PT_BETA, stats=stats,
        predicted_dia_matvec=PT_STEPS, u_gap_vs_float64=u_gap,
        float64_replay_s=replay_s,
        plastic_work_share=float(res.plastic_work[-1]
                                 / np.abs(res.external_work).max()),
        energy_balance_beta0=float(balance))
    require(launches["dia_matvec"] == PT_STEPS
            and not any(launches[k] for k in launches if k != "dia_matvec"),
            f"18(c): kernel 1 launched once a step ({PT_STEPS}), no other")
    require(stats["beta"]["plain_calls"] == 0,
            "18(c): kernel 1's plain version never called on the card")
    require(zero_launches(runs["beta0"][1]),
            "18(c): no launch with beta = 0")
    require(0 < stats["beta"]["yielded"] < problem.nelm,
            "18(c): part of the grid yields")
    require(u_gap <= PT_U_RTOL,
            f"18(c): probe u within {PT_U_RTOL} of the float64 replay")
    require(balance <= PT_ENERGY_RTOL,
            f"18(c): KE + SE + W_p within {PT_ENERGY_RTOL} of W_ext")
    return {"plastic_transient_40k_beta": launches,
            "plastic_transient_40k_beta0": runs["beta0"][1]}


def arch_problem():
    """A sine arch of two chords (spacing ARCH_DEPTH of the span, rise
    ARCH_RISE), ARCH_PANELS cross-braced unit panels, both chords pinned
    at both ends, a unit load down at the crown's top node."""
    import numpy as np

    from pinn_fem_tpu_torch import Material, TrussProblem

    n = ARCH_PANELS
    x = np.arange(n + 1, dtype=float)
    y = ARCH_RISE * n * np.sin(np.pi * x / n)
    nodes = np.concatenate([np.stack([x, y], 1),
                            np.stack([x, y + ARCH_DEPTH * n], 1)])
    top = n + 1
    elements = [[i, i + 1] for i in range(n)] \
        + [[top + i, top + i + 1] for i in range(n)] \
        + [[i, top + i + 1] for i in range(n)] \
        + [[top + i, i + 1] for i in range(n)] \
        + [[i, top + i] for i in range(n + 1)]
    loads = np.zeros(2 * nodes.shape[0])
    loads[2 * (top + n // 2) + 1] = -1.0
    ends = [0, n, top, top + n]
    fixed = np.array([2 * e + k for e in ends for k in (0, 1)])
    return TrussProblem(nodes, np.array(elements),
                        Material(young=1.0, area=1.0, density=1.0), loads,
                        fixed, 2)


def limit_load(res, dof: int):
    """(largest lambda on the path, the limit load; the vertex of the
    parabola in the crown deflection through it and its neighbours,
    logged; whether lambda falls after it)."""
    import numpy as np

    lam = res.load_factors
    i = int(np.argmax(lam))
    vertex = None
    if 0 < i < lam.size - 1:
        w = -res.displacements[i - 1:i + 2, dof]
        c = np.polyfit(w, lam[i - 1:i + 2], 2)
        vertex = float(c[2] - c[1] ** 2 / (4 * c[0]))
    return float(lam[i]), vertex, bool(lam[-1] < lam[i])


def arch_continuation(dev, card: str) -> dict:
    """18(d): solve_riks on the 6,000-DOF arch through its first limit
    point (stop once lambda is back below 0.9 of its peak) on the float32
    device tier (the default above the dense limit, ARCH_TOL_F32), against
    the same path in float64 on the card (the device tier on float64
    data, at the JAX default tol); ms a corrector iteration, LU
    factorizations an iteration."""
    import torch

    from pinn_fem_tpu_torch import solve_riks
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import riks

    problem = arch_problem()
    crown = 2 * (ARCH_PANELS + 1 + ARCH_PANELS // 2) + 1

    def stop_after_peak():
        peak = [float("-inf")]

        def stop(u, lam):
            peak[0] = max(peak[0], lam)
            return lam < 0.9 * peak[0]
        return stop

    kw = dict(n_steps=ARCH_STEPS, initial_dlambda=ARCH_DLAMBDA,
              max_dl_growth=1.0)
    with Tally(riks, "factor_masked", lambda *a: None) as factors, \
            Tally(riks, "solve_factored", lambda *a: a[2].shape[0]) as rhs:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        wall, f32 = synced(lambda: solve_riks(
            problem, tol=ARCH_TOL_F32, stop_fn=stop_after_peak(),
            device=dev, **kw))
        launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    corrector = rhs.count(2)
    predictor = len(rhs) - corrector
    f64_s, f64 = synced(lambda: solve_riks(
        problem, data=problem.to_device(dev, torch.float64),
        stop_fn=stop_after_peak(), **kw))
    lam32 = limit_load(f32, crown)
    lam64 = limit_load(f64, crown)
    gap = abs(lam32[0] - lam64[0]) / abs(lam64[0])
    log("phase18d_arch", card=card, ndof=problem.ndof, wall_s=wall,
        points=int(f32.load_factors.size), converged=f32.converged,
        corrector_iterations=corrector, predictor_solves=predictor,
        lu_per_corrector_iteration=(len(factors) - predictor)
        / max(corrector, 1),
        ms_per_corrector_iteration=1e3 * wall / max(corrector, 1),
        max_residual=float(f32.residuals.max()), tol=ARCH_TOL_F32,
        peak_device_gb=peak_gb, limit_f32=lam32, limit_f64=lam64,
        limit_gap=gap, float64_points=int(f64.load_factors.size),
        float64_s=f64_s, float64_converged=f64.converged,
        launches=launches)
    require(f32.converged and f64.converged,
            "18(d): both paths converged")
    require(lam32[2] and lam64[2], "18(d): lambda falls after its maximum")
    require(gap <= ARCH_LIMIT_RTOL,
            f"18(d): limit load within {ARCH_LIMIT_RTOL} of float64")
    require(len(factors) - predictor == corrector,
            "18(d): one LU a corrector iteration")
    require(zero_launches(launches), "18(d): no repo kernel")
    return launches


def tower_problem():
    """The cross-braced two-chord tower of tests/test_torch_frequency.py,
    TOWER_STORIES stories, top load (0.3, -1.0) on both top nodes."""
    import numpy as np

    from pinn_fem_tpu_torch import Material, TrussProblem

    s_n = TOWER_STORIES
    nodes, elements = [], []
    for s in range(s_n + 1):
        nodes += [[0.0, float(s)], [1.0, float(s)]]
    for s in range(s_n):
        a, b, c, d = 2 * s, 2 * s + 1, 2 * s + 2, 2 * s + 3
        elements += [[a, c], [b, d], [c, d], [a, d], [b, c]]
    loads = np.zeros(2 * len(nodes))
    for node in (2 * s_n, 2 * s_n + 1):
        loads[2 * node: 2 * node + 2] = (0.3, -1.0)
    return TrussProblem(np.array(nodes), np.array(elements),
                        Material(young=1000.0, area=1.0, density=1.0),
                        loads, np.array([0, 1, 2, 3]), 2)


def float64_craig_bampton(problem, masters, n_modes: int):
    """Reduced omegas of Craig-Bampton by scipy in float64: K_ff and the
    lumped mass from the truss, the static basis, the n_modes lowest
    fixed-interface modes of the mass-scaled K_ss, eigh of the pencil."""
    import numpy as np
    import scipy.linalg
    import scipy.sparse as sp

    from pinn_fem_tpu_torch.examples_grid import _dofs_2d

    nodes = np.asarray(problem.nodes, float)
    el = np.asarray(problem.elements)
    dx = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = np.linalg.norm(dx, axis=1)
    g = np.concatenate([-dx, dx], axis=1) / length[:, None]
    dof = _dofs_2d(el)
    ea = 1000.0
    ke = ea * g[:, :, None] * g[:, None, :] / length[:, None, None]
    ndof = 2 * nodes.shape[0]
    k = sp.coo_matrix((ke.ravel(), (np.repeat(dof, 4, 1).ravel(),
                                    np.tile(dof, (1, 4)).ravel())),
                      shape=(ndof, ndof)).toarray()
    m = np.zeros(ndof)
    np.add.at(m, dof, np.repeat(0.5 * length[:, None], 4, 1))
    free = np.setdiff1d(np.arange(ndof), problem.fixed_dofs)
    mi = np.searchsorted(free, masters)
    si = np.setdiff1d(np.arange(free.size), mi)
    kf, mf = k[np.ix_(free, free)], m[free]
    k_ss, k_ms = kf[np.ix_(si, si)], kf[np.ix_(mi, si)]
    d = np.sqrt(mf[si])
    _, y = scipy.linalg.eigh(k_ss / d[:, None] / d[None, :])
    t = np.zeros((free.size, mi.size + n_modes))
    t[mi, np.arange(mi.size)] = 1.0
    t[si, :mi.size] = -np.linalg.solve(k_ss, k_ms.T)
    t[si, mi.size:] = y[:, :n_modes] / d[:, None]
    w2 = scipy.linalg.eigh(t.T @ kf @ t, t.T @ (mf[:, None] * t),
                           eigvals_only=True)
    return np.sqrt(np.maximum(w2, 0.0))


def craig_bampton_tower(workdir: Path, card: str) -> dict:
    """18(e): a Craig-Bampton document of the 500-story tower (top two
    nodes as masters, 8 modes, compare_full) through main() on the card:
    reduced omegas against scipy float64 in this script, the wall time."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.ops import kernels

    problem = tower_problem()
    top = 2 * TOWER_STORIES
    doc = {"nodes": problem.nodes.tolist(),
           "elements": problem.elements.tolist(),
           "material": {"young": 1000.0, "area": 1.0, "density": 1.0},
           "loads": problem.loads.tolist(), "fixed_dofs": [0, 1, 2, 3],
           "solver_type": "fem",
           "analysis": {"type": "reduction", "method": "craig_bampton",
                        "master_nodes": [top, top + 1],
                        "n_modes": CB_MODES, "compare_full": True}}
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    path = workdir / "tower_cb.json"
    path.write_text(json.dumps(doc))
    kernels.reset_launch_counts()
    wall, rc = synced(lambda: main([str(path)]))
    launches = kernels.launch_counts()
    require(rc == 0, "18(e): exit code 0")
    out = json.loads((workdir / "tower_cb.res.json").read_text())
    masters = np.array([2 * top, 2 * top + 1, 2 * top + 2, 2 * top + 3])
    t0 = time.perf_counter()
    want = float64_craig_bampton(problem, masters, CB_MODES)
    scipy_s = time.perf_counter() - t0
    got = np.asarray(out["reduced_omegas"])
    gap = float(np.abs(got - want).max() / want.max())
    log("phase18e_craig_bampton", card=card, ndof=problem.ndof,
        n_reduced=out["n_reduced_dofs"], wall_s=wall, scipy_s=scipy_s,
        omega_gap_vs_scipy=gap, reduced_omegas=got[:6].tolist(),
        frequency_rel_error=out["frequency_rel_error"], launches=launches)
    require(out["n_reduced_dofs"] == masters.size + CB_MODES,
            "18(e): 4 masters + 8 modes")
    require(gap <= CB_OMEGA_RTOL,
            f"18(e): reduced omegas within {CB_OMEGA_RTOL} of scipy")
    require(zero_launches(launches), "18(e): no repo kernel")
    return launches


def nonlinear_refusals(dev, card: str) -> None:
    """18(f): reduction above the dense limit (a truss grid and a shell
    roof) and with data=, each compose key of the transient "plasticity"
    spec, and a float64 CUDA operand at 18(c)'s kernel 1 dispatch (the
    ValueError naming PINN_FEM_TPU_X64 and kernel 1), each before any
    launch."""
    import torch

    from pinn_fem_tpu_torch import (guyan_reduce, reduce_model,
                                    solve_transient_plastic)
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.io.analysis import run_analysis
    from pinn_fem_tpu_torch.ops import kernels

    from pinn_fem_tpu_torch.io.shell_io import parse_shell_document

    small = tower_problem()
    big = grid_problem(*PLASTIC_GRID)
    roof = parse_shell_document(shell_roof_document(24))[0]
    calls = {
        "reduction_above_limit": (lambda: guyan_reduce(big, [10, 11],
                                                       device=dev),
                                  ValueError, "dense-only"),
        "reduction_data": (lambda: guyan_reduce(
            small, [4, 5], data=small.to_device(dev), device=dev),
            ValueError, "drop it"),
        "reduce_model_shell_above_limit": (lambda: reduce_model(
            roof, [6 * midside(24) + 2], device=dev), ValueError,
            "dense-only"),
    }
    base = {"type": "transient", "dt": "auto", "n_steps": 10,
            "plasticity": {"sigma_y": 1.0}}
    for key, value in (("prestress", True), ("load", {"type": "moving"}),
                       ("checkpoint", {"dir": "x", "every": 5}),
                       ("amplitudes", [[1.0]]), ("probe_elements", [0]),
                       ("include_stress_envelope", True),
                       ("geometric_nonlinear", True)):
        calls[f"compose_{key}"] = (
            lambda key=key, value=value: run_analysis(
                small, dict(base, **{key: value}), dev),
            ValueError, f'"{key}"')
    problem, _, dt, amp = pt_setup(dev)
    calls["float64_kernel1"] = (lambda: solve_transient_plastic(
        problem, sigma_y=PT_SIGMA_Y, dt=dt, n_steps=10, amplitude=amp[:10],
        damping=(0.0, PT_BETA), data=problem.to_device(dev, torch.float64)),
        ValueError, "PINN_FEM_TPU_X64")
    refused = {}
    kernels.reset_launch_counts()
    for name, (call, kind, text) in calls.items():
        try:
            call()
            refused[name] = None
        except kind as e:
            refused[name] = str(e)
            require(text in str(e), f"18(f) {name}: the message names "
                    f"{text}")
    launches = kernels.launch_counts()
    log("phase18f_refusals", card=card, refused=refused, launches=launches)
    for name, msg in refused.items():
        require(msg is not None, f"18(f): {name} refused")
    require("kernel 1" in (refused["float64_kernel1"] or ""),
            "18(f): the float64 refusal names kernel 1")
    require(zero_launches(launches), "18(f): no launch before refusal")


def phase_nonlinear(workdir: Path, dev, card: str) -> dict:
    """Phase 18: elastoplastic statics and transients, arc-length
    continuation and Craig-Bampton reduction on the card.  Returns the
    kernels' launches on each of its paths."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches = nonlinear_documents(workdir, card)
    lap("a")
    launches["plastic_static_6k"] = plastic_statics(dev, card)
    lap("b")
    launches.update(plastic_transient(dev, card))
    lap("c")
    launches["riks_arch_6k"] = arch_continuation(dev, card)
    lap("d")
    launches["craig_bampton_tower"] = craig_bampton_tower(workdir, card)
    lap("e")
    nonlinear_refusals(dev, card)
    lap("f")
    log("phase18_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return launches


PLANE_DOCS = ("dyn-plane", "dyn-plane-plastic")    # 19(a)
PLANE_DOC_RTOL = 1e-10          # card against the port's CPU run, float64
PLANE_STRIP = (128, 512)        # 19(b): 132,354 DOFs, 65,536 Q4s
PLANE_STRIP_TOL = 1e-7
PLANE_CLOSED_FORM = 2e-3        # benchmarks/scaling.py:347's gate
PLANE_STRIP_RESIDUAL = 1e-6
# u against a float64 scipy solve of the same float32 diagonals; against
# the float64 operator u carries besides the float32 representation floor
# of K (ROADMAP fault 3.23: 1.79e-3 on the strip, Jacobi-scaled kappa
# 4.7e5), measured in the same run.
PLANE_U_RTOL = 1e-3
PLANE_WARM_RUNS = 3
PLANE_DENSE = (40, 98)          # 19(c): 8,118 DOFs, under the 8192 budget
PLANE_MODES = 6
PLANE_EIG_RTOL = 1e-9
PLANE_SHAPE_ATOL = 1e-7         # of max |phi|, M-normalized, sign-aligned
# Each pair's residual: 1e-9, or above the floor of a backward-stable
# dense float64 eigensolver on mode i, eps64 lambda_max / lambda_i (the
# float64 rounding of K phi alone), times this factor.  The 8,118-DOF
# wall's first mode sits at 13 times that floor (1.2e-9 on the card;
# scipy's generalized eigh at 0.56 times the port's residual on a
# 4,059-DOF wall on the CPU: ROADMAP fault 3.24).
PLANE_EIG_RESIDUAL = 1e-9
PLANE_EIG_FLOOR_FACTOR = 64.0
PLANE_BUCKLING_MODES = 3
PLANE_NEWMARK_STEPS = 500
PLANE_HARMONIC_FREQS = 20
PLANE_DYN_RTOL = 1e-9
PLANE_ANNULUS = (48, 80)        # 19(d): 7,938 DOFs, the float32 tier
PLANE_PLASTIC_U_RTOL = 1e-3
# The float32 tier's Newton stalls above its 1e-5 floor on the cylinder's
# plastic steps (ROADMAP fault 3.22; 2,050 DOFs on the CPU: 1.4-2.0e-5),
# so 19(d)'s gated run asks for 1e-4, as 18(b) does (fault 3.19).
PLANE_PLASTIC_TOL = 1e-4


def plane_strip_problem():
    from pinn_fem_tpu_torch.examples_grid import plane_strip_document
    from pinn_fem_tpu_torch.io.plane_io import parse_plane_document

    return parse_plane_document(plane_strip_document(*PLANE_STRIP))[0]


def plane_documents(workdir: Path, card: str) -> dict:
    """19(a): dyn-plane (modal) and dyn-plane-plastic (the thick-wall
    cylinder, the float64 tier) through main() on the card, each against
    the port's own CPU run at PLANE_DOC_RTOL, mode shapes sign-aligned;
    no repo kernel runs."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.plane_io import run_plane_document
    from pinn_fem_tpu_torch.ops import kernels

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    launches, gaps = {}, {}
    for name in PLANE_DOCS:
        doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                         .read_text())
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(doc))
        kernels.reset_launch_counts()
        card_s, rc = synced(lambda: main([str(path)]))
        require(rc == 0, f"19(a) {name}: exit code 0")
        launches[name] = kernels.launch_counts()
        got = json.loads((workdir / f"{name}.res.json").read_text())
        want = json.loads(json.dumps(run_plane_document(doc, "cpu")))
        if "mode_shapes" in want:
            g, w = np.asarray(got["mode_shapes"]), np.asarray(
                want["mode_shapes"])
            s = np.sign(np.sum(g * w, axis=1))
            require(bool(np.all(s != 0)), f"19(a) {name}: mode signs")
            got["mode_shapes"] = (g * s[:, None]).tolist()
        doc_gaps = tree_gaps(got, want)
        gaps[name] = {"max": max(doc_gaps.values()),
                      "worst": max(doc_gaps, key=doc_gaps.get), "s": card_s,
                      "success": got["success"]}
        require(got["success"], f"19(a) {name}: success")
        require(gaps[name]["max"] <= PLANE_DOC_RTOL,
                f"19(a) {name}: within {PLANE_DOC_RTOL} of the CPU run")
        require(zero_launches(launches[name]), f"19(a) {name}: no repo "
                "kernel")
    log("phase19a_documents", card=card, gaps=gaps, launches=launches)
    return launches


def dia_csr64(layout, diags):
    """The banded operator's diagonals (nd, ndof) as a float64 scipy CSR
    matrix."""
    import numpy as np
    import scipy.sparse as sp

    d = diags.double().cpu().numpy()
    n = layout.ndof
    rows, cols, vals = [], [], []
    for k, off in enumerate(layout.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(d[k, i])
    k = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n))
    k.eliminate_zeros()     # the band's empty slots: no fill for splu
    return k


def float64_sparse_solve(k, f, free):
    import numpy as np
    import scipy.sparse.linalg as spl

    u = np.zeros(f.size)
    u[free] = spl.spsolve(k[free][:, free].tocsc(), f[free])
    return u


def plane_strip_kernels(problem, dev, card: str) -> dict:
    """19(b) first part: kernels 1-3 on the strip's operator (21
    diagonals, bandwidth 261) against their plain versions: the plans,
    kernel 1 within 1e-6 of its twin (bit-equality logged), kernels 2 and
    3 bit for bit; ms of kernel and twin, the bounds, CSR K u's ms."""
    import torch

    from pinn_fem_tpu_torch.models import plane as P
    from pinn_fem_tpu_torch.ops.dia import assemble_dia_blocks
    from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel

    layout = P.plane_dia_layout(problem)
    diags = assemble_dia_blocks(layout, P._stiffness_blocks(
        problem, dev)).float()
    mask = torch.as_tensor(problem.free_mask(), dtype=torch.float32,
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    n = layout.ndof
    u, z, p = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    plan = dia_kernel.stencil_plan(layout)
    dplan = dia_kernel.direction_plan(layout)
    y = dia_kernel.dia_matvec(layout, diags, u)
    y_ref = dia_kernel.dia_matvec_reference(layout, diags, u)
    err1 = max_err(y, y_ref) / float(y_ref.abs().max())
    require(err1 <= 1e-6, "19(b): dia_matvec within 1e-6 of its twin on "
            "the strip")
    beta = torch.tensor(0.37, device=dev)
    got = cg_kernel.dia_dir_matvec(beta, z, p, layout, diags, mask)
    want = cg_kernel.dir_matvec_reference(beta, z, p, layout, diags, mask)
    equal2 = all(torch.equal(a, b) for a, b in zip(got, want))
    require(equal2, "19(b): dia_dir_matvec bit-equal to its twin on the "
            "strip")
    out = tuple(torch.empty_like(t) for t in got)
    launch, _ = cg_kernel.bind_dir_matvec(beta, z, p, layout, diags, mask,
                                          out=out)
    k3 = check_update(layout, dev, gen, got[2], "plane_strip")
    bounds = banded_bounds(layout, got[2].numel(), cg_kernel.UPDATE_BLOCKS)
    k_csr = csr_of(layout, diags)
    stats = {
        "dia_matvec": dict(err=max_err(y, y_ref),
                           bit_equal=bool(torch.equal(y, y_ref)),
                           ms=cuda_ms(lambda: dia_kernel.dia_matvec(
                               layout, diags, u), 200),
                           plain_ms=cuda_ms(lambda: dia_kernel.
                                            dia_matvec_reference(
                                                layout, diags, u), 20),
                           library_ms=cuda_ms(lambda: k_csr @ u, 200),
                           **bounds["dia_matvec"]),
        "dia_dir_matvec": dict(err=max(max_err(a, b)
                                       for a, b in zip(got, want)),
                               bit_equal=equal2, ms=cuda_ms(launch, 200),
                               plain_ms=cuda_ms(
                                   lambda: cg_kernel.dir_matvec_reference(
                                       beta, z, p, layout, diags, mask), 20),
                               library_ms=None, **bounds["dia_dir_matvec"]),
        "cg_update": dict(err=k3["err"], bit_equal=k3["bit_equal"],
                          ms=k3["ms"], plain_ms=k3["plain_ms"],
                          library_ms=None, **bounds["cg_update"]),
    }
    del k_csr
    log("phase19b_kernels", card=card, ndof=n, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth,
        stencil_plan=dict(threads=plan.threads, tile=plan.tile,
                          blocks=plan.blocks, staged=plan.staged,
                          shared_bytes=plan.shared_bytes),
        direction_plan=dict(rows=dplan.rows, threads=dplan.threads,
                            tile=dplan.tile, blocks=dplan.blocks,
                            staged=dplan.staged,
                            shared_bytes=dplan.shared_bytes),
        dia_matvec_rel_err=err1, **stats)
    return stats, (layout, diags, mask)


def plane_strip(workdir: Path, dev, card: str) -> dict:
    """19(b): the JAX package's banded plane benchmark strip at full
    width, once through solve_plane_static_banded(tol=1e-7) and once as a
    document through main(): the closed form, the relative residual, u
    against a float64 scipy solve of the same float32 diagonals and of
    the float64 operator (fault 3.23), the launches (kernels 2 and 3: 32
    ceil(it / 32), kernel 1: 1, the reaction matvec), the host layout
    build, warm wall (median of PLANE_WARM_RUNS), PCG ms an iteration and
    the device's idle share."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.examples_grid import (plane_sparse_matrices,
                                                  plane_strip_document)
    from pinn_fem_tpu_torch.models import plane as P
    from pinn_fem_tpu_torch.ops import dia, kernels

    problem = plane_strip_problem()
    t0 = time.perf_counter()
    P.plane_dia_layout(problem)
    layout_s = time.perf_counter() - t0
    stats, (layout, diags, mask) = plane_strip_kernels(problem, dev, card)
    nx, ny = PLANE_STRIP
    q, e_mod, width = 10.0, 1000.0, 1.0
    kernels.reset_launch_counts()
    with Timed(dia, "dia_cg_solve") as pcg_calls:
        cold_s, (res, iters, rel) = synced(
            lambda: P.solve_plane_static_banded(problem, tol=PLANE_STRIP_TOL,
                                                device=dev))
    launches = {"strip_132k_api": kernels.launch_counts()}
    pcg_s = pcg_calls[0][0]
    warm = []
    for _ in range(PLANE_WARM_RUNS):
        warm.append(synced(lambda: P.solve_plane_static_banded(
            problem, tol=PLANE_STRIP_TOL, device=dev))[0])
    f = torch.as_tensor(problem.loads, dtype=torch.float32, device=dev)
    prof = pcg_profile(layout, diags, f, mask)
    idle = idle_profile(lambda: P.solve_plane_static_banded(
        problem, tol=PLANE_STRIP_TOL, device=dev))
    t0 = time.perf_counter()
    k64, _ = plane_sparse_matrices(problem)
    u64 = float64_sparse_solve(k64, problem.loads, problem.free_dofs())
    ref_s = time.perf_counter() - t0
    u_same = float64_sparse_solve(dia_csr64(layout, diags), problem.loads,
                                  problem.free_dofs())
    u = res.displacements
    scale = np.abs(u64).max()
    closed = float(np.abs(u[0::2] - q * problem.nodes[:, 0] / e_mod).max()
                   / (q * width / e_mod))
    u_gap = float(np.abs(u - u_same).max() / scale)
    u_gap64 = float(np.abs(u - u64).max() / scale)
    floor32 = float(np.abs(u_same - u64).max() / scale)
    rounds = 32 * -(-iters // 32)
    expected = {"dia_matvec": 1, "dia_dir_matvec": rounds,
                "cg_update": rounds}

    doc = plane_strip_document(nx, ny)
    path = workdir / "plane_strip.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    kernels.reset_launch_counts()
    cli_s, rc = synced(lambda: main([str(path)]))
    launches["strip_132k_cli"] = kernels.launch_counts()
    require(rc == 0, "19(b): the strip document's exit code 0")
    out = json.loads((workdir / "plane_strip.res.json").read_text())
    probe = np.asarray(out["probe_dofs"])
    cli_gap = float(np.abs(np.asarray(out["displacements"])
                           - u_same[probe]).max() / scale)
    cli_rounds = 32 * -(-out["iterations"] // 32)
    log("phase19b_strip", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth, iterations=iters,
        relative_residual=rel, closed_form_err=closed,
        u_gap_vs_same_system=u_gap, u_gap_vs_float64=u_gap64,
        float32_representation_floor=floor32, cold_s=cold_s, warm_s=warm,
        warm_median_s=float(np.median(warm)), pcg_s=pcg_s,
        pcg_ms_per_iteration=1e3 * pcg_s / max(iters, 1),
        profile=prof, solve_idle=idle, layout_build_s=layout_s,
        float64_reference_s=ref_s, launches=launches, expected=expected,
        cli_s=cli_s, cli_iterations=out["iterations"],
        cli_relative_residual=out["relative_residual"],
        cli_probe_gap_vs_same_system=cli_gap, cli_tier=out["tier"])
    require(rel < PLANE_STRIP_RESIDUAL, "19(b): relative residual < 1e-6")
    require(closed < PLANE_CLOSED_FORM, "19(b): the closed form within "
            f"{PLANE_CLOSED_FORM}")
    require(u_gap <= PLANE_U_RTOL, f"19(b): u within {PLANE_U_RTOL} of "
            "the float64 solve of the same diagonals")
    require(u_gap64 <= floor32 + PLANE_U_RTOL, "19(b): u within the "
            f"float32 floor + {PLANE_U_RTOL} of float64")
    require(launches["strip_132k_api"] == dict(
        expected, material_coefficients=0,
        material_coefficients_backward=0),
        "19(b): the launches of the formula")
    require(out["tier"] == "banded" and out["relative_residual"]
            < PLANE_STRIP_RESIDUAL, "19(b): the document's banded tier")
    require(cli_gap <= PLANE_U_RTOL, "19(b): the document's probes within "
            f"{PLANE_U_RTOL} of the float64 solve of the same diagonals")
    require(launches["strip_132k_cli"] == dict(
        dia_matvec=1, dia_dir_matvec=cli_rounds, cg_update=cli_rounds,
        material_coefficients=0, material_coefficients_backward=0),
        "19(b): the document's launches of the formula")
    return launches, stats


def plane_dense_problem(top_traction):
    """A 40 x 98 Q4 wall (2 x 4.9, E 1000, nu 0.3, t 0.1, rho 1), its
    bottom edge clamped, a traction on its top edge."""
    from pinn_fem_tpu_torch.io.plane_io import parse_plane_document

    nx, ny = PLANE_DENSE
    return parse_plane_document({
        "element_type": "plane",
        "mesh": {"type": "rect", "width": 0.05 * nx, "height": 0.05 * ny,
                 "nx": nx, "ny": ny},
        "material": {"young": 1000.0, "poisson": 0.3, "thickness": 0.1,
                     "density": 1.0},
        "fixed_nodes": "bottom",
        "edge_loads": [{"nodes": "top", "traction": top_traction}]})[0]


def peak_run(dev, fn):
    """(seconds, peak device GB, fn()) of one synchronized call."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    seconds, out = synced(fn)
    return seconds, torch.cuda.max_memory_allocated(dev) / 1e9, out


def newmark_replay(kf, mf, cf, ff, free, ndof: int, dt: float, amp,
                   probe, every: int = 10):
    """The dense Newmark recurrence of models/plane.newmark_records
    (average acceleration, the load amp[step + 1] a step, the probes
    recorded after every `every`-th step) replayed on one scipy splu of the
    free block's effective stiffness: (n_rec, n_probe)."""
    import numpy as np
    import scipy.sparse.linalg as spl

    a0, a1 = 4.0 / dt ** 2, 2.0 / dt
    lu = spl.splu((kf + a0 * mf + a1 * cf).tocsc())
    uu, vv = np.zeros(free.size), np.zeros(free.size)
    acc = spl.spsolve(mf, ff * amp[0])
    full, rec = np.zeros(ndof), []
    for step in range(len(amp)):
        rhs = ff * amp[min(step + 1, len(amp) - 1)] \
            + mf @ (a0 * uu + 2.0 * a1 * vv + acc) + cf @ (a1 * uu + vv)
        un = lu.solve(rhs)
        vn = a1 * (un - uu) - vv
        acc = a0 * (un - uu) - 2.0 * a1 * vv - acc
        uu, vv = un, vn
        if (step + 1) % every == 0:
            full[free] = uu
            rec.append(full[probe].copy())
    return np.asarray(rec)


def harmonic_replay(kf, mf, cf, ff, om, pos):
    """|X(omega)| at the free-block positions `pos` by one complex scipy
    splu a frequency: (n_freq, n_pos)."""
    import numpy as np
    import scipy.sparse.linalg as spl

    return np.asarray([np.abs(spl.splu(
        (kf - wi * wi * mf + 1j * wi * cf).tocsc()).solve(
            ff.astype(complex))[pos]) for wi in om])


def plane_dense(dev, card: str) -> dict:
    """19(c): the dense float64 analyses at the 8,192-DOF budget on the
    card, each against scipy.sparse float64 on the port's element blocks:
    modal (eigsh shift-invert; eigenvalues, M-normalized sign-aligned
    shapes, each pair's residual), buckling of the wall under a
    compressive top traction (eigsh on the pencil (-K_g, K)), Newmark (a
    replay of the recurrence on one splu) and a harmonic sweep (one
    complex splu a frequency); wall and peak memory of each."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    import torch

    from pinn_fem_tpu_torch import (plane_buckling, plane_harmonic,
                                    plane_modal, plane_stable_dt,
                                    solve_plane_transient)
    from pinn_fem_tpu_torch.examples_grid import plane_sparse_matrices
    from pinn_fem_tpu_torch.models import plane as P
    from pinn_fem_tpu_torch.ops import kernels

    problem = plane_dense_problem([0.2, -0.1])
    free = problem.free_dofs()
    k, m = plane_sparse_matrices(problem, with_mass=True)
    kf = k[free][:, free].tocsc()
    mf = m[free][:, free].tocsc()
    kernels.reset_launch_counts()
    report = {"ndof": problem.ndof, "free": int(free.size)}
    gates = []

    s, gb, modal = peak_run(dev, lambda: plane_modal(problem, PLANE_MODES,
                                                     device=dev))
    t0 = time.perf_counter()
    lam, vec = spl.eigsh(kf, k=PLANE_MODES, M=mf, sigma=0.0, which="LM")
    order = np.argsort(lam)
    lam, vec = lam[order], vec[:, order]
    vec = vec / np.sqrt(np.einsum("ij,ij->j", vec, mf @ vec))
    ref_s = time.perf_counter() - t0
    phi = modal.mode_shapes[:, free].T
    sign = np.sign(np.sum(phi * vec, axis=0))
    shape_gap = float(np.abs(phi * sign - vec).max() / np.abs(vec).max())
    eig_gap = float(np.abs(modal.eigenvalues - lam).max() / lam.max())
    resid = [float(np.linalg.norm(kf @ phi[:, i] - lam_i * (mf @ phi[:, i]))
                   / (lam_i * np.linalg.norm(mf @ phi[:, i])))
             for i, lam_i in enumerate(modal.eigenvalues)]
    # eps64 lambda_max / lambda_i: the residual a backward-stable dense
    # eigensolver leaves on mode i (lambda_max from the Gershgorin bound).
    lam_max = (2.0 / plane_stable_dt(problem, safety=1.0, device=dev)) ** 2
    floor64 = [2.0 ** -52 * lam_max / lam_i for lam_i in modal.eigenvalues]
    report["modal"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                           eig_gap=eig_gap, shape_gap=shape_gap,
                           residuals=resid, eps64_kappa=floor64,
                           frequencies_hz=modal.frequencies_hz.tolist())
    gates += [(eig_gap <= PLANE_EIG_RTOL, "19(c): modal eigenvalues"),
              (shape_gap <= PLANE_SHAPE_ATOL, "19(c): modal shapes"),
              (all(r <= max(PLANE_EIG_RESIDUAL,
                            PLANE_EIG_FLOOR_FACTOR * f)
                   for r, f in zip(resid, floor64)),
               "19(c): modal residuals")]

    comp = plane_dense_problem([0.0, -1.0])
    s, gb, buck = peak_run(dev, lambda: plane_buckling(
        comp, PLANE_BUCKLING_MODES, device=dev))
    t0 = time.perf_counter()
    kc, _ = plane_sparse_matrices(comp)
    u0 = float64_sparse_solve(kc, comp.loads, free)
    kg_blocks, _ = P._geometric_blocks(comp, torch.as_tensor(u0), "cpu")
    dm = comp.dof_map()
    w = dm.shape[1]
    kg = sp.csr_matrix((kg_blocks.numpy().ravel(),
                        (np.repeat(dm, w, axis=1).ravel(),
                         np.tile(dm, (1, w)).ravel())),
                       shape=(comp.ndof, comp.ndof))
    mu = spl.eigsh(-kg[free][:, free].tocsc(), k=PLANE_BUCKLING_MODES,
                   M=kc[free][:, free].tocsc(), which="LA",
                   return_eigenvectors=False)
    lam_ref = np.sort(1.0 / mu[mu > 0])
    ref_s = time.perf_counter() - t0
    buck_gap = float(np.abs(buck.load_factors - lam_ref).max()
                     / lam_ref.max())
    report["buckling"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                              load_factors=buck.load_factors.tolist(),
                              gap=buck_gap)
    gates.append((buck_gap <= PLANE_EIG_RTOL,
                  "19(c): buckling load factors"))

    om1 = float(modal.omegas[0])
    dt = 2.0 * np.pi / om1 / 40.0
    amp = np.sin(0.5 * om1 * dt * np.arange(PLANE_NEWMARK_STEPS))
    damping = (0.02 * om1, 0.02 / om1)
    probe = np.arange(problem.ndof - 8, problem.ndof)
    s, gb, tr = peak_run(dev, lambda: solve_plane_transient(
        problem, dt, PLANE_NEWMARK_STEPS, damping=damping, amplitude=amp,
        probe_dofs=probe, record_every=10, device=dev))
    t0 = time.perf_counter()
    cf = (damping[0] * mf + damping[1] * kf).tocsc()
    ff = problem.loads[free]
    rec = newmark_replay(kf, mf, cf, ff, free, problem.ndof, dt, amp, probe)
    ref_s = time.perf_counter() - t0
    tr_gap = float(np.abs(tr.displacements - rec).max() / np.abs(rec).max())
    report["newmark"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                             steps=PLANE_NEWMARK_STEPS, dt=dt, gap=tr_gap)
    gates.append((tr_gap <= PLANE_DYN_RTOL, "19(c): Newmark probes"))

    om = np.linspace(0.2 * om1, 3.0 * om1, PLANE_HARMONIC_FREQS)
    s, gb, harm = peak_run(dev, lambda: plane_harmonic(
        problem, om, damping=damping, probe_dofs=probe, device=dev))
    t0 = time.perf_counter()
    amp_ref = harmonic_replay(kf, mf, cf, ff, om, np.searchsorted(free,
                                                                  probe))
    ref_s = time.perf_counter() - t0
    h_gap = float(np.abs(harm.amplitude - amp_ref).max()
                  / np.abs(amp_ref).max())
    report["harmonic"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                              frequencies=PLANE_HARMONIC_FREQS, gap=h_gap)
    gates.append((h_gap <= PLANE_DYN_RTOL, "19(c): harmonic amplitudes"))
    launches = kernels.launch_counts()
    report["launches"] = launches
    log("phase19c_dense", card=card, **report)
    for ok, what in gates:
        require(ok, what)
    require(zero_launches(launches), "19(c): no repo kernel")
    return launches


def plane_plastic(dev, card: str) -> dict:
    """19(d): the thick-wall cylinder on the 48 x 80 annulus (7,938 DOFs,
    host=None: the float32 tier) ramped to 0.99 p_lim: once at the
    document's tolerance (the tier's 1e-5 floor; its residuals logged,
    fault 3.22), then at PLANE_PLASTIC_TOL against the float64 tier on
    the card (the document's tolerance): every step converged, u within
    PLANE_PLASTIC_U_RTOL, yielded sets equal but where the yielding run's
    trial excess is within YIELD_SURFACE_RTOL of the yield stress; Newton
    iterations, ms an iteration and the LU's share."""
    import numpy as np

    from pinn_fem_tpu_torch import solve_plane_plastic
    from pinn_fem_tpu_torch.examples_grid import plane_annulus_document
    from pinn_fem_tpu_torch.io.plane_io import parse_plane_document
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.plastic import params_arrays
    from pinn_fem_tpu_torch.solvers import plane_plasticity as PP

    problem, an = parse_plane_document(plane_annulus_document(
        *PLANE_ANNULUS))
    kw = dict(sigma_y=an["sigma_y"], load_factors=an["load_factors"],
              tol=an["tolerance"], max_iter=an["max_iterations"])
    floor_s, floor = synced(lambda: solve_plane_plastic(problem, device=dev,
                                                        **kw))
    gated = dict(kw, tol=PLANE_PLASTIC_TOL)
    kernels.reset_launch_counts()
    wall, peak_gb, f32 = peak_run(dev, lambda: solve_plane_plastic(
        problem, device=dev, **gated))
    launches = kernels.launch_counts()
    with Timed(PP, "masked_solve") as lu_calls:
        wall_timed, _ = synced(lambda: solve_plane_plastic(
            problem, device=dev, **gated))
    sy, hi, hk = params_arrays(problem.nelm, kw["sigma_y"])
    f64_s, f64 = synced(lambda: PP._float64_solve(
        problem, sy, hi, hk, np.asarray(kw["load_factors"]), kw["tol"],
        kw["max_iter"], 1e-8, 1e-12, True, dev))
    iters = int(f32.iterations.sum())
    u_gap = float(np.abs(f32.displacements - f64.displacements).max()
                  / np.abs(f64.displacements).max())
    y32, y64 = f32.eq_plastic[-1] > 0, f64.eq_plastic[-1] > 0
    mu = 1000.0 / (2.0 * 1.3)
    excess = 3.0 * mu * np.where(y32, f32.eq_plastic[-1],
                                 f64.eq_plastic[-1]) / kw["sigma_y"]
    differ = y32 != y64
    off_surface = int(np.count_nonzero(differ
                                       & (excess > YIELD_SURFACE_RTOL)))
    lu_s = sum(s for s, _ in lu_calls)
    log("phase19d_plastic", card=card, ndof=problem.ndof,
        elements=problem.nelm, floor_run=dict(
            s=floor_s, converged=floor.converged,
            iterations=floor.iterations.tolist(),
            residuals=floor.residuals.tolist()),
        tol=PLANE_PLASTIC_TOL, steps=len(f32.load_factors),
        converged=f32.converged, iterations=f32.iterations.tolist(),
        iterations_f64=f64.iterations.tolist(), newton_iterations=iters,
        wall_s=wall, ms_per_newton_iteration=1e3 * wall / max(iters, 1),
        lu_share=lu_s / wall_timed, lu_ms=1e3 * lu_s / max(len(lu_calls), 1),
        lu_calls=len(lu_calls), peak_device_gb=peak_gb,
        max_residual=float(f32.residuals.max()), u_gap_vs_float64=u_gap,
        yielded=int(y32.sum()), yielded_f64=int(y64.sum()),
        yield_differ=int(differ.sum()), differ_off_surface=off_surface,
        float64_s=f64_s, float64_converged=f64.converged, launches=launches)
    require(f32.converged, "19(d): every float32 step converged")
    require(f64.converged, "19(d): every float64 step converged")
    require(u_gap <= PLANE_PLASTIC_U_RTOL, "19(d): u within "
            f"{PLANE_PLASTIC_U_RTOL} of float64")
    require(off_surface == 0, "19(d): yielded sets equal but within "
            f"{YIELD_SURFACE_RTOL} of the surface")
    require(zero_launches(launches), "19(d): no repo kernel")
    return launches


def plane_refusals(dev, card: str) -> None:
    """19(e): mesh= on the banded tier, each plane analysis type of a
    later ROADMAP item, an identification block without a measurement, a
    dense type above the 8,192-DOF budget (the JAX ValueErrors) and a
    prescribed displacement on the banded tier, each refused before any
    launch."""
    from pinn_fem_tpu_torch.examples_grid import plane_strip_document
    from pinn_fem_tpu_torch.io.plane_io import (parse_plane_document,
                                                run_plane_analysis,
                                                run_plane_document)
    from pinn_fem_tpu_torch.models import plane as P
    from pinn_fem_tpu_torch.ops import kernels

    # 33 x 129 nodes: 8,514 DOFs, above the dense budget and the limit.
    big, _ = parse_plane_document(plane_strip_document(32, 128))
    small = plane_dense_problem([0.0, -1.0])
    settled = plane_strip_document(32, 64)
    settled["prescribed"] = [[1, 0.01]]
    calls = {"mesh": (lambda: P.solve_plane_static_banded(
        big, mesh=object(), device=dev), NotImplementedError, "item 15"),
        "budget": (lambda: run_plane_analysis(
            big, {"type": "modal"}, dev), ValueError, "8192-DOF budget"),
        "banded_prescribed": (lambda: run_plane_document(settled, dev),
                              ValueError, "homogeneous supports only")}
    # Sizing and reliability (item 24) run since phase 25's port; a bare
    # block is refused in the JAX package's words.
    for kind, words in (("sizing", "thickness sizing needs stress_limit"),
                        ("reliability", "needs at least one random")):
        calls[kind] = (lambda kind=kind: run_plane_analysis(
            small, {"type": kind}, dev), ValueError, words)
    # Identification (item 23) runs since phase 24's port; a block with no
    # measurement is refused in the JAX package's words.
    calls["identification"] = (lambda: run_plane_analysis(
        small, {"type": "identification"}, dev), ValueError,
        'needs "measured_dofs"')
    refused = {}
    kernels.reset_launch_counts()
    for name, (call, kind, text) in calls.items():
        try:
            call()
            refused[name] = None
        except kind as e:
            refused[name] = str(e)
            require(text in str(e), f"19(e) {name}: the message names "
                    f"{text}")
    launches = kernels.launch_counts()
    log("phase19e_refusals", card=card, refused=refused, launches=launches)
    for name, msg in refused.items():
        require(msg is not None, f"19(e): {name} refused")
    require(zero_launches(launches), "19(e): no launch before refusal")


def phase_plane(workdir: Path, dev, card: str) -> dict:
    """Phase 19: the plane continuum family on the card.  Returns the
    kernels' launches on each of its paths and the kernels' figures on
    the strip's operator."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches = plane_documents(workdir, card)
    lap("a")
    strip_launches, strip_stats = plane_strip(workdir, dev, card)
    launches.update(strip_launches)
    lap("b")
    launches["dense_8k"] = plane_dense(dev, card)
    lap("c")
    launches["plastic_annulus_8k"] = plane_plastic(dev, card)
    lap("d")
    plane_refusals(dev, card)
    lap("e")
    log("phase19_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches, "strip": strip_stats}


SOLID_DOCS = ("dyn-solid", "dyn-solid-plastic",
              "dyn-solid-transient-plastic",
              "dyn-plane-transient-plastic")   # 20(a)
# The two host-bound plastic transient documents, cut in steps (the card
# and the CPU run the same cut document) to keep the script within its
# time: 8,000 and 4,000 steps in the corpus.
SOLID_DOC_STEPS = {"dyn-solid-transient-plastic": 4000,
                   "dyn-plane-transient-plastic": 2000}
SOLID_DOC_RTOL = 1e-10          # the float64 tiers against the CPU run
SOLID_DOC_F32_RTOL = 1e-4       # dyn-solid's banded float32 tier, same
SOLID_CLOSED_FORM = 2e-3        # benchmarks/scaling.py:615's gate
SOLID_COLUMN = (16, 16, 96)     # 20(b): 84,099 DOFs, 24,576 bricks
SOLID_COLUMN_TOL = 1e-8
SOLID_RESIDUAL = 1e-6
SOLID_U_RTOL = 1e-3             # against float64 of the same diagonals
SOLID_WARM_RUNS = 3
SOLID_MODES = 4                 # 20(c): JAX's defaults
SOLID_MODAL_ITERS = 30
SOLID_MODAL_CG_TOL = 1e-7
SOLID_MODAL_RTOL = 1e-2         # pinn_fem_tpu/solvers/modal.py:29-31
SOLID_CENTRAL_STEPS = 1000      # 20(d)
SOLID_CENTRAL_EVERY = 100
SOLID_CENTRAL_BETA = 0.05       # x dt: zeta 0.05 at omega = 2 / dt
SOLID_CENTRAL_RTOL = 2e-3
SOLID_IDLE_STEPS = 200
SOLID_PT_BOX = (24, 24, 48)     # 20(e): 91,875 DOFs, 27,648 bricks
SOLID_PT_STEPS = 500
SOLID_PT_EVERY = 50
SOLID_PT_TRACTION = [1.5, 0.0, 8.0]
SOLID_PT_SIGMA_Y = 12.0
SOLID_PT_H_ISO = 20.0
SOLID_PT_RTOL = 2e-3
SOLID_PLASTIC_BOX = (10, 10, 20)   # 20(e): 7,623 DOFs, under 8192
SOLID_PLASTIC_U_RTOL = 1e-3
SOLID_PLASTIC_TOL = 1e-4        # as 18(b) and 19(d) (faults 3.19, 3.22)
# First yield at the base at load factor 0.83, the plastic moment at 1.25.
SOLID_PLASTIC_SIGMA_Y = 10.0
SOLID_PLASTIC_H_ISO = 20.0
SOLID_PLASTIC_LOADS = [0.6, 0.9, 1.0, 1.1, 1.2]
SOLID_DENSE_BOX = (12, 12, 15)  # 20(f): 8,112 DOFs, under 8192
SOLID_DENSE_MODES = 6
SOLID_BUCKLING_MODES = 3
SOLID_NEWMARK_STEPS = 250
SOLID_HARMONIC_FREQS = 10
SOLID_DYN_RTOL = 1e-9
SOLID_REF_WORKERS = 8           # processes of the harmonic reference


def solid_column(nx, ny, nz, length=4.0, **analysis):
    """(problem, document) of the JAX package's solid benchmark column."""
    from pinn_fem_tpu_torch.examples_grid import solid_column_document
    from pinn_fem_tpu_torch.io.solid_io import parse_solid_document

    doc = solid_column_document(nx, ny, nz, length=length, **analysis)
    return parse_solid_document(doc)[0], doc


def column_closed_form(problem, u, vm, traction=5.0, young=200.0) -> dict:
    """The uniaxial column's closed form: u_z = sigma z / E, u_x = -nu
    sigma x / E, von Mises = sigma, each relative to its largest value."""
    import numpy as np

    x, length = problem.nodes, problem.nodes[:, 2].max()
    uz = np.abs(u[2::3] - traction * x[:, 2] / young).max() \
        / (traction * length / young)
    ux = np.abs(u[0::3] + 0.3 * traction * x[:, 0] / young).max() \
        / (traction * length / young)
    return {"u_z": float(uz), "u_x": float(ux),
            "von_mises": float(np.abs(vm - traction).max() / traction)}


def cpu_cli_processes(workdir: Path, names) -> dict:
    """{name: (process, result path)}: the same CLI on the CPU (one torch
    thread) for each corpus document, each in a process of its own that
    runs while the card runs its copy."""
    outdir = workdir / "cpu"
    outdir.mkdir(exist_ok=True)
    env = dict(os.environ, PINN_FEM_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = {}
    for name in names:
        path = outdir / f"{name}.json"
        path.write_text((ROOT / "examples" / "json" / f"{name}.json")
                        .read_text())
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "pinn_fem_tpu_torch.cli.generic",
             str(path)], cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL), outdir / f"{name}.res.json")
    return procs


def solid_documents(workdir: Path, dev, card: str) -> dict:
    """20(a): dyn-solid (the banded tier: kernels 1 / 2 / 3 launched 1 /
    32 ceil(it / 32) / 32 ceil(it / 32) times, its summaries within
    SOLID_DOC_F32_RTOL of the CPU run and its closed form within 2e-3, the
    full field by the API), dyn-solid-plastic, dyn-solid-transient-plastic
    and dyn-plane-transient-plastic (float64 tiers, within 1e-10 of the
    CPU run, no repo kernel) through main() on the card, each against the
    same CLI run with device "cpu" in a process of its own (started first,
    run alongside); the two plastic transients cut to SOLID_DOC_STEPS."""
    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.solid_io import parse_solid_document
    from pinn_fem_tpu_torch.models import solid as S
    from pinn_fem_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    docs = {}
    for name in SOLID_DOCS:
        docs[name] = json.loads((ROOT / "examples" / "json"
                                 / f"{name}.json").read_text())
        if name in SOLID_DOC_STEPS:
            docs[name]["analysis"]["n_steps"] = SOLID_DOC_STEPS[name]
    procs = ident_cpu_processes(workdir, docs, "cpu20")
    try:
        os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
        launches, report, outs = {}, {}, {}
        for name in SOLID_DOCS:
            path = workdir / f"{name}.json"
            path.write_text(json.dumps(docs[name]))
            kernels.reset_launch_counts()
            card_s, rc = synced(lambda: main([str(path)]))
            require(rc == 0, f"20(a) {name}: exit code 0")
            launches[name] = kernels.launch_counts()
            outs[name] = (card_s, json.loads(
                (workdir / f"{name}.res.json").read_text()))
        card_done_s = time.perf_counter() - t0
        for name, (proc, res_path) in procs.items():
            require(proc.wait(timeout=900) == 0,
                    f"20(a) {name}: the CPU run's exit code 0")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cpu_done_s = time.perf_counter() - t0
    for name in SOLID_DOCS:
        card_s, got = outs[name]
        want = json.loads(procs[name][1].read_text())
        require(got["success"], f"20(a) {name}: success")
        if name != "dyn-solid":
            gaps = tree_gaps(got, want)
            report[name] = {"max": max(gaps.values()),
                            "worst": max(gaps, key=gaps.get), "s": card_s}
            require(report[name]["max"] <= SOLID_DOC_RTOL,
                    f"20(a) {name}: within {SOLID_DOC_RTOL} of the CPU run")
            require(zero_launches(launches[name]),
                    f"20(a) {name}: no repo kernel")
            continue
        rounds = 32 * -(-got["iterations"] // 32)
        expected = dict(dia_matvec=1, dia_dir_matvec=rounds,
                        cg_update=rounds, material_coefficients=0,
                        material_coefficients_backward=0)
        doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                         .read_text())
        problem, an = parse_solid_document(doc)
        res, iters, _ = S.solve_solid_static_banded(
            problem, tol=an["tolerance"], device=dev)
        closed = column_closed_form(problem, res.displacements,
                                    res.von_mises)
        summary_gap = max(rel_err(got[k], want[k]) for k in (
            "max_displacement", "max_von_mises"))
        report[name] = {"s": card_s, "iterations": got["iterations"],
                        "cpu_iterations": want["iterations"],
                        "relative_residual": got["relative_residual"],
                        "summary_gap_vs_cpu": summary_gap,
                        "max_displacement": got["max_displacement"],
                        "max_von_mises": got["max_von_mises"],
                        "api_closed_form": closed, "api_iterations": iters,
                        "expected": expected}
        require(launches[name] == expected,
                "20(a) dyn-solid: the launches of the formula")
        require(summary_gap <= SOLID_DOC_F32_RTOL,
                f"20(a) dyn-solid: within {SOLID_DOC_F32_RTOL} of the CPU "
                "run")
        require(abs(got["max_displacement"] - 0.1) <= SOLID_CLOSED_FORM * 0.1
                and abs(got["max_von_mises"] - 5.0)
                <= SOLID_CLOSED_FORM * 5.0,
                "20(a) dyn-solid: the summaries' closed form")
        require(max(closed.values()) <= SOLID_CLOSED_FORM,
                f"20(a) dyn-solid: the closed form within "
                f"{SOLID_CLOSED_FORM}")
    log("phase20a_documents", card=card, report=report, launches=launches,
        card_runs_s=card_done_s, cpu_runs_s=cpu_done_s)
    return launches


def solid_banded_reference(layout, diags, mask, rhs):
    """u of the masked system M K M + (I - M) with the float64 diagonals
    `diags` ((nd, ndof) numpy), by scipy's banded Cholesky (LAPACK
    dpbtrf): the float64 scipy solve of 20(b)."""
    import numpy as np
    import scipy.linalg as sl

    n = layout.ndof
    hi = int(layout.offsets.max())
    ab = np.zeros((hi + 1, n))
    for k, off in enumerate(layout.offsets):
        if off < 0:
            continue
        i = np.arange(0, n - off)
        ab[hi - off, i + off] = diags[k, i] * mask[i] * mask[i + off]
    ab[hi] += 1.0 - mask
    factor = sl.cholesky_banded(ab, lower=False)
    return factor, sl.cho_solve_banded((factor, False), rhs * mask) * mask


def solid_column_kernels(layout, diags, mask, dev, card: str) -> dict:
    """20(b) first part: kernels 1-3 on the column's operator (99
    diagonals, bandwidth 923) against their plain versions
    (`operator_kernels`)."""
    return operator_kernels(layout, diags, mask, dev, card, "20(b)",
                            "the column", "phase20b_kernels", 20)


def operator_kernels(layout, diags, mask, dev, card: str, item: str,
                     what: str, phase: str, seed: int) -> dict:
    """Kernels 1-3 on one operator against their plain versions: the plans
    (staged or not), kernel 1 within 1e-6 of its twin, kernels 2 and 3
    bit for bit; ms, device us, the bounds (nd + 2, nd + 5 and 8 floats a
    row at 3.35 TB/s), CSR K u's ms (the library yardstick)."""
    import torch

    from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel

    gen = torch.Generator(device=dev).manual_seed(seed)
    n = layout.ndof
    u, z, p = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    plan = dia_kernel.stencil_plan(layout)
    dplan = dia_kernel.direction_plan(layout)
    y = dia_kernel.dia_matvec(layout, diags, u)
    y_ref = dia_kernel.dia_matvec_reference(layout, diags, u)
    err1 = max_err(y, y_ref) / float(y_ref.abs().max())
    require(err1 <= 1e-6, f"{item}: dia_matvec within 1e-6 of its twin on "
            f"{what}")
    beta = torch.tensor(0.37, device=dev)
    got = cg_kernel.dia_dir_matvec(beta, z, p, layout, diags, mask)
    want = cg_kernel.dir_matvec_reference(beta, z, p, layout, diags, mask)
    equal2 = all(torch.equal(a, b) for a, b in zip(got, want))
    require(equal2, f"{item}: dia_dir_matvec bit-equal to its twin on "
            f"{what}")
    out = tuple(torch.empty_like(t) for t in got)
    launch, _ = cg_kernel.bind_dir_matvec(beta, z, p, layout, diags, mask,
                                          out=out)
    k3 = check_update(layout, dev, gen, got[2], what)
    bounds = banded_bounds(layout, got[2].numel(), cg_kernel.UPDATE_BLOCKS)
    k_csr = csr_of(layout, diags)
    _, ev1 = profiled(lambda: [dia_kernel.dia_matvec(layout, diags, u)
                               for _ in range(64)])
    _, ev2 = profiled(lambda: [launch() for _ in range(64)])
    stats = {
        "dia_matvec": dict(err=max_err(y, y_ref),
                           bit_equal=bool(torch.equal(y, y_ref)),
                           ms=cuda_ms(lambda: dia_kernel.dia_matvec(
                               layout, diags, u), 200),
                           device_us=per_launch_us(ev1, "dia_matvec")[1],
                           plain_ms=cuda_ms(lambda: dia_kernel.
                                            dia_matvec_reference(
                                                layout, diags, u), 20),
                           library_ms=cuda_ms(lambda: k_csr @ u, 200),
                           **bounds["dia_matvec"]),
        "dia_dir_matvec": dict(err=max(max_err(a, b)
                                       for a, b in zip(got, want)),
                               bit_equal=equal2, ms=cuda_ms(launch, 200),
                               device_us=per_launch_us(
                                   ev2, "dia_dir_matvec")[1],
                               plain_ms=cuda_ms(
                                   lambda: cg_kernel.dir_matvec_reference(
                                       beta, z, p, layout, diags, mask), 20),
                               library_ms=None, **bounds["dia_dir_matvec"]),
        "cg_update": dict(err=k3["err"], bit_equal=k3["bit_equal"],
                          ms=k3["ms"], plain_ms=k3["plain_ms"],
                          library_ms=None, **bounds["cg_update"]),
    }
    del k_csr
    log(phase, card=card, ndof=n, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth,
        stencil_plan=dict(threads=plan.threads, tile=plan.tile,
                          blocks=plan.blocks, staged=plan.staged,
                          shared_bytes=plan.shared_bytes),
        direction_plan=dict(rows=dplan.rows, threads=dplan.threads,
                            tile=dplan.tile, blocks=dplan.blocks,
                            staged=dplan.staged,
                            shared_bytes=dplan.shared_bytes),
        dia_matvec_rel_err=err1, **stats)
    return stats


def solid_column_statics(workdir: Path, dev, card: str):
    """20(b): the JAX package's solid benchmark column at full width (16 x
    16 x 96, 84,099 DOFs, 99 diagonals, bandwidth 923) through
    solve_solid_static_banded(tol=1e-8) and as a document through main():
    the closed form within 2e-3, the relative residual below 1e-6, u
    within 1e-3 of a float64 scipy solve of the same float32 diagonals
    (and, beside it, the float32 representation floor against the float64
    operator, as fault 3.23), the launches (kernels 2 and 3: 32 ceil(it /
    32), kernel 1: 1), the layout build, the PCG iterations and ms an
    iteration, warm wall (median of 3), the idle share."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.models import solid as S
    from pinn_fem_tpu_torch.ops import dia, kernels

    problem, doc = solid_column(*SOLID_COLUMN, banded=True)
    t0 = time.perf_counter()
    layout = S.solid_dia_layout(problem)
    layout_s = time.perf_counter() - t0
    _, diags, mask = S._banded_operator(problem, torch.float32, dev)
    stats = solid_column_kernels(layout, diags, mask, dev, card)
    kernels.reset_launch_counts()
    with Timed(dia, "dia_cg_solve") as pcg_calls:
        cold_s, (res, iters, rel) = synced(
            lambda: S.solve_solid_static_banded(problem, tol=SOLID_COLUMN_TOL,
                                                device=dev))
    launches = {"column_84k_api": kernels.launch_counts()}
    pcg_s = pcg_calls[0][0]
    warm = [synced(lambda: S.solve_solid_static_banded(
        problem, tol=SOLID_COLUMN_TOL, device=dev))[0]
        for _ in range(SOLID_WARM_RUNS)]
    f = torch.as_tensor(problem.loads, dtype=torch.float32, device=dev)
    prof = pcg_profile(layout, diags, f, mask)
    idle = idle_profile(lambda: S.solve_solid_static_banded(
        problem, tol=SOLID_COLUMN_TOL, device=dev))
    t0 = time.perf_counter()
    m_np = problem.free_mask()
    _, u_same = solid_banded_reference(layout, diags.double().cpu().numpy(),
                                       m_np, problem.loads)
    ref_s = time.perf_counter() - t0
    d64 = dia.assemble_dia_blocks(layout, S._stiffness_blocks3(problem,
                                                                 "cpu"))
    _, u64 = solid_banded_reference(layout, d64.numpy(), m_np,
                                    problem.loads)
    u = res.displacements
    scale = np.abs(u64).max()
    closed = column_closed_form(problem, u, res.von_mises)
    u_gap = float(np.abs(u - u_same).max() / scale)
    u_gap64 = float(np.abs(u - u64).max() / scale)
    floor32 = float(np.abs(u_same - u64).max() / scale)
    rounds = 32 * -(-iters // 32)
    expected = {"dia_matvec": 1, "dia_dir_matvec": rounds,
                "cg_update": rounds, "material_coefficients": 0,
                "material_coefficients_backward": 0}

    path = workdir / "solid_column.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    kernels.reset_launch_counts()
    cli_s, rc = synced(lambda: main([str(path)]))
    launches["column_84k_cli"] = kernels.launch_counts()
    require(rc == 0, "20(b): the column document's exit code 0")
    out = json.loads((workdir / "solid_column.res.json").read_text())
    cli_rounds = 32 * -(-out["iterations"] // 32)
    log("phase20b_column", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth, iterations=iters,
        relative_residual=rel, closed_form_err=closed,
        u_gap_vs_same_system=u_gap, u_gap_vs_float64=u_gap64,
        float32_representation_floor=floor32, cold_s=cold_s, warm_s=warm,
        warm_median_s=float(np.median(warm)), pcg_s=pcg_s,
        pcg_ms_per_iteration=1e3 * pcg_s / max(iters, 1),
        profile=prof, solve_idle=idle, layout_build_s=layout_s,
        float64_reference_s=ref_s, launches=launches, expected=expected,
        cli_s=cli_s, cli_iterations=out["iterations"],
        cli_relative_residual=out["relative_residual"],
        cli_max_displacement=out["max_displacement"])
    require(rel < SOLID_RESIDUAL, "20(b): relative residual < 1e-6")
    require(max(closed.values()) < SOLID_CLOSED_FORM,
            f"20(b): the closed form within {SOLID_CLOSED_FORM}")
    require(u_gap <= SOLID_U_RTOL, f"20(b): u within {SOLID_U_RTOL} of the "
            "float64 solve of the same diagonals")
    require(launches["column_84k_api"] == expected,
            "20(b): the launches of the formula")
    require(out["method"] == "banded"
            and out["relative_residual"] < SOLID_RESIDUAL,
            "20(b): the document's banded tier")
    require(abs(out["max_displacement"] - np.abs(u_same).max())
            <= SOLID_U_RTOL * scale, "20(b): the document's max |u|")
    require(launches["column_84k_cli"] == dict(
        expected, dia_dir_matvec=cli_rounds, cg_update=cli_rounds),
        "20(b): the document's launches of the formula")
    return launches, stats, (problem, layout, diags, mask)


def solid_column_modal(column, dev, card: str) -> dict:
    """20(c): solid_modal_banded of the column (4 modes, n_iter 30,
    cg_tol 1e-7: JAX's defaults) against scipy's eigsh on the same float64
    lumped pencil (shift-invert through the banded Cholesky of K): the
    eigenvalues within 1e-2, kernel 1 n_iter k launches (each block
    solve's warm start) and kernels 2 and 3 the block solves' whole rounds
    of 32, the wall and the PCG iterations."""
    import numpy as np
    import scipy.linalg as sl
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    from pinn_fem_tpu_torch.models import solid as S
    from pinn_fem_tpu_torch.ops import dia, kernels

    problem, layout, _, _ = column
    with Spy(dia, "dia_cg_solve") as solves:
        kernels.reset_launch_counts()
        wall, res = synced(lambda: S.solid_modal_banded(
            problem, n_modes=SOLID_MODES, n_iter=SOLID_MODAL_ITERS,
            cg_tol=SOLID_MODAL_CG_TOL, device=dev))
        launches = kernels.launch_counts()
    stats = dict(solve_stats(solves), rounds=pcg_rounds(solves))
    del solves[:]
    t0 = time.perf_counter()
    free = problem.free_dofs()
    mask = problem.free_mask()
    d64 = dia.assemble_dia_blocks(layout, S._stiffness_blocks3(problem,
                                                                 "cpu"))
    factor, _ = solid_banded_reference(layout, d64.numpy(), mask,
                                       problem.loads)

    def k_inv(b):
        full = np.zeros(problem.ndof)
        full[free] = b
        return sl.cho_solve_banded((factor, False), full)[free]

    md = S.solid_lumped_mass_diag(problem, "cpu")[free]
    op = spl.LinearOperator((free.size, free.size), matvec=k_inv,
                            dtype=float)
    k_ff = dia_csr64(layout, d64)[free][:, free]
    w64 = np.sort(spl.eigsh(k_ff, k=SOLID_MODES, M=sp.diags(md), sigma=0.0,
                            which="LM", OPinv=op, tol=1e-10,
                            return_eigenvectors=False))
    ref_s = time.perf_counter() - t0
    gap = np.abs(res.eigenvalues / w64 - 1.0)
    k = min(2 * SOLID_MODES + 4, free.size)
    expected = {"dia_matvec": SOLID_MODAL_ITERS * k,
                "dia_dir_matvec": stats["rounds"],
                "cg_update": stats["rounds"], "material_coefficients": 0,
                "material_coefficients_backward": 0}
    log("phase20c_modal", card=card, ndof=problem.ndof,
        n_modes=SOLID_MODES, n_iter=SOLID_MODAL_ITERS, block_columns=k,
        wall_s=wall, ms_per_pcg_iteration=1e3 * wall
        / max(stats["pcg_iterations"], 1), launches=launches,
        expected=expected, **stats,
        eigenvalues=res.eigenvalues.tolist(), float64=w64.tolist(),
        rel_gap=gap.tolist(), float64_reference_s=ref_s)
    require(launches == expected, "20(c): kernel 1 launched n_iter k times "
            "(the warm starts), kernels 2-3 as the block solves count")
    require(float(gap.max()) <= SOLID_MODAL_RTOL,
            f"20(c): eigenvalues within {SOLID_MODAL_RTOL} of float64 eigsh")
    require(res.mode_shapes.shape == (SOLID_MODES, problem.ndof)
            and bool(np.all(np.isfinite(res.mode_shapes))),
            "20(c): finite shapes of the expected shape")
    return launches


def central_twin(problem, layout, dt, beta, n_steps, every, probe, dev):
    """The banded central run's recurrence in float64 on the card, K u by
    a float64 CSR product of the float64 diagonals (the twin of kernel 1's
    operator): solvers/dynamics._central_run with the port's records."""
    import torch

    from pinn_fem_tpu_torch.models import solid as S
    from pinn_fem_tpu_torch.ops.dia import assemble_dia_blocks
    from pinn_fem_tpu_torch.solvers.dynamics import _central_run, _Records

    f64 = torch.float64
    k = csr_of(layout, assemble_dia_blocks(layout, S._stiffness_blocks3(
        problem, dev)).contiguous())
    mask = torch.as_tensor(problem.free_mask(), dtype=f64, device=dev)
    m = S._lumped_mass(problem, dev) * mask + (1.0 - mask)
    loads = S._t(problem.loads, dev) + S._body_force_vectors3(problem, dev)
    records = _Records(n_steps // every, torch.as_tensor(probe, device=dev),
                       mask)
    zeros = torch.zeros_like(mask)
    _central_run(lambda u: (k @ (u * mask)) * mask, m, mask,
                 lambda i: loads, float(dt), 0.0, float(beta), zeros, zeros,
                 records, n_steps // every, every)
    return records.us.cpu().numpy()


def solid_column_central(column, dev, card: str) -> dict:
    """20(d): solve_solid_transient_banded of the column, 2,000 steps at
    solid_stable_dt under a unit step load, once with beta = 0 and once
    with beta = 0.05 dt: kernel 1 exactly 1 + n + 2 n / r and 2 + 2n + 3 n
    / r times, probe u within 2e-3 of the float64 twin run, ms a step and
    the idle share."""
    import numpy as np

    from pinn_fem_tpu_torch.models import solid as S
    from pinn_fem_tpu_torch.ops import kernels

    problem, layout, _, _ = column
    n, r = SOLID_CENTRAL_STEPS, SOLID_CENTRAL_EVERY
    top = np.flatnonzero(problem.nodes[:, 2] == problem.nodes[:, 2].max())
    mid = np.flatnonzero(np.isclose(problem.nodes[:, 2],
                                    0.5 * problem.nodes[:, 2].max()))
    probe = np.concatenate([3 * top[[0, -1]] + 2, 3 * mid[[0, -1]] + 2,
                            3 * top[[-1]]])
    dt0 = S.solid_stable_dt(problem, device=dev)
    launches, stats = {}, {}
    for name, beta in (("beta0", 0.0), ("beta", SOLID_CENTRAL_BETA * dt0)):
        dt = S.solid_stable_dt(problem, damping=(0.0, beta), device=dev)
        kw = dict(damping=(0.0, beta), probe_dofs=probe, device=dev)
        S.solve_solid_transient_banded(problem, dt, r, record_every=r,
                                       **kw)                  # warm-up
        kernels.reset_launch_counts()
        wall, res = synced(lambda: S.solve_solid_transient_banded(
            problem, dt, n, record_every=r, **kw))
        launches[f"central_84k_{name}"] = kernels.launch_counts()
        idle = idle_profile(lambda: S.solve_solid_transient_banded(
            problem, dt, SOLID_IDLE_STEPS, record_every=SOLID_IDLE_STEPS,
            **kw))
        t0 = time.perf_counter()
        twin = central_twin(problem, layout, dt, beta, n, r, probe, dev)
        twin_s = time.perf_counter() - t0
        expected = (1 + n + 2 * n // r if beta == 0.0
                    else 2 + 2 * n + 3 * n // r)
        stats[name] = {"dt": dt, "beta": beta, "wall_s": wall,
                       "ms_per_step": 1e3 * wall / n,
                       "idle_ms_per_step": idle["wall_ms"] / SOLID_IDLE_STEPS,
                       "device_idle_share": idle["device_idle_share"],
                       "u_gap_vs_float64": rel_err(res.displacements, twin),
                       "peak_u": float(np.abs(twin).max()),
                       "float64_twin_s": twin_s,
                       "expected_dia_matvec": expected}
        require(launches[f"central_84k_{name}"] == dict(
            dia_matvec=expected, dia_dir_matvec=0, cg_update=0,
            material_coefficients=0, material_coefficients_backward=0),
            f"20(d) {name}: kernel 1 launched {expected} times, no other")
        require(stats[name]["u_gap_vs_float64"] <= SOLID_CENTRAL_RTOL,
                f"20(d) {name}: u within {SOLID_CENTRAL_RTOL} of the "
                "float64 twin")
    log("phase20d_central", card=card, ndof=problem.ndof, n_steps=n,
        record_every=r, stats=stats, launches=launches)
    return launches


def pt_box_problem():
    """The 24 x 24 x 48 box (1 x 1 x 2) clamped at z = 0 under a
    tension-shear top traction: the bending stress near the base yields
    part of it."""
    from pinn_fem_tpu_torch.io.solid_io import parse_solid_document

    nx, ny, nz = SOLID_PT_BOX
    return parse_solid_document({
        "element_type": "solid",
        "mesh": {"type": "box", "lx": 1.0, "ly": 1.0, "lz": 2.0,
                 "nx": nx, "ny": ny, "nz": nz},
        "material": {"young": 200.0, "poisson": 0.3, "density": 2.0},
        "fixed_nodes": "z_min",
        "surface_loads": [{"face": "z_max",
                           "traction": SOLID_PT_TRACTION}]})[0]


def float64_solid_plastic_run(problem, dt, amp, beta, probe, dev):
    """The plastic transient's recurrence in float64 on the card (the
    general gather, the float64 scatter, beta K0 v by the blocks): the
    float64 run of 20(e)."""
    import torch

    from pinn_fem_tpu_torch.ops.plastic import params_arrays
    from pinn_fem_tpu_torch.solvers import continuum_transient_plastic as C

    fam = C._solid_family(problem, None, torch.float64, dev)
    mats = tuple(fam.t(a) for a in params_arrays(
        problem.nelm, SOLID_PT_SIGMA_Y, SOLID_PT_H_ISO, 0.0))
    outs = C._run(fam, mats, dt, amp, 0.0, beta, SOLID_PT_EVERY,
                  len(amp) // SOLID_PT_EVERY,
                  torch.as_tensor(probe, device=dev), structured=False)
    return [o.cpu().numpy() for o in outs]


def solid_plastic_transient(dev, card: str) -> dict:
    """20(e) first part: solve_solid_transient_plastic on the 24 x 24 x 48
    box (91,875 DOFs, float32 tier, structured gather and scatter) with
    beta != 0 under a ramp that yields part of it: kernel 1 exactly once
    a step (beta K0 v), no ndof^2 array (peak memory far below ndof^2 x 4
    bytes), probe u within 2e-3 of the float64 run on the card; ms a step,
    the idle share, peak memory."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch import solid_stable_dt, \
        solve_solid_transient_plastic
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.kernels import dia_kernel

    problem = pt_box_problem()
    n, r = SOLID_PT_STEPS, SOLID_PT_EVERY
    dt0 = solid_stable_dt(problem, device=dev)
    beta = SOLID_CENTRAL_BETA * dt0
    dt = solid_stable_dt(problem, damping=(0.0, beta), device=dev)
    amp = np.minimum(np.arange(n) / (0.6 * n), 1.0)
    top = np.flatnonzero(problem.nodes[:, 2] == 2.0)
    probe = np.concatenate([3 * top[[0, -1]] + 2, 3 * top[[0, -1]]])
    kw = dict(sigma_y=SOLID_PT_SIGMA_Y, hardening_iso=SOLID_PT_H_ISO,
              dt=dt, damping=(0.0, beta), probe_dofs=probe, device=dev)
    solve_solid_transient_plastic(problem, n_steps=r, amplitude=amp[:r],
                                  record_every=r, **kw)       # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    with Spy(dia_kernel, "dia_matvec_reference") as plain:
        kernels.reset_launch_counts()
        wall, res = synced(lambda: solve_solid_transient_plastic(
            problem, n_steps=n, amplitude=amp, record_every=r, **kw))
        launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    idle = idle_profile(lambda: solve_solid_transient_plastic(
        problem, n_steps=SOLID_IDLE_STEPS, amplitude=amp[:SOLID_IDLE_STEPS],
        record_every=SOLID_IDLE_STEPS, **kw))
    t0 = time.perf_counter()
    ref = float64_solid_plastic_run(problem, dt, amp, beta, probe, dev)
    ref_s = time.perf_counter() - t0
    u_gap = rel_err(res.displacements, ref[0])
    dense_gb = 4.0 * problem.ndof ** 2 / 1e9
    yielded = int(np.count_nonzero(res.final_eq_plastic))
    log("phase20e_plastic_transient", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_steps=n, dt=dt, beta=beta, wall_s=wall,
        ms_per_step=1e3 * wall / n,
        idle_ms_per_step=idle["wall_ms"] / SOLID_IDLE_STEPS,
        device_idle_share=idle["device_idle_share"], peak_device_gb=peak_gb,
        dense_float32_k_gb=dense_gb, launches=launches,
        plain_calls=len(plain), u_gap_vs_float64=u_gap,
        float64_run_s=ref_s, yielded=yielded,
        plastic_work_share=float(res.plastic_work[-1]
                                 / np.abs(res.external_work).max()))
    require(launches == dict(dia_matvec=n, dia_dir_matvec=0, cg_update=0,
                             material_coefficients=0,
                             material_coefficients_backward=0),
            f"20(e): kernel 1 launched once a step ({n}), no other")
    require(len(plain) == 0, "20(e): kernel 1's plain version never "
            "called on the card")
    require(peak_gb < 0.1 * dense_gb, "20(e): no ndof^2 array (peak far "
            "below a dense float32 K)")
    require(0 < yielded < problem.nelm, "20(e): part of the box yields")
    require(u_gap <= SOLID_PT_RTOL,
            f"20(e): probe u within {SOLID_PT_RTOL} of the float64 run")
    return {"plastic_transient_92k": launches}


def solid_plastic_statics(dev, card: str) -> dict:
    """20(e) second part: solve_solid_plastic on the 10 x 10 x 20 column
    (7,623 DOFs: the float32 tier), clamped at z = 0 and bent by a shear
    top traction past first yield, at SOLID_PLASTIC_TOL, against the float64 tier on the card: u
    within 1e-3 (or the measured floor, fault 3.22), yielded sets equal
    but within 1e-4 of the surface; ms a Newton iteration, the LU's share,
    peak memory."""
    import numpy as np

    from pinn_fem_tpu_torch import solve_solid_plastic
    from pinn_fem_tpu_torch.io.solid_io import parse_solid_document
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.ops.plastic import params_arrays
    from pinn_fem_tpu_torch.solvers import plane_plasticity, solid_plasticity

    nx, ny, nz = SOLID_PLASTIC_BOX
    problem, _ = parse_solid_document({
        "element_type": "solid",
        "mesh": {"type": "box", "lx": 1.0, "ly": 1.0, "lz": 2.0,
                 "nx": nx, "ny": ny, "nz": nz},
        "material": {"young": 200.0, "poisson": 0.3, "density": 2.0},
        "fixed_nodes": "z_min",
        "surface_loads": [{"face": "z_max", "traction": [1.0, 0.0, 0.0]}]})
    kw = dict(sigma_y=SOLID_PLASTIC_SIGMA_Y,
              hardening_iso=SOLID_PLASTIC_H_ISO,
              load_factors=SOLID_PLASTIC_LOADS, tol=SOLID_PLASTIC_TOL,
              max_iter=40)
    kernels.reset_launch_counts()
    wall, peak_gb, f32 = peak_run(dev, lambda: solve_solid_plastic(
        problem, device=dev, **kw))
    launches = kernels.launch_counts()
    with Timed(plane_plasticity, "masked_solve") as lu_calls:
        wall_timed, _ = synced(lambda: solve_solid_plastic(
            problem, device=dev, **kw))
    sy, hi, hk = params_arrays(problem.nelm, kw["sigma_y"],
                               kw["hardening_iso"])
    f64_s, f64 = synced(lambda: solid_plasticity._float64_solve(
        problem, sy, hi, hk, np.asarray(kw["load_factors"]), 1e-9,
        kw["max_iter"], 1e-8, 1e-12, True, dev))
    iters = int(f32.iterations.sum())
    u_gap = float(np.abs(f32.displacements - f64.displacements).max()
                  / np.abs(f64.displacements).max())
    y32, y64 = f32.eq_plastic[-1] > 0, f64.eq_plastic[-1] > 0
    mu = 200.0 / (2.0 * 1.3)
    excess = 3.0 * mu * np.where(y32, f32.eq_plastic[-1],
                                 f64.eq_plastic[-1]) / kw["sigma_y"]
    differ = y32 != y64
    off_surface = int(np.count_nonzero(differ
                                       & (excess > YIELD_SURFACE_RTOL)))
    lu_s = sum(s for s, _ in lu_calls)
    log("phase20e_plastic_statics", card=card, ndof=problem.ndof,
        elements=problem.nelm, tol=SOLID_PLASTIC_TOL,
        steps=len(f32.load_factors), converged=f32.converged,
        iterations=f32.iterations.tolist(),
        iterations_f64=f64.iterations.tolist(), newton_iterations=iters,
        wall_s=wall, ms_per_newton_iteration=1e3 * wall / max(iters, 1),
        lu_share=lu_s / wall_timed, lu_ms=1e3 * lu_s / max(len(lu_calls), 1),
        lu_calls=len(lu_calls), peak_device_gb=peak_gb,
        residuals=f32.residuals.tolist(), u_gap_vs_float64=u_gap,
        yielded=int(y32.sum()), yielded_f64=int(y64.sum()),
        yield_differ=int(differ.sum()), differ_off_surface=off_surface,
        float64_s=f64_s, float64_converged=f64.converged,
        float64_iterations=int(f64.iterations.sum()), launches=launches)
    require(f32.converged, "20(e): every float32 step converged")
    require(f64.converged, "20(e): every float64 step converged")
    require(0 < int(y64.sum()) < problem.nelm, "20(e): part of the column "
            "yields")
    require(u_gap <= SOLID_PLASTIC_U_RTOL, "20(e): u within "
            f"{SOLID_PLASTIC_U_RTOL} of the float64 tier")
    require(off_surface == 0, "20(e): yielded sets equal but within "
            f"{YIELD_SURFACE_RTOL} of the surface")
    require(zero_launches(launches), "20(e): no repo kernel")
    return launches


def dense_box_problem(traction):
    """The 12 x 12 x 15 column (1 x 1 x 3, E 200, nu 0.3, rho 2) clamped at
    z = 0 with a traction on its top face."""
    from pinn_fem_tpu_torch.io.solid_io import parse_solid_document

    nx, ny, nz = SOLID_DENSE_BOX
    return parse_solid_document({
        "element_type": "solid",
        "mesh": {"type": "box", "lx": 1.0, "ly": 1.0, "lz": 3.0,
                 "nx": nx, "ny": ny, "nz": nz},
        "material": {"young": 200.0, "poisson": 0.3, "density": 2.0},
        "fixed_nodes": "z_min",
        "surface_loads": [{"face": "z_max", "traction": traction}]})[0]


_HARMONIC_SYSTEM = {}


def _harmonic_worker_init(kf, mf, cf, ff, pos):
    _HARMONIC_SYSTEM.update(kf=kf, mf=mf, cf=cf, ff=ff, pos=pos)


def _harmonic_worker(w):
    """|X(w)| at the probe positions by one complex scipy sparse LU (a
    process of 20(f)'s reference pool)."""
    import numpy as np
    import scipy.sparse.linalg as spl

    s = _HARMONIC_SYSTEM
    z = (s["kf"] - w * w * s["mf"] + 1j * w * s["cf"]).tocsc()
    return np.abs(spl.splu(z).solve(s["ff"].astype(complex))[s["pos"]])


def solid_dense(dev, card: str) -> dict:
    """20(f): the dense float64 analyses at the 8,192-DOF budget on the
    card (the clamped 12 x 12 x 15 column, 8,112 DOFs), each against
    scipy.sparse
    float64 on the port's element blocks: modal (eigsh shift-invert;
    eigenvalues, M-normalized sign-aligned shapes, each pair's residual
    by fault 3.24's rule), buckling under a compressive top traction
    (eigsh on (-K_g, K)), 500 Newmark steps (a replay on one splu) and a
    20-frequency harmonic sweep (one complex splu a frequency, in
    SOLID_REF_WORKERS processes); wall and peak memory of each."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    import torch

    from pinn_fem_tpu_torch import (solid_buckling, solid_harmonic,
                                    solid_modal, solid_stable_dt,
                                    solve_solid_transient)
    from pinn_fem_tpu_torch.examples_grid import solid_sparse_matrices
    from pinn_fem_tpu_torch.models import solid as S
    from pinn_fem_tpu_torch.ops import kernels

    problem = dense_box_problem([0.2, -0.1, 1.0])
    free = problem.free_dofs()
    k, m = solid_sparse_matrices(problem, with_mass=True)
    kf = k[free][:, free].tocsc()
    mf = m[free][:, free].tocsc()
    kernels.reset_launch_counts()
    report = {"ndof": problem.ndof, "free": int(free.size)}
    gates = []

    s, gb, modal = peak_run(dev, lambda: solid_modal(
        problem, SOLID_DENSE_MODES, device=dev))
    t0 = time.perf_counter()
    lam, vec = spl.eigsh(kf, k=SOLID_DENSE_MODES, M=mf, sigma=0.0,
                         which="LM")
    order = np.argsort(lam)
    lam, vec = lam[order], vec[:, order]
    vec = vec / np.sqrt(np.einsum("ij,ij->j", vec, mf @ vec))
    ref_s = time.perf_counter() - t0
    phi = modal.mode_shapes[:, free].T
    eig_gap = float(np.abs(modal.eigenvalues - lam).max() / lam.max())
    # Degenerate pairs (the square section's two bending directions) are
    # compared as subspaces: each shape's distance from the reference's
    # span of its cluster.
    shape_gap = 0.0
    for i, lam_i in enumerate(lam):
        cluster = np.flatnonzero(np.abs(lam - lam_i) <= 1e-6 * lam_i)
        basis = vec[:, cluster]
        proj = basis @ (basis.T @ (mf @ phi[:, i]))
        shape_gap = max(shape_gap, float(np.abs(phi[:, i] - proj).max()
                                         / np.abs(phi[:, i]).max()))
    resid = [float(np.linalg.norm(kf @ phi[:, i] - lam_i * (mf @ phi[:, i]))
                   / (lam_i * np.linalg.norm(mf @ phi[:, i])))
             for i, lam_i in enumerate(modal.eigenvalues)]
    lam_max = (2.0 / solid_stable_dt(problem, safety=1.0, device=dev)) ** 2
    floor64 = [2.0 ** -52 * lam_max / lam_i for lam_i in modal.eigenvalues]
    report["modal"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                           eig_gap=eig_gap, shape_gap=shape_gap,
                           residuals=resid, eps64_kappa=floor64,
                           frequencies_hz=modal.frequencies_hz.tolist())
    gates += [(eig_gap <= SOLID_DYN_RTOL, "20(f): modal eigenvalues"),
              (shape_gap <= 1e-7, "20(f): modal shapes"),
              (all(r <= max(PLANE_EIG_RESIDUAL, PLANE_EIG_FLOOR_FACTOR * f)
                   for r, f in zip(resid, floor64)),
               "20(f): modal residuals")]

    comp = dense_box_problem([0.0, 0.0, -1.0])
    s, gb, buck = peak_run(dev, lambda: solid_buckling(
        comp, SOLID_BUCKLING_MODES, device=dev))
    t0 = time.perf_counter()
    u0 = np.zeros(comp.ndof)
    u0[free] = spl.spsolve(kf, comp.loads[free])
    kg_blocks, _ = S._geometric_blocks(comp, torch.as_tensor(u0), "cpu")
    dm = comp.dof_map()
    kg = sp.csr_matrix((kg_blocks.numpy().ravel(),
                        (np.repeat(dm, 24, axis=1).ravel(),
                         np.tile(dm, (1, 24)).ravel())),
                       shape=(comp.ndof, comp.ndof))
    mu = spl.eigsh(-kg[free][:, free].tocsc(), k=SOLID_BUCKLING_MODES + 2,
                   M=kf, which="LA", return_eigenvectors=False)
    lam_ref = np.sort(1.0 / mu[mu > 0])[:SOLID_BUCKLING_MODES]
    ref_s = time.perf_counter() - t0
    buck_gap = float(np.abs(buck.load_factors - lam_ref).max()
                     / lam_ref.max())
    report["buckling"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                              load_factors=buck.load_factors.tolist(),
                              gap=buck_gap)
    gates.append((buck_gap <= SOLID_DYN_RTOL,
                  "20(f): buckling load factors"))

    om1 = float(modal.omegas[0])
    dt = 2.0 * np.pi / om1 / 40.0
    amp = np.sin(0.5 * om1 * dt * np.arange(SOLID_NEWMARK_STEPS))
    damping = (0.02 * om1, 0.02 / om1)
    probe = np.arange(problem.ndof - 9, problem.ndof)
    s, gb, tr = peak_run(dev, lambda: solve_solid_transient(
        problem, dt, SOLID_NEWMARK_STEPS, damping=damping, amplitude=amp,
        probe_dofs=probe, record_every=10, device=dev))
    t0 = time.perf_counter()
    cf = (damping[0] * mf + damping[1] * kf).tocsc()
    a0, a1 = 4.0 / dt ** 2, 2.0 / dt
    lu = spl.splu((kf + a0 * mf + a1 * cf).tocsc())
    ff = problem.loads[free]
    uu, vv = np.zeros(free.size), np.zeros(free.size)
    acc = spl.spsolve(mf, ff * amp[0])
    full, rec = np.zeros(problem.ndof), []
    for step in range(SOLID_NEWMARK_STEPS):
        rhs = ff * amp[min(step + 1, SOLID_NEWMARK_STEPS - 1)] \
            + mf @ (a0 * uu + 2.0 * a1 * vv + acc) + cf @ (a1 * uu + vv)
        un = lu.solve(rhs)
        vn = a1 * (un - uu) - vv
        acc = a0 * (un - uu) - 2.0 * a1 * vv - acc
        uu, vv = un, vn
        if (step + 1) % 10 == 0:
            full[free] = uu
            rec.append(full[probe].copy())
    rec = np.asarray(rec)
    ref_s = time.perf_counter() - t0
    tr_gap = float(np.abs(tr.displacements - rec).max() / np.abs(rec).max())
    report["newmark"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                             steps=SOLID_NEWMARK_STEPS, dt=dt, gap=tr_gap)
    gates.append((tr_gap <= SOLID_DYN_RTOL, "20(f): Newmark probes"))

    om = np.linspace(0.2 * om1, 3.0 * om1, SOLID_HARMONIC_FREQS)
    s, gb, harm = peak_run(dev, lambda: solid_harmonic(
        problem, om, damping=damping, probe_dofs=probe, device=dev))
    t0 = time.perf_counter()
    pos = np.searchsorted(free, probe)
    # One BLAS thread a worker process (the variables are read when a
    # worker starts); the parent's own libraries are loaded already.
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})
    try:
        with ProcessPoolExecutor(
                SOLID_REF_WORKERS, mp_context=multiprocessing.get_context(
                    "spawn"), initializer=_harmonic_worker_init,
                initargs=(kf, mf, cf, ff, pos)) as pool:
            amp_ref = np.asarray(list(pool.map(_harmonic_worker, om)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ref_s = time.perf_counter() - t0
    h_gap = float(np.abs(harm.amplitude - amp_ref).max()
                  / np.abs(amp_ref).max())
    report["harmonic"] = dict(s=s, peak_gb=gb, reference_s=ref_s,
                              frequencies=SOLID_HARMONIC_FREQS, gap=h_gap)
    gates.append((h_gap <= SOLID_DYN_RTOL, "20(f): harmonic amplitudes"))
    launches = kernels.launch_counts()
    report["launches"] = launches
    log("phase20f_dense", card=card, **report)
    for ok, what in gates:
        require(ok, what)
    require(zero_launches(launches), "20(f): no repo kernel")
    return launches


def solid_refusals(dev, card: str) -> None:
    """20(g): mesh= (banded statics, banded modal, plastic transient),
    a "reliability" block without variables (ported in phase 25), an
    identification block without a measurement, "sizing" (no solid
    analysis of that name), the 8,192-DOF budgets of the dense analyses,
    a prescribed displacement on the banded tier and "plasticity" with
    "banded", each refused before any launch."""
    from pinn_fem_tpu_torch import solve_solid_transient_plastic
    from pinn_fem_tpu_torch.io.solid_io import (run_solid_analysis,
                                                run_solid_document)
    from pinn_fem_tpu_torch.models import solid as S
    from pinn_fem_tpu_torch.ops import kernels

    big, _ = solid_column(12, 12, 16)          # 8,619 DOFs
    small, doc = solid_column(2, 2, 6)
    settled = dict(doc, prescribed=[[2, 0.01]],
                   analysis={"type": "static", "banded": True})
    calls = {
        "mesh_static": (lambda: S.solve_solid_static_banded(
            big, mesh=object(), device=dev), NotImplementedError, "item 15"),
        "mesh_modal": (lambda: S.solid_modal_banded(
            big, mesh=object(), device=dev), NotImplementedError, "item 15"),
        "mesh_plastic_transient": (lambda: solve_solid_transient_plastic(
            small, sigma_y=1.0, n_steps=4, mesh=object(), device=dev),
            NotImplementedError, "item 15"),
        "banded_prescribed": (lambda: run_solid_document(settled, dev),
                              ValueError, "homogeneous supports only"),
        "plasticity_banded": (lambda: run_solid_analysis(
            small, {"type": "transient", "n_steps": 4, "banded": True,
                    "plasticity": {"sigma_y": 1.0}}, dev), ValueError,
            'drop "banded"'),
        "sizing": (lambda: run_solid_analysis(small, {"type": "sizing"},
                                              dev), ValueError,
                   "analysis.type must be"),
    }
    for kind in ("buckling", "harmonic", "plastic", "reduction", "random",
                 "reliability"):
        calls[f"budget_{kind}"] = (lambda kind=kind: run_solid_analysis(
            big, {"type": kind, "omegas": [1.0], "sigma_y": 1.0}, dev),
            ValueError, "8192-DOF budget")
    calls["reliability"] = (lambda: run_solid_analysis(
        small, {"type": "reliability"}, dev), ValueError,
        "needs at least one random")
    calls["identification"] = (lambda: run_solid_analysis(
        small, {"type": "identification"}, dev), ValueError,
        'needs "measured_dofs"')
    refused = {}
    kernels.reset_launch_counts()
    for name, (call, kind, text) in calls.items():
        try:
            call()
            refused[name] = None
        except kind as e:
            refused[name] = str(e)
            require(text in str(e), f"20(g) {name}: the message names "
                    f"{text}")
    launches = kernels.launch_counts()
    log("phase20g_refusals", card=card, refused=refused, launches=launches)
    for name, msg in refused.items():
        require(msg is not None, f"20(g): {name} refused")
    require(zero_launches(launches), "20(g): no launch before refusal")


def phase_solid(workdir: Path, dev, card: str) -> dict:
    """Phase 20: the 3D solid family and the continuum plastic transients
    on the card.  Returns the kernels' launches on each of its paths and
    the kernels' figures on the column's operator."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches = solid_documents(workdir, dev, card)
    lap("a")
    column_launches, column_stats, column = solid_column_statics(
        workdir, dev, card)
    launches.update(column_launches)
    lap("b")
    launches["modal_84k"] = solid_column_modal(column, dev, card)
    lap("c")
    launches.update(solid_column_central(column, dev, card))
    lap("d")
    del column
    launches.update(solid_plastic_transient(dev, card))
    launches["plastic_statics_7k"] = solid_plastic_statics(dev, card)
    lap("e")
    launches["dense_8k"] = solid_dense(dev, card)
    lap("f")
    solid_refusals(dev, card)
    lap("g")
    log("phase20_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches, "column": column_stats}


FRAME_DOCS = ("dyn-frame", "dyn-frame-thermal", "dyn-frame-pushover",
              "dyn-frame3d")                   # 21(a)
FRAME_DOC_RTOL = 1e-10          # card against the port's CPU run, float64
FRAME_TOWER = (50, 260)         # 21(b): 39,933 DOFs, 26,050 members
FRAME3D_GRID = (50, 4, 32)      # 21(c): 39,168 DOFs, 17,400 members
FRAME_TOL = 1e-7                # benchmarks/scaling.py's tolerance
FRAME_RESIDUAL = 1e-6
FRAME_EQUILIBRIUM = 1e-2        # benchmarks/scaling.py:451-453's gate
FRAME_U_RTOL = 1e-3             # against float64 of the same diagonals
FRAME_WARM_RUNS = 3
FRAME_SPREAD_TOWER = (12, 60)   # 21(b) fault 3.28: 2,379 DOFs
FRAME_SPREAD_TOL = 1e-6
FRAME_MODAL_TOWER = (20, 100)   # 21(d): 6,363 DOFs
FRAME_MODAL_GRID = (20, 4, 8)   # 4,032 DOFs
FRAME_MODES = 4                 # the JAX benchmark rows' settings
FRAME_MODAL_ITERS = 20
FRAME_MODAL_CG_TOL = 1e-7
FRAME_MODAL_RTOL = 1e-2         # pinn_fem_tpu/solvers/modal.py:29-31
FRAME_DENSE_TOWER = (20, 30)    # 21(e): 1,953 DOFs, under the dense limit
FRAME_DENSE_GRID = (10, 3, 10)  # 1,980 DOFs
FRAME_DENSE_MODES = 6
FRAME_BUCKLING_MODES = 2
FRAME_NEWMARK_STEPS = 500
FRAME_HARMONIC_FREQS = 20
FRAME_DYN_RTOL = 1e-9
FRAME_GRAVITY = 1e4             # 21(e)'s buckling pattern at story nodes
FRAME_PUSHOVER = (2, 4)         # 21(e): a 2-story, 4-bay portal
FRAME_PUSHOVER_MP = (3e4, 1e4)  # columns', beams' plastic moment


def frame_problem(kind: str, *size, **analysis):
    """(problem, document) of the JAX package's frame benchmark meshes:
    "tower" (stories, bays) or "grid" (stories, gx, gy)."""
    from pinn_fem_tpu_torch import examples_grid as g
    from pinn_fem_tpu_torch.io.frame3d_io import parse_frame3d_document
    from pinn_fem_tpu_torch.io.frame_io import parse_frame_document

    if kind == "tower":
        doc = g.frame_tower_document(*size, **analysis)
        return parse_frame_document(doc)[0], doc
    doc = g.space_frame_grid_document(*size, **analysis)
    return parse_frame3d_document(doc)[0], doc


def frame_family(kind: str):
    """(model module, banded statics, banded modal, layout, operator,
    dense statics, DOFs a node) of a frame family."""
    from pinn_fem_tpu_torch.models import frame as F
    from pinn_fem_tpu_torch.models import frame3d as F3

    if kind == "tower":
        return (F, F.solve_frame_static_banded, F.frame_modal_banded,
                F._frame_dia_layout, F._banded_operator,
                F.solve_frame_static, 3)
    return (F3, F3.solve_space_frame_static_banded,
            F3.space_frame_modal_banded, F3._frame3d_dia_layout,
            F3._banded_operator3, F3.solve_space_frame_static, 6)


def frame_documents(workdir: Path, dev, card: str) -> dict:
    """21(a): the four corpus frame documents through main() on the card,
    each against the port's own run of the same document on the CPU at
    FRAME_DOC_RTOL (dyn-frame's mode shapes sign-aligned); no repo kernel
    runs; dyn-frame-identify without its "synthetic" block exits 1 in the
    JAX package's words before any launch (the document itself: 24(d))."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.frame3d_io import run_frame3d_document
    from pinn_fem_tpu_torch.io.frame_io import run_frame_document
    from pinn_fem_tpu_torch.ops import kernels

    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    launches, gaps = {}, {}
    for name in FRAME_DOCS + ("dyn-frame-identify",):
        doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                         .read_text())
        if name == "dyn-frame-identify":
            doc["analysis"].pop("synthetic")
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(doc))
        kernels.reset_launch_counts()
        card_s, rc = synced(lambda: main([str(path)]))
        launches[name] = kernels.launch_counts()
        require(zero_launches(launches[name]), f"21(a) {name}: no repo "
                "kernel")
        if name == "dyn-frame-identify":
            log_text = (workdir / f"{name}.log").read_text()
            require(rc == 1 and 'needs "measured_dofs"' in log_text
                    and not (workdir / f"{name}.res.json").exists(),
                    "21(a) dyn-frame-identify without synthetic data: "
                    "exit 1")
            continue
        require(rc == 0, f"21(a) {name}: exit code 0")
        got = json.loads((workdir / f"{name}.res.json").read_text())
        run = (run_frame3d_document if doc["element_type"] == "frame3d"
               else run_frame_document)
        want = json.loads(json.dumps(run(doc, "cpu")))
        if "mode_shapes" in want:
            g, w = np.asarray(got["mode_shapes"]), np.asarray(
                want["mode_shapes"])
            s = np.sign(np.sum(g * w, axis=1))
            require(bool(np.all(s != 0)), f"21(a) {name}: mode signs")
            got["mode_shapes"] = (g * s[:, None]).tolist()
        doc_gaps = tree_gaps(got, want)
        gaps[name] = {"max": max(doc_gaps.values()),
                      "worst": max(doc_gaps, key=doc_gaps.get), "s": card_s}
        require(got["success"], f"21(a) {name}: success")
        require(gaps[name]["max"] <= FRAME_DOC_RTOL,
                f"21(a) {name}: within {FRAME_DOC_RTOL} of the CPU run")
    log("phase21a_documents", card=card, gaps=gaps, launches=launches)
    return launches


def frame_banded_statics(workdir: Path, dev, card: str, kind: str,
                         item: str, size, shear_dof: int):
    """21(b) / 21(c): one of the JAX package's banded frame benchmarks at
    full width (tol 1e-7) through its banded statics and as a document
    through main(): the relative residual below 1e-6, the base shear
    (reactions[shear_dof::dpn]) against the applied load within 1e-2, u
    within 1e-3 of a float64 scipy solve of the same float32 diagonals
    (and, beside it, the float32 floor against the float64 operator, as
    fault 3.23), the launches (kernel 1: 1, kernels 2 and 3: 32 ceil(it /
    32)), the PCG iterations and ms an iteration, the layout build, warm
    wall (median of 3), the idle share; kernels 1-3 on the operator
    (`operator_kernels`)."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.examples_grid import frame_sparse_matrices
    from pinn_fem_tpu_torch.ops import dia, kernels

    _, solve, _, layout_of, operator, _, dpn = frame_family(kind)
    problem, doc = frame_problem(kind, *size)
    t0 = time.perf_counter()
    layout = layout_of(problem)
    layout_s = time.perf_counter() - t0
    _, diags, mask = operator(problem, torch.float32, dev)
    label = "frame_tower" if kind == "tower" else "frame3d_grid"
    stats = operator_kernels(layout, diags, mask, dev, card, item,
                             f"the {kind}", f"phase21{item[3]}_kernels",
                             21)
    kernels.reset_launch_counts()
    with Timed(dia, "dia_cg_solve") as pcg_calls:
        cold_s, (res, iters, rel) = synced(
            lambda: solve(problem, tol=FRAME_TOL, device=dev))
    launches = {f"{label}_api": kernels.launch_counts()}
    pcg_s = pcg_calls[0][0]
    warm = [synced(lambda: solve(problem, tol=FRAME_TOL, device=dev))[0]
            for _ in range(FRAME_WARM_RUNS)]
    f = torch.as_tensor(problem.loads, dtype=torch.float32, device=dev)
    prof = pcg_profile(layout, diags, f, mask)
    idle = idle_profile(lambda: solve(problem, tol=FRAME_TOL, device=dev))
    free = problem.free_dofs()
    t0 = time.perf_counter()
    u_same = float64_sparse_solve(dia_csr64(layout, diags), problem.loads,
                                  free)
    ref_s = time.perf_counter() - t0
    u64 = float64_sparse_solve(frame_sparse_matrices(problem)[0],
                               problem.loads, free)
    u = res.displacements
    scale = np.abs(u64).max()
    u_gap = float(np.abs(u - u_same).max() / scale)
    u_gap64 = float(np.abs(u - u64).max() / scale)
    floor32 = float(np.abs(u_same - u64).max() / scale)
    shear = -float(res.reactions[shear_dof::dpn].sum())
    applied = float(problem.loads[shear_dof::dpn].sum())
    eq_err = abs(shear - applied) / abs(applied)
    rounds = 32 * -(-iters // 32)
    expected = {"dia_matvec": 1, "dia_dir_matvec": rounds,
                "cg_update": rounds, "material_coefficients": 0,
                "material_coefficients_backward": 0}

    path = workdir / f"{label}.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    kernels.reset_launch_counts()
    cli_s, rc = synced(lambda: main([str(path)]))
    launches[f"{label}_cli"] = kernels.launch_counts()
    require(rc == 0, f"{item}: the {kind} document's exit code 0")
    out = json.loads((workdir / f"{label}.res.json").read_text())
    probe = np.asarray(out["probe_dofs"])
    cli_gap = float(np.abs(np.asarray(out["displacements"])
                           - u_same[probe]).max() / scale)
    cli_rounds = 32 * -(-out["iterations"] // 32)
    log(f"phase21{item[3]}_{kind}", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth, iterations=iters,
        relative_residual=rel, equilibrium_err=eq_err,
        u_gap_vs_same_system=u_gap, u_gap_vs_float64=u_gap64,
        float32_representation_floor=floor32, cold_s=cold_s, warm_s=warm,
        warm_median_s=float(np.median(warm)), pcg_s=pcg_s,
        pcg_ms_per_iteration=1e3 * pcg_s / max(iters, 1),
        profile=prof, solve_idle=idle, layout_build_s=layout_s,
        float64_reference_s=ref_s, launches=launches, expected=expected,
        cli_s=cli_s, cli_iterations=out["iterations"],
        cli_relative_residual=out["relative_residual"],
        cli_probe_gap_vs_same_system=cli_gap, cli_tier=out["tier"])
    require(rel < FRAME_RESIDUAL, f"{item}: relative residual < 1e-6")
    require(eq_err < FRAME_EQUILIBRIUM, f"{item}: base shear within "
            f"{FRAME_EQUILIBRIUM} of the applied load")
    require(u_gap <= FRAME_U_RTOL, f"{item}: u within {FRAME_U_RTOL} of "
            "the float64 solve of the same diagonals")
    require(launches[f"{label}_api"] == expected,
            f"{item}: the launches of the formula")
    require(out["tier"] == "banded"
            and out["relative_residual"] < FRAME_RESIDUAL,
            f"{item}: the document's banded tier")
    require(cli_gap <= FRAME_U_RTOL, f"{item}: the document's probes "
            f"within {FRAME_U_RTOL} of the float64 solve of the same "
            "diagonals")
    require(launches[f"{label}_cli"] == dict(
        expected, dia_dir_matvec=cli_rounds, cg_update=cli_rounds),
        f"{item}: the document's launches of the formula")
    return launches, stats


def frame_count_spread(dev, card: str) -> dict:
    """21(b), fault 3.28: the banded statics of tower(12, 60) at tol 1e-6
    on the card under the document's load and the load scaled by
    1 + 2^-23 in float32 (one step of its last bit).  Each u within 1e-3
    of the dense float64 solve of the same load and the launches of the
    formula; the two Jacobi counts recorded beside the float64
    recurrence's (the plain loop on the CPU)."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.models import frame as F
    from pinn_fem_tpu_torch.ops import dia, kernels

    problem, _ = frame_problem("tower", *FRAME_SPREAD_TOWER)
    layout, diags, mask = F._banded_operator(problem, torch.float32, dev)
    u64 = F.solve_frame_static(problem, device=dev).displacements
    scale = np.abs(u64).max()
    counts, gaps, launches = [], [], {}
    for k, factor in enumerate((1.0, 1.0 + 2.0 ** -23)):
        f = torch.as_tensor(problem.loads, dtype=torch.float32,
                            device=dev) * torch.tensor(
                                factor, dtype=torch.float32, device=dev)
        kernels.reset_launch_counts()
        x, iters, _ = dia.dia_cg_solve(layout, diags, f, mask,
                                       tol=FRAME_SPREAD_TOL, max_iter=20000)
        iters = int(iters)
        launches[f"tower_12x60_load{k}"] = kernels.launch_counts()
        rounds = 32 * -(-iters // 32)
        require(launches[f"tower_12x60_load{k}"] == {
            "dia_matvec": 0, "dia_dir_matvec": rounds, "cg_update": rounds,
            "material_coefficients": 0,
            "material_coefficients_backward": 0},
            f"21(b) fault 3.28: load {k}'s launches of the formula")
        counts.append(iters)
        gaps.append(float(np.abs(x.double().cpu().numpy() - factor * u64
                                 ).max() / scale))
        require(gaps[-1] <= FRAME_U_RTOL, f"21(b) fault 3.28: load {k}'s u "
                f"within {FRAME_U_RTOL} of the dense float64 solve")
    f64 = dia.dia_cg_solve_reference(
        layout, diags.double().cpu(),
        torch.as_tensor(problem.loads, dtype=torch.float64),
        mask.double().cpu(), tol=FRAME_SPREAD_TOL, max_iter=20000)[1]
    log("phase21b_count_spread", card=card, ndof=problem.ndof,
        tol=FRAME_SPREAD_TOL, load_factors=[1.0, 1.0 + 2.0 ** -23],
        float32_iterations=counts, float64_iterations=int(f64),
        u_gap_vs_float64=gaps, launches=launches)
    return launches


def frame_banded_modal(dev, card: str) -> dict:
    """21(d): frame_modal_banded of tower(20, 100) and
    space_frame_modal_banded of grid3d(20, 4, 8) (4 modes, n_iter 20,
    cg_tol 1e-7: the JAX rows' settings) against scipy's eigsh on the same
    float64 lumped pencil (shift-invert on one splu of K_ff): eigenvalues
    within 1e-2, kernel 1 n_iter k launches (the warm starts), kernels 2
    and 3 the block solves' whole rounds of 32; the wall and the PCG
    iterations."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    from pinn_fem_tpu_torch.examples_grid import frame_sparse_matrices
    from pinn_fem_tpu_torch.ops import dia, kernels

    launches, report = {}, {}
    for kind, size in (("tower", FRAME_MODAL_TOWER),
                       ("grid", FRAME_MODAL_GRID)):
        model, _, modal, _, _, _, _ = frame_family(kind)
        problem, _ = frame_problem(kind, *size)
        with Spy(dia, "dia_cg_solve") as solves:
            kernels.reset_launch_counts()
            wall, res = synced(lambda: modal(
                problem, n_modes=FRAME_MODES, n_iter=FRAME_MODAL_ITERS,
                cg_tol=FRAME_MODAL_CG_TOL, device=dev))
            name = f"modal_{kind}_{problem.ndof}"
            launches[name] = kernels.launch_counts()
        stats = dict(solve_stats(solves), rounds=pcg_rounds(solves))
        del solves[:]
        t0 = time.perf_counter()
        free = problem.free_dofs()
        md = (model.frame_lumped_mass_diag if kind == "tower"
              else model.space_frame_lumped_mass_diag)(problem, "cpu")
        k_ff = frame_sparse_matrices(problem)[0][free][:, free].tocsc()
        lu = spl.splu(k_ff)
        op = spl.LinearOperator(k_ff.shape, matvec=lu.solve, dtype=float)
        w64 = np.sort(spl.eigsh(k_ff, k=FRAME_MODES, M=sp.diags(md[free]),
                                sigma=0.0, which="LM", OPinv=op, tol=1e-10,
                                return_eigenvectors=False))
        ref_s = time.perf_counter() - t0
        gap = np.abs(res.eigenvalues / w64 - 1.0)
        k = min(2 * FRAME_MODES + 4, free.size)
        expected = {"dia_matvec": FRAME_MODAL_ITERS * k,
                    "dia_dir_matvec": stats["rounds"],
                    "cg_update": stats["rounds"],
                    "material_coefficients": 0,
                    "material_coefficients_backward": 0}
        report[name] = dict(ndof=problem.ndof, wall_s=wall,
                            ms_per_pcg_iteration=1e3 * wall
                            / max(stats["pcg_iterations"], 1), **stats,
                            eigenvalues=res.eigenvalues.tolist(),
                            float64=w64.tolist(), rel_gap=gap.tolist(),
                            float64_reference_s=ref_s, expected=expected)
        require(launches[name] == expected, f"21(d) {name}: kernel 1 "
                "launched n_iter k times, kernels 2-3 as the block solves "
                "count")
        require(float(gap.max()) <= FRAME_MODAL_RTOL,
                f"21(d) {name}: eigenvalues within {FRAME_MODAL_RTOL} of "
                "float64 eigsh")
        require(res.mode_shapes.shape == (FRAME_MODES, problem.ndof)
                and bool(np.all(np.isfinite(res.mode_shapes))),
                f"21(d) {name}: finite shapes of the expected shape")
    log("phase21d_modal", card=card, n_modes=FRAME_MODES,
        n_iter=FRAME_MODAL_ITERS, cg_tol=FRAME_MODAL_CG_TOL, report=report,
        launches=launches)
    return launches


def frame_sparse_geometric(problem, u):
    """K_g(N(u)) of a frame problem as a float64 scipy CSR matrix, from the
    port's element blocks on the CPU (the member axial forces of u)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from pinn_fem_tpu_torch.models import frame as F
    from pinn_fem_tpu_torch.models import frame3d as F3

    u = torch.as_tensor(u, dtype=torch.float64)
    if isinstance(problem, F3.SpaceFrameProblem):
        axial = -(F3._end_forces3(problem, u)
                  - F3._static_loads3(problem, "cpu")[1])[:, 0]
        length, r = F3._geometry3d(problem)
        blocks = F._to_global(F3._transformation3d(r),
                              F3._kg_local3d(axial, length))
    else:
        axial = -F._end_forces(problem, u,
                               F._static_loads(problem, "cpu")[1])[:, 0]
        length, c, s = F._geometry(problem)
        blocks = F._to_global(F._rotation(c, s), F._kg_local(axial, length))
    dm = problem.dof_map()
    w = dm.shape[1]
    return sp.csr_matrix((blocks.numpy().ravel(),
                          (np.repeat(dm, w, axis=1).ravel(),
                           np.tile(dm, (1, w)).ravel())),
                         shape=(problem.ndof, problem.ndof))


def mode_gaps(lam_got, phi_got, lam, vec, kf, mf, lam_max):
    """(eigenvalue gap, shape gap by subspace, residuals, their fault 3.24
    floors) of dense modes (phi_got: free-block columns) against eigsh's
    (vec M-normalized)."""
    import numpy as np

    eig_gap = float(np.abs(lam_got - lam).max() / np.abs(lam).max())
    shape_gap = 0.0
    for i, lam_i in enumerate(lam):
        cluster = np.flatnonzero(np.abs(lam - lam_i) <= 1e-6 * abs(lam_i))
        basis = vec[:, cluster]
        proj = basis @ (basis.T @ (mf @ phi_got[:, i]))
        shape_gap = max(shape_gap, float(np.abs(phi_got[:, i] - proj).max()
                                         / np.abs(phi_got[:, i]).max()))
    resid = [float(np.linalg.norm(kf @ phi_got[:, i]
                                  - lam_i * (mf @ phi_got[:, i]))
                   / (lam_i * np.linalg.norm(mf @ phi_got[:, i])))
             for i, lam_i in enumerate(lam_got)]
    floor64 = [2.0 ** -52 * lam_max / lam_i for lam_i in lam_got]
    return eig_gap, shape_gap, resid, floor64


def pushover_reference(problem, mp, rtol: float = 1e-9):
    """The event-to-event EPP hinge pushover in float64 numpy (dense): the
    condensed member tangents, the floating-DOF and mechanism rules
    (eigvalsh of K_ff, smallest at most 1e-10 of the largest), the step to
    the first end at +-Mp, simultaneous ends within rtol.  Returns
    (collapse factor, [(member, end)], load factors, u)."""
    import numpy as np

    from pinn_fem_tpu_torch.models import frame as F

    kl, t = (x.numpy() for x in F._local_stiffness(problem, "cpu"))
    dm = problem.dof_map()
    n = problem.ndof
    base = problem.free_mask()
    f = problem.loads
    hinges = np.zeros((problem.nelm, 2), dtype=bool)
    lam, u = 0.0, np.zeros(n)
    m_end = np.zeros((problem.nelm, 2))
    lams, seq = [0.0], []
    for _ in range(2 * problem.nelm + 1):
        kc = kl.copy()
        for e in np.flatnonzero(hinges.any(axis=1)):
            rel = [r for b, r in enumerate((2, 5)) if hinges[e, b]]
            keep = [i for i in range(6) if i not in rel]
            blk = np.zeros((6, 6))
            blk[np.ix_(keep, keep)] = kl[e][np.ix_(keep, keep)] - kl[e][
                np.ix_(keep, rel)] @ np.linalg.solve(
                    kl[e][np.ix_(rel, rel)], kl[e][np.ix_(rel, keep)])
            kc[e] = blk
        k = np.zeros((n, n))
        np.add.at(k, (dm[:, :, None], dm[:, None, :]),
                  np.einsum("mji,mjk,mkl->mil", t, kc, t))
        diag = np.diag(k)
        floating = (base > 0) & (diag <= 1e-12 * diag.max())
        mask = base * ~floating
        free = np.flatnonzero(mask > 0)
        if np.any(floating & (f != 0)) or free.size == 0:
            break
        w = np.linalg.eigvalsh(k[np.ix_(free, free)])
        if w[0] <= 1e-10 * max(w[-1], 1e-300):
            break
        du = np.zeros(n)
        du[free] = np.linalg.solve(k[np.ix_(free, free)], f[free])
        dm_end = np.einsum("mij,mj->mi", kc,
                           np.einsum("mij,mj->mi", t, du[dm]))[:, [2, 5]]
        with np.errstate(divide="ignore", invalid="ignore"):
            room = np.where(dm_end > 0.0, (mp[:, None] - m_end) / dm_end,
                            (-mp[:, None] - m_end) / dm_end)
        room[~np.isfinite(room) | (np.abs(dm_end) <= 1e-14 * mp[:, None])
             | hinges] = np.inf
        d_lam = float(room.min())
        lam += d_lam
        u = u + d_lam * du
        m_end = m_end + d_lam * dm_end
        lams.append(lam)
        new = (room <= d_lam * (1.0 + rtol)) & ~hinges
        seq += [tuple(int(v) for v in me) for me in np.argwhere(new)]
        hinges |= new
    return lam, seq, np.asarray(lams), u


def frame_dense_one(problem, label: str, dev, prestress: bool) -> tuple:
    """21(e) on one mesh: the dense float64 analyses on the card against
    scipy.sparse float64 on the port's element blocks: statics (spsolve),
    modal (eigsh shift-invert; with the prestress of the static state on
    the tower), buckling under gravity at the story nodes (eigsh on
    (-K_g, K)), 500 Newmark steps (a replay on one splu) and a
    20-frequency harmonic sweep (one complex splu a frequency).  Returns
    (report, gates)."""
    import dataclasses

    import numpy as np
    import scipy.sparse.linalg as spl

    from pinn_fem_tpu_torch import examples_grid as g
    from pinn_fem_tpu_torch.models import frame as F
    from pinn_fem_tpu_torch.models import frame3d as F3

    tower = isinstance(problem, F.FrameProblem)
    statics = F.solve_frame_static if tower else F3.solve_space_frame_static
    dpn = 3 if tower else 6
    free = problem.free_dofs()
    k, m = g.frame_sparse_matrices(problem, with_mass=True)
    kf = k[free][:, free].tocsc()
    mf = m[free][:, free].tocsc()
    report, gates = {"ndof": problem.ndof, "free": int(free.size)}, []

    s, gb, stat = peak_run(dev, lambda: statics(problem, device=dev))
    t0 = time.perf_counter()
    u0 = float64_sparse_solve(k, problem.loads, free)
    st_gap = float(np.abs(stat.displacements - u0).max()
                   / np.abs(u0).max())
    report["static"] = dict(s=s, peak_gb=gb, gap=st_gap,
                            reference_s=time.perf_counter() - t0)
    gates.append((st_gap <= FRAME_DYN_RTOL, f"21(e) {label}: statics"))

    if tower:
        run = lambda: F.frame_modal(problem, FRAME_DENSE_MODES,  # noqa
                                    prestress_u=u0, device=dev)
        kp = (k + frame_sparse_geometric(problem, u0))[free][:, free].tocsc()
    else:
        run = lambda: F3.space_frame_modal(problem,  # noqa: E731
                                           FRAME_DENSE_MODES, device=dev)
        kp = kf
    s, gb, modal = peak_run(dev, run)
    t0 = time.perf_counter()
    lam, vec = spl.eigsh(kp, k=FRAME_DENSE_MODES, M=mf, sigma=0.0,
                         which="LM")
    order = np.argsort(lam)
    lam, vec = lam[order], vec[:, order]
    vec = vec / np.sqrt(np.einsum("ij,ij->j", vec, mf @ vec))
    lam_max = float(spl.eigsh(kp, k=1, M=mf, which="LA",
                              return_eigenvectors=False)[0])
    eig_gap, shape_gap, resid, floor64 = mode_gaps(
        modal.eigenvalues, modal.mode_shapes[:, free].T, lam, vec, kp, mf,
        lam_max)
    report["modal"] = dict(s=s, peak_gb=gb, prestressed=tower,
                           reference_s=time.perf_counter() - t0,
                           eig_gap=eig_gap, shape_gap=shape_gap,
                           residuals=resid, eps64_kappa=floor64,
                           frequencies_hz=modal.frequencies_hz.tolist())
    gates += [(eig_gap <= FRAME_DYN_RTOL, f"21(e) {label}: modal "
               "eigenvalues"),
              (shape_gap <= FRAME_DYN_RTOL, f"21(e) {label}: modal shapes"),
              (all(r <= max(PLANE_EIG_RESIDUAL, PLANE_EIG_FLOOR_FACTOR * f)
                   for r, f in zip(resid, floor64)),
               f"21(e) {label}: modal residuals")]

    comp = dataclasses.replace(problem, loads=problem.loads.copy())
    vertical = 1 if tower else 2
    comp.loads[vertical::dpn] -= FRAME_GRAVITY * (
        problem.nodes[:, vertical] > 0)
    buckling = F.frame_buckling if tower else F3.space_frame_buckling
    s, gb, buck = peak_run(dev, lambda: buckling(
        comp, FRAME_BUCKLING_MODES, device=dev))
    t0 = time.perf_counter()
    uc = float64_sparse_solve(k, comp.loads, free)
    kg = frame_sparse_geometric(comp, uc)[free][:, free].tocsc()
    mu = spl.eigsh(-kg, k=FRAME_BUCKLING_MODES + 2, M=kf, which="LA",
                   return_eigenvectors=False)
    lam_ref = np.sort(1.0 / mu[mu > 0])[:FRAME_BUCKLING_MODES]
    buck_gap = float(np.abs(buck.load_factors - lam_ref).max()
                     / lam_ref.max())
    report["buckling"] = dict(s=s, peak_gb=gb, gap=buck_gap,
                              reference_s=time.perf_counter() - t0,
                              load_factors=buck.load_factors.tolist())
    gates.append((buck_gap <= FRAME_DYN_RTOL,
                  f"21(e) {label}: buckling load factors"))

    om1 = float(modal.omegas[0])
    dt = 2.0 * np.pi / om1 / 40.0
    amp = np.sin(0.5 * om1 * dt * np.arange(FRAME_NEWMARK_STEPS))
    damping = (0.02 * om1, 0.02 / om1)
    probe = np.arange(problem.ndof - dpn, problem.ndof)
    transient = (F.solve_frame_transient if tower
                 else F3.solve_space_frame_transient)
    s, gb, tr = peak_run(dev, lambda: transient(
        problem, dt, FRAME_NEWMARK_STEPS, damping=damping, amplitude=amp,
        probe_dofs=probe, record_every=10, device=dev))
    t0 = time.perf_counter()
    cf = (damping[0] * mf + damping[1] * kf).tocsc()
    a0, a1 = 4.0 / dt ** 2, 2.0 / dt
    lu = spl.splu((kf + a0 * mf + a1 * cf).tocsc())
    ff = problem.loads[free]
    uu, vv = np.zeros(free.size), np.zeros(free.size)
    acc = spl.spsolve(mf, ff * amp[0])
    full, rec = np.zeros(problem.ndof), []
    for step in range(FRAME_NEWMARK_STEPS):
        rhs = ff * amp[min(step + 1, FRAME_NEWMARK_STEPS - 1)] \
            + mf @ (a0 * uu + 2.0 * a1 * vv + acc) + cf @ (a1 * uu + vv)
        un = lu.solve(rhs)
        vv, acc = a1 * (un - uu) - vv, a0 * (un - uu) - 2.0 * a1 * vv - acc
        uu = un
        if step % 10 == 0:
            full[free] = uu
            rec.append(full[probe].copy())
    rec = np.asarray(rec)
    tr_gap = float(np.abs(tr.displacements - rec).max() / np.abs(rec).max())
    report["newmark"] = dict(s=s, peak_gb=gb, gap=tr_gap, dt=dt,
                             steps=FRAME_NEWMARK_STEPS,
                             reference_s=time.perf_counter() - t0)
    gates.append((tr_gap <= FRAME_DYN_RTOL, f"21(e) {label}: Newmark "
                  "probes"))

    om = np.linspace(0.2 * om1, 3.0 * om1, FRAME_HARMONIC_FREQS)
    harmonic = F.frame_harmonic if tower else F3.space_frame_harmonic
    s, gb, harm = peak_run(dev, lambda: harmonic(
        problem, om, damping=damping, probe_dofs=probe, device=dev))
    t0 = time.perf_counter()
    pos = np.searchsorted(free, probe)
    amp_ref = np.asarray([np.abs(spl.splu(
        (kf - wi * wi * mf + 1j * wi * cf).tocsc()).solve(
            ff.astype(complex))[pos]) for wi in om])
    h_gap = float(np.abs(harm.amplitude - amp_ref).max()
                  / np.abs(amp_ref).max())
    report["harmonic"] = dict(s=s, peak_gb=gb, gap=h_gap,
                              frequencies=FRAME_HARMONIC_FREQS,
                              reference_s=time.perf_counter() - t0)
    gates.append((h_gap <= FRAME_DYN_RTOL, f"21(e) {label}: harmonic "
                  "amplitudes"))
    return report, gates


def frame_dense(dev, card: str) -> dict:
    """21(e): the dense float64 analyses on the card just under
    DENSE_DOF_LIMIT, tower(20, 30) (1,953 DOFs) and grid3d(10, 3, 10)
    (1,980 DOFs), within 1e-9 of scipy float64 (`frame_dense_one`; mode
    residuals by fault 3.24's rule, shapes by subspace), and the
    plastic-hinge pushover of a 2-story, 4-bay portal under wind and
    gravity against the float64 numpy event loop (`pushover_reference`):
    the collapse factor and the load factors within 1e-9, the hinge
    sequence equal; wall and peak memory of each; no repo kernel."""
    import numpy as np

    from pinn_fem_tpu_torch import frame_pushover
    from pinn_fem_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    report, gates = {}, []
    for kind, size in (("tower", FRAME_DENSE_TOWER),
                       ("grid", FRAME_DENSE_GRID)):
        problem, _ = frame_problem(kind, *size)
        one, one_gates = frame_dense_one(problem, kind, dev,
                                         kind == "tower")
        report[f"{kind}_{problem.ndof}"] = one
        gates += one_gates
    portal, _ = frame_problem("tower", *FRAME_PUSHOVER)
    portal.loads[1::3] -= 2000.0 * (portal.nodes[:, 1] > 0)
    columns = FRAME_PUSHOVER[0] * (FRAME_PUSHOVER[1] + 1)
    mp = np.where(np.arange(portal.nelm) < columns, *FRAME_PUSHOVER_MP)
    s, gb, push = peak_run(dev, lambda: frame_pushover(portal, mp,
                                                       device=dev))
    t0 = time.perf_counter()
    lam, seq, lams, u = pushover_reference(portal, mp)
    got_seq = list(zip(push.hinge_members.tolist(),
                       push.hinge_ends.tolist()))
    p_gap = abs(push.collapse_factor - lam) / lam
    report["pushover"] = dict(s=s, peak_gb=gb, members=portal.nelm,
                              collapse_factor=push.collapse_factor,
                              reference=lam, gap=p_gap, hinges=len(seq),
                              reference_s=time.perf_counter() - t0)
    gates += [(push.mechanism and p_gap <= FRAME_DYN_RTOL,
               "21(e) pushover: the collapse factor"),
              (got_seq == seq, "21(e) pushover: the hinge sequence"),
              (lams.shape == push.load_factors.shape and float(np.abs(
                  push.load_factors - lams).max()) <= FRAME_DYN_RTOL * lam,
               "21(e) pushover: the load factors"),
              (float(np.abs(push.u - u).max()) <= FRAME_DYN_RTOL
               * float(np.abs(u).max()), "21(e) pushover: u")]
    launches = kernels.launch_counts()
    report["launches"] = launches
    log("phase21e_dense", card=card, **report)
    for ok, what in gates:
        require(ok, what)
    require(zero_launches(launches), "21(e): no repo kernel")
    return launches


def frame_refusals(workdir: Path, dev, card: str) -> None:
    """21(f): mesh= (the banded statics and modal of both families), bare
    "reliability" and "sizing" blocks (ported in phase 25) and an
    identification block without a measurement, each refused before any
    launch in the JAX package's words (the family documents: 22(e))."""
    from pinn_fem_tpu_torch.io.frame_io import run_frame_analysis
    from pinn_fem_tpu_torch.ops import kernels

    calls = {}
    for kind, size in (("tower", (2, 2)), ("grid", (2, 2, 2))):
        _, solve, modal, _, _, _, _ = frame_family(kind)
        problem, _ = frame_problem(kind, *size)
        for name, fn in (("static", solve), ("modal", modal)):
            calls[f"mesh_{kind}_{name}"] = (
                lambda fn=fn, problem=problem: fn(problem, mesh=object(),
                                                  device=dev),
                NotImplementedError, "item 15")
        if kind == "tower":
            for typ, words in (
                    ("reliability", "needs at least one random"),
                    ("sizing", 'frame sizing needs "displacement_limit"')):
                calls[f"{kind}_{typ}"] = (
                    lambda problem=problem, typ=typ: run_frame_analysis(
                        problem, {"type": typ}, dev), ValueError, words)
            calls[f"{kind}_identification"] = (
                lambda problem=problem: run_frame_analysis(
                    problem, {"type": "identification"}, dev),
                ValueError, 'needs "measured_dofs"')
    refused = {}
    kernels.reset_launch_counts()
    for name, (call, kind, text) in calls.items():
        try:
            call()
            refused[name] = None
        except kind as e:
            refused[name] = str(e)
            require(text in str(e), f"21(f) {name}: the message names "
                    f"{text}")
    launches = kernels.launch_counts()
    log("phase21f_refusals", card=card, refused=refused, launches=launches)
    for name, msg in refused.items():
        require(msg is not None, f"21(f): {name} refused")
    require(zero_launches(launches), "21(f): no launch before refusal")


def phase_frame(workdir: Path, dev, card: str) -> dict:
    """Phase 21: the 2D and 3D frame families on the card.  Returns the
    kernels' launches on each of its paths and the kernels' figures on the
    tower's and the skeleton's operators."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches = frame_documents(workdir, dev, card)
    lap("a")
    tower_launches, tower_stats = frame_banded_statics(
        workdir, dev, card, "tower", "21(b)", FRAME_TOWER, 0)
    launches.update(tower_launches)
    launches.update(frame_count_spread(dev, card))
    lap("b")
    grid_launches, grid_stats = frame_banded_statics(
        workdir, dev, card, "grid", "21(c)", FRAME3D_GRID, 1)
    launches.update(grid_launches)
    lap("c")
    launches.update(frame_banded_modal(dev, card))
    lap("d")
    launches["dense_2k"] = frame_dense(dev, card)
    lap("e")
    frame_refusals(workdir, dev, card)
    lap("f")
    log("phase21_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches, "tower": tower_stats, "grid": grid_stats}


PLATE_SLAB = (128, 0.02)        # 22(a): 49,923 DOFs, 33 diagonals
PLATE_TOL = 1e-7                # solve_plate_static_banded's default
PLATE_U_RTOL = 1e-3             # against float64 of the same diagonals
PLATE_NAVIER_RTOL = 2e-3        # tests/test_plate.py:323-352's bound
PLATE_WARM_RUNS = 3
PLATE_DENSE = (50, 0.05)        # 22(c): 7,803 DOFs, the dense budget
PLATE_DENSE_RTOL = 1e-10        # card against the port's CPU run, float64
PLATE_STATIC_RTOL = 1e-9        # 22(c) against scipy.sparse float64
PLATE_EIG_RTOL = 1e-9
PLATE_SHAPE_ATOL = 1e-7         # of max |phi|, M-normalized, cluster spans
PLATE_DYN_RTOL = 1e-9
PLATE_REDUCTION = 24            # 1,875 DOFs: reduction's dense limit
PLATE_MODES = 6
PLATE_PRESTRESS = [-2e4, 0.0, 0.0]   # prestressed modal and buckling N
PLATE_BUCKLING_RTOL = 2e-2      # tests/test_plate.py:144-154's bound
PLATE_NEWMARK_STEPS = 200
PLATE_HARMONIC_FREQS = 8
PLATE_MIRROR_RTOL = (2e-4, 2e-5)  # tests/test_plate_plastic.py:196-219
PLATE_PLASTIC_RTOL = 1e-9       # eq_plastic: the Newton tolerance
PLATE_PLASTIC_REFINE = 8        # dyn-plate-plastic at 128 x 8: 3,483 DOFs
PLATE_CLUSTER = 1e-3            # modes this close share a span
SPECTRAL_RTOL = 1e-10           # card against the port's CPU run, float64
SPECTRAL_WALL = (44, 88)        # 22(d): 8,010 DOFs, under the 8192 budget
SPECTRAL_WALL_FREQS = 64
SPECTRAL_WALL_RTOL = 1e-9       # against scipy's float64 splu sweep


def plate_document(n: int, t: float, **analysis) -> dict:
    """dyn-plate.json refined to an n x n slab of thickness t (hard simply
    supported on four edges, q = -1000, E 2e11, nu 0.3), the analysis
    block `analysis`."""
    doc = json.loads((ROOT / "examples" / "json" / "dyn-plate.json")
                     .read_text())
    doc["mesh"].update(nx=n, ny=n)
    doc["material"]["thickness"] = t
    doc["analysis"] = analysis
    return doc


def plate_slab(workdir: Path, dev, card: str):
    """22(a) and 22(b): the n x n slab at full width through
    solve_plate_static_banded(tol=1e-7) and as a document through main()
    probing the centre node: u against a float64 scipy solve of the same
    float32 diagonals (and, beside it, of the float64 operator, fault
    3.23), the centre deflection against mindlin_navier_w, the relative
    residual, the launches (kernel 1: 1, kernels 2 and 3: 32 ceil(it /
    32)), the PCG iterations and ms an iteration, the layout build, warm
    wall (median of PLATE_WARM_RUNS), the idle share; kernels 1-3 on the
    plate's operator against their twins (`operator_kernels`)."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.plate_io import parse_plate_document
    from pinn_fem_tpu_torch.models import plate as PL
    from pinn_fem_tpu_torch.ops import dia, kernels

    n, t = PLATE_SLAB
    centre = (n // 2) * (n + 1) + n // 2
    doc = plate_document(n, t, type="static", tolerance=PLATE_TOL,
                         probe_nodes=[centre])
    problem = parse_plate_document(doc)[0]
    t0 = time.perf_counter()
    layout = PL.plate_dia_layout(problem)
    layout_s = time.perf_counter() - t0
    _, diags, mask = PL._banded_operator(problem, torch.float32, dev)
    stats = operator_kernels(layout, diags, mask, dev, card, "22(b)",
                             "the plate", "phase22b_kernels", 22)

    def solve():
        return PL.solve_plate_static_banded(problem, tol=PLATE_TOL,
                                            device=dev)

    kernels.reset_launch_counts()
    with Timed(dia, "dia_cg_solve") as pcg_calls:
        cold_s, (res, iters, rel) = synced(solve)
    launches = {"plate_50k_api": kernels.launch_counts()}
    pcg_s = pcg_calls[0][0]
    warm = [synced(solve)[0] for _ in range(PLATE_WARM_RUNS)]
    f64 = PL._static_loads(problem, "cpu").numpy()
    prof = pcg_profile(layout, diags, torch.as_tensor(
        f64, dtype=torch.float32, device=dev), mask)
    idle = idle_profile(solve)
    free = problem.free_dofs()
    t0 = time.perf_counter()
    u_same = float64_sparse_solve(dia_csr64(layout, diags), f64, free)
    ref_s = time.perf_counter() - t0
    diags64 = PL._banded_operator(problem, torch.float64, dev)[1]
    u64 = float64_sparse_solve(dia_csr64(layout, diags64), f64, free)
    del diags64
    u = res.displacements
    scale = np.abs(u64).max()
    u_gap = float(np.abs(u - u_same).max() / scale)
    u_gap64 = float(np.abs(u - u64).max() / scale)
    floor32 = float(np.abs(u_same - u64).max() / scale)
    w_ex = PL.mindlin_navier_w(1.0, 1.0, 0.5, 0.5, -1000.0, 2e11, 0.3, t)
    navier = abs(u[3 * centre] - w_ex) / abs(w_ex)
    rounds = 32 * -(-iters // 32)
    expected = {"dia_matvec": 1, "dia_dir_matvec": rounds,
                "cg_update": rounds, "material_coefficients": 0,
                "material_coefficients_backward": 0}

    path = workdir / "plate_slab.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    kernels.reset_launch_counts()
    cli_s, rc = synced(lambda: main([str(path)]))
    launches["plate_50k_cli"] = kernels.launch_counts()
    require(rc == 0, "22(a): the slab document's exit code 0")
    out = json.loads((workdir / "plate_slab.res.json").read_text())
    cli_gap = abs(out["displacements"][0] - u_same[3 * centre]) / scale
    cli_navier = abs(out["displacements"][0] - w_ex) / abs(w_ex)
    cli_rounds = 32 * -(-out["iterations"] // 32)
    log("phase22a_slab", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth, iterations=iters,
        relative_residual=rel, centre_w=float(u[3 * centre]),
        navier_w=w_ex, navier_err=navier, u_gap_vs_same_system=u_gap,
        u_gap_vs_float64=u_gap64, float32_representation_floor=floor32,
        cold_s=cold_s, warm_s=warm, warm_median_s=float(np.median(warm)),
        pcg_s=pcg_s, pcg_ms_per_iteration=1e3 * pcg_s / max(iters, 1),
        profile=prof, solve_idle=idle, layout_build_s=layout_s,
        float64_reference_s=ref_s, launches=launches, expected=expected,
        cli_s=cli_s, cli_iterations=out["iterations"],
        cli_relative_residual=out["relative_residual"],
        cli_centre_gap_vs_same_system=cli_gap, cli_navier_err=cli_navier,
        cli_tier=out["tier"])
    require(rel <= PLATE_TOL, "22(a): relative residual <= 1e-7")
    require(u_gap <= PLATE_U_RTOL, f"22(a): u within {PLATE_U_RTOL} of "
            "the float64 solve of the same diagonals")
    require(navier <= PLATE_NAVIER_RTOL, "22(a): the centre within "
            f"{PLATE_NAVIER_RTOL} of mindlin_navier_w")
    require(launches["plate_50k_api"] == expected,
            "22(a): the launches of the formula")
    require(out["tier"] == "banded" and out["relative_residual"]
            <= PLATE_TOL, "22(a): the document's banded tier")
    require(cli_gap <= PLATE_U_RTOL and cli_navier <= PLATE_NAVIER_RTOL,
            "22(a): the document's centre probe")
    require(launches["plate_50k_cli"] == dict(
        expected, dia_dir_matvec=cli_rounds, cg_update=cli_rounds),
        "22(a): the document's launches of the formula")
    return launches, stats


def cluster_gap(lam, got, want, mass) -> float:
    """The largest component of got's shapes (rows) outside the span of
    want's shapes (M-orthonormal rows) of the same cluster of eigenvalues
    (within PLATE_CLUSTER of each other: a square plate's degenerate pairs,
    and the pairs a small prestress splits by 1e-4, whose vectors turn by
    rounding over the split while their span does not), over the largest
    entry of want; mass dense or scipy sparse."""
    import numpy as np

    gap, done = 0.0, set()
    for i, lam_i in enumerate(lam):
        if i in done:
            continue
        c = np.flatnonzero(np.abs(lam - lam_i) <= PLATE_CLUSTER * abs(lam_i))
        done.update(c.tolist())
        g, w = got[c], want[c]
        r = g - (g @ (mass @ w.T)) @ w
        gap = max(gap, float(np.abs(r).max() / np.abs(w).max()))
    return gap


def plate_plastic(workdir: Path, dev, report: dict, gates: list) -> None:
    """22(c), plasticity: dyn-plate-plastic.json's float64 tier on the card
    against its CPU run (u and moments at PLATE_DENSE_RTOL, the plastic
    strain at the Newton tolerance); the float32 tier on
    tests/test_plate_plastic.py's mirror plate against the float64 tier at
    that test's bounds (max-normalized); the corpus strip refined
    PLATE_PLASTIC_REFINE times (above DENSE_DOF_LIMIT) through main() on
    the float32 tier beside the float64 tier run on the card: ROADMAP
    fault 3.30, both packages' float32 tier stalls there (at 3,483 DOFs on
    the CPU: |r|/|f| 0.13 at the first, elastic step, NaN from the fifth),
    so the gates are the document's success false and the float64 tier's
    convergence; each step's probe gap is recorded."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.plate_io import parse_plate_document
    from pinn_fem_tpu_torch.models import plate as PL
    from pinn_fem_tpu_torch.ops.plastic import params_arrays
    from pinn_fem_tpu_torch.solvers import newton
    from pinn_fem_tpu_torch.solvers import plate_plasticity as PPL
    from pinn_fem_tpu_torch.solvers.plane_plasticity import float64_loop

    def rel(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    doc = json.loads((ROOT / "examples" / "json" / "dyn-plate-plastic.json")
                     .read_text())
    strip = parse_plate_document(doc)[0]
    an = doc["analysis"]
    kw = dict(sigma_y=an["sigma_y"], n_layers=an["n_layers"],
              load_factors=an["load_factors"])
    s, gb, g = peak_run(dev, lambda: PPL.solve_plate_plastic(
        strip, device=dev, **kw))
    c = PPL.solve_plate_plastic(strip, host=True, **kw)
    # The plastic strain of a layer that has just yielded is the difference
    # of two nearly equal numbers (the trial yield function), so it carries
    # the residual of runs that each stop at |r| / |f| <= 1e-9.
    gaps = {k: rel(getattr(g, k), getattr(c, k))
            for k in ("displacements", "moments", "eq_plastic")}
    report["plastic_float64"] = dict(s=s, peak_gb=gb, gaps=gaps,
                                     converged=g.converged)
    gates += [(max(gaps["displacements"], gaps["moments"])
               <= PLATE_DENSE_RTOL, "22(c) plastic_float64: u, moments"),
              (gaps["eq_plastic"] <= PLATE_PLASTIC_RTOL,
               "22(c) plastic_float64: eq_plastic"),
              (g.converged, "22(c) plastic_float64: converged")]

    nodes, el = PL.rect_mesh(2.0, 1.0, 2, 1)
    mirror = PL.PlateProblem(nodes, el, 200.0, 0.3, 0.5, 1.0,
                             np.zeros(3 * len(nodes)),
                             PL.plate_supports(nodes, "left", "clamped"),
                             pressure=0.6)
    mkw = dict(sigma_y=1.0, hardening_iso=20.0, hardening_kin=5.0,
               n_layers=4, load_factors=[0.6, 1.0, 0.2])
    host = PPL.solve_plate_plastic(mirror, host=True, **mkw)
    s, gb, f32 = peak_run(dev, lambda: PPL.solve_plate_plastic(
        mirror, host=False, device=dev, **mkw))
    rtol, atol = PLATE_MIRROR_RTOL
    ok = all(float(np.abs(getattr(f32, k) - getattr(host, k)).max())
             <= rtol * float(np.abs(getattr(host, k)).max()) + atol
             for k in ("displacements", "von_mises"))
    report["plastic_float32_mirror"] = dict(
        s=s, peak_gb=gb, residuals=f32.residuals.tolist(),
        u_gap=float(np.abs(f32.displacements - host.displacements).max()))
    gates.append((ok and f32.residuals.max() <= 2e-5,
                  "22(c) plastic float32 tier: the mirror bounds"))

    r = PLATE_PLASTIC_REFINE
    doc["mesh"].update(nx=16 * r, ny=r)
    mid = 8 * r                               # the midspan nodes
    doc["analysis"]["probe_nodes"] = [mid, r * (16 * r + 1) + mid]
    fine = parse_plate_document(doc)[0]
    path = workdir / "plate_plastic_fine.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    torch.cuda.reset_peak_memory_stats(dev)
    cli_s, rc = synced(lambda: main([str(path)]))
    cli_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    out = json.loads(path.with_suffix(".res.json").read_text())
    sy, hi, hk = params_arrays(fine.nelm, an["sigma_y"])
    lfs = np.asarray(an["load_factors"], dtype=float)
    system = PPL._PlateSystem(fine, sy, hi, hk, an["n_layers"], 1e-8,
                              torch.float64, dev)
    s64, f64 = synced(lambda: PPL._result(lfs, *float64_loop(
        system, lfs, 1e-9, 30, 1e-12)))
    probe = np.asarray(out["probe_dofs"])
    u32 = np.asarray(out["displacements"], dtype=float)
    u64 = f64.displacements[:, probe]
    report["plastic_float32_refined"] = dict(
        ndof=fine.ndof, dense_limit=newton.DENSE_DOF_LIMIT, s=cli_s,
        peak_gb=cli_gb, success=out["success"],
        iterations=out["iterations"], max_residual=out["max_residual"],
        probe_gap_vs_float64_by_step=(np.abs(u32 - u64).max(axis=1)
                                      / np.abs(u64).max(axis=1)).tolist(),
        non_finite=int(np.count_nonzero(~np.isfinite(np.asarray(
            out["final"]["displacements"], dtype=float)))),
        n_plastic=out["n_plastic"], n_plastic_f64=f64.n_plastic.tolist(),
        float64_s=s64, float64_iterations=f64.iterations.tolist(),
        float64_residuals=f64.residuals.tolist())
    # Fault 3.30: the float32 tier stalls at eps32 times the plate's
    # condition number; the document must say so (success false), while
    # the float64 tier on the same problem converges.
    gates += [(rc == 0, "22(c) refined plastic strip: exit code 0"),
              (fine.ndof > newton.DENSE_DOF_LIMIT,
               "22(c) refined plastic strip: the float32 tier"),
              (out["success"] is False, "22(c) refined plastic strip: "
               "the float32 tier's stall reported (fault 3.30)"),
              (f64.converged, "22(c) refined plastic strip: float64 "
               "converged")]


def plate_dense(workdir: Path, dev, card: str) -> dict:
    """22(c): the dense float64 plate analyses on the card at n x n (near
    the 8,192-DOF budget), each against scipy.sparse float64 on the port's
    MITC4 blocks (examples_grid.plate_sparse_matrices): statics (splu; u
    and the moments), modal and prestressed modal (eigsh shift-invert:
    eigenvalues, shapes by cluster spans), buckling under uniaxial
    compression (eigsh on the pencil (-K_g, K), and against
    mindlin_ss_buckling_nx), Newmark (`newmark_replay`), harmonic
    (`harmonic_replay`); Guyan reduction (K_ss's splu) on the
    PLATE_REDUCTION square, under DENSE_DOF_LIMIT; wall and peak memory
    of each card run.  Then `plate_plastic`.  No repo kernel."""
    import numpy as np
    import scipy.linalg
    import scipy.sparse.linalg as spl

    from pinn_fem_tpu_torch.examples_grid import plate_sparse_matrices
    from pinn_fem_tpu_torch.io.plate_io import (parse_plate_document,
                                                run_plate_analysis)
    from pinn_fem_tpu_torch.models import plate as PL
    from pinn_fem_tpu_torch.ops import kernels

    n, t = PLATE_DENSE
    problem = parse_plate_document(plate_document(n, t))[0]
    free = problem.free_dofs()
    k, m, kg = plate_sparse_matrices(problem, with_mass=True,
                                     membrane_force=PLATE_PRESTRESS)
    kf, mf = k[free][:, free].tocsc(), m[free][:, free].tocsc()
    f = PL._static_loads(problem, "cpu").numpy()
    kernels.reset_launch_counts()
    report, gates = {"ndof": problem.ndof, "free": int(free.size)}, []
    clock = [0.0]

    def on_card(label, fn):
        s, gb, out = peak_run(dev, fn)
        report[label] = {"s": s, "peak_gb": gb}
        clock[0] = time.perf_counter()
        return out

    def gate(label, gap, bound, what=""):
        report[label].setdefault("reference_s",
                                 time.perf_counter() - clock[0])
        report[label][what or "gap"] = gap
        gates.append((gap <= bound, f"22(c) {label} {what}".rstrip()))

    def rel(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    g = on_card("static", lambda: PL.solve_plate_static(problem, device=dev))
    u = float64_sparse_solve(k, f, free)
    gate("static", max(rel(g.displacements, u),
                       rel(g.moments, PL.recover_moments(problem, u)[0])),
         PLATE_STATIC_RTOL)
    lam = {}
    for label, nf in (("modal", None), ("modal_prestressed",
                                        PLATE_PRESTRESS)):
        g = on_card(label, lambda: PL.plate_modal(
            problem, PLATE_MODES, membrane_force=nf, device=dev))
        a = kf if nf is None else (kf + kg[free][:, free]).tocsc()
        w, vec = spl.eigsh(a, k=PLATE_MODES, M=mf, sigma=0.0, which="LM")
        order = np.argsort(w)
        w, vec = w[order], vec[:, order]
        vec = vec / np.sqrt(np.einsum("ij,ij->j", vec, mf @ vec))
        gate(label, rel(g.eigenvalues, w), PLATE_EIG_RTOL, "eig_gap")
        gate(label, cluster_gap(w, g.mode_shapes[:, free], vec.T, mf),
             PLATE_SHAPE_ATOL, "shape_gap")
        report[label]["frequencies_hz"] = g.frequencies_hz.tolist()
        lam[label] = w
    om1 = float(np.sqrt(lam["modal"][0]))
    g = on_card("buckling", lambda: PL.plate_buckling(
        problem, PLATE_PRESTRESS, n_modes=2, device=dev))
    mu = spl.eigsh(-kg[free][:, free].tocsc(), k=2, M=kf, which="LA",
                   return_eigenvectors=False)
    gate("buckling", rel(g.load_factors, np.sort(1.0 / mu[mu > 0])),
         PLATE_EIG_RTOL)
    exact = PL.mindlin_ss_buckling_nx(1.0, 1.0, 2e11, 0.3, t) \
        / abs(PLATE_PRESTRESS[0])
    gate("buckling", abs(g.load_factors[0] - exact) / exact,
         PLATE_BUCKLING_RTOL, "closed_form_err")
    report["buckling"]["load_factors"] = g.load_factors.tolist()
    centre = (n // 2) * (n + 1) + n // 2
    probe = [3 * centre, 3 * centre + 1]
    damping = (0.02 * om1, 0.02 / om1)
    cf = (damping[0] * mf + damping[1] * kf).tocsc()
    ff = f[free]
    dt = 2.0 * np.pi / om1 / 40.0
    amp = np.sin(0.5 * om1 * dt * np.arange(PLATE_NEWMARK_STEPS))
    g = on_card("newmark", lambda: PL.solve_plate_transient(
        problem, dt, PLATE_NEWMARK_STEPS, damping=damping, amplitude=amp,
        probe_dofs=probe, record_every=10, device=dev))
    gate("newmark", rel(g.displacements, newmark_replay(
        kf, mf, cf, ff, free, problem.ndof, dt, amp, probe)),
         PLATE_DYN_RTOL)
    om = np.linspace(0.3 * om1, 3.0 * om1, PLATE_HARMONIC_FREQS)
    g = on_card("harmonic", lambda: PL.plate_harmonic(
        problem, om, damping=damping, probe_dofs=probe, device=dev))
    gate("harmonic", rel(g.amplitude, harmonic_replay(
        kf, mf, cf, ff, om, np.searchsorted(free, probe))), PLATE_DYN_RTOL)
    # Reduction is dense-only up to DENSE_DOF_LIMIT in both packages: a
    # smaller square of the same plate.
    n = PLATE_REDUCTION
    centre = (n // 2) * (n + 1) + n // 2
    problem = parse_plate_document(plate_document(n, t))[0]
    free = problem.free_dofs()
    k, m, _ = plate_sparse_matrices(problem, with_mass=True)
    kf, mf = k[free][:, free].tocsc(), m[free][:, free].tocsc()
    an = {"type": "reduction", "method": "guyan",
          "master_nodes": [centre, centre + 3, centre - 3 * (n + 1)]}
    g = on_card("reduction", lambda: run_plate_analysis(problem, an, dev))
    report["reduction"]["ndof"] = problem.ndof
    mpos = np.searchsorted(free, g["master_dofs"])
    spos = np.setdiff1d(np.arange(free.size), mpos)
    phi = -spl.splu(kf[spos][:, spos].tocsc()).solve(
        kf[spos][:, mpos].toarray())
    tmat = np.zeros((free.size, mpos.size))
    tmat[mpos, np.arange(mpos.size)] = 1.0
    tmat[spos] = phi
    k_red = kf[mpos][:, mpos].toarray() + kf[mpos][:, spos] @ phi
    m_red = tmat.T @ (mf @ tmat)
    w_red = scipy.linalg.eigh(k_red, m_red, eigvals_only=True)
    w_full = spl.eigsh(kf, k=len(g["full_omegas"]), M=mf, sigma=0.0,
                       which="LM", return_eigenvectors=False)
    gate("reduction", max(
        rel(g["k_red"], k_red), rel(g["m_red"], m_red),
        rel(g["reduced_omegas"], np.sqrt(np.maximum(w_red, 0.0))),
        rel(g["full_omegas"], np.sqrt(np.sort(w_full)))), PLATE_DYN_RTOL)
    plate_plastic(workdir, dev, report, gates)
    launches = kernels.launch_counts()
    report["launches"] = launches
    log("phase22c_dense", card=card, **report)
    for ok, what in gates:
        require(ok, what)
    require(zero_launches(launches), "22(c): no repo kernel")
    return launches


def spectral_documents_of(family: str) -> dict:
    """A small document of a family with a load pattern (the spectrum and
    random runs of tests/test_torch_continuum_spectrum.py)."""
    from pinn_fem_tpu_torch import examples_grid as g

    if family == "solid":
        return {"element_type": "solid",
                "mesh": {"type": "box", "lx": 1.0, "ly": 1.4, "lz": 3.0,
                         "nx": 2, "ny": 2, "nz": 3},
                "material": {"young": 200.0, "poisson": 0.3,
                             "density": 2.0},
                "fixed_nodes": "z_min",
                "surface_loads": [{"face": "z_max",
                                   "traction": [0.3, 0.1, -1.0]}]}
    if family == "frame":
        doc = g.frame_tower_document(4, 3)
        doc["material"]["section_modulus"] = 1e-3
        return doc
    if family == "frame3d":
        doc = g.space_frame_grid_document(3, 3, 2)
        doc["material"]["inertia_z"] = 1.5e-4
        return doc
    return {"element_type": "plate",
            "mesh": {"type": "rect", "width": 1.0, "height": 0.7, "nx": 8,
                     "ny": 6},
            "material": {"young": 2e11, "poisson": 0.3, "thickness": 0.05,
                         "density": 7850.0},
            "pressure": -1000.0,
            "supports": {"simply_supported": ["left", "right", "bottom",
                                              "top"]}}


def spectral_wall_document() -> dict:
    """A plane-stress shear wall near the 8,192-DOF budget (44 x 88 Q4s,
    4 x 8, E 200, t 0.5, rho 2, fixed base) under a top traction: a random
    document at SPECTRAL_WALL_FREQS frequencies with Dirlik fatigue."""
    nx, ny = SPECTRAL_WALL
    return {"element_type": "plane",
            "mesh": {"type": "rect", "width": 4.0, "height": 8.0, "nx": nx,
                     "ny": ny, "element": "quad"},
            "material": {"young": 200.0, "poisson": 0.3, "thickness": 0.5,
                         "density": 2.0},
            "fixed_nodes": "bottom",
            "edge_loads": [{"nodes": "top", "traction": [1.0, 0.0]}],
            "analysis": {"type": "random", "psd": 1.0,
                         "omegas": {"start": 0.05, "stop": 2.0,
                                    "num": SPECTRAL_WALL_FREQS},
                         "damping": [0.02, 0.01],
                         "probe_nodes": [ny * (nx + 1), (ny + 1) * (nx + 1)
                                         - 1],
                         "probe_elements": [0, nx - 1, nx * ny // 2],
                         "fatigue": {"sn": {"exponent": 3.0,
                                            "coefficient": 1e9},
                                     "method": "dirlik",
                                     "duration": 3600.0}}}


def wall_reference(doc: dict):
    """(psd (n_freq, n_probe), eq_rms (n_probe_elm,)) of the wall's random
    document by scipy's float64 sparse complex LU a frequency (the
    response and the Preumont equivalent von Mises of the probe
    elements)."""
    import numpy as np
    import scipy.sparse.linalg as spl

    from pinn_fem_tpu_torch.examples_grid import plane_sparse_matrices
    from pinn_fem_tpu_torch.io._common import _omega_array
    from pinn_fem_tpu_torch.io.plane_io import (_probe_dofs,
                                                parse_plane_document)
    from pinn_fem_tpu_torch.models import plane as P
    from pinn_fem_tpu_torch.solvers.continuum_spectrum import _VM_Q6

    problem, an = parse_plane_document(doc)
    k, m = plane_sparse_matrices(problem, with_mass=True)
    free = problem.free_dofs()
    kf, mf = k[free][:, free].tocsc(), m[free][:, free].tocsc()
    alpha, beta = an["damping"]
    cf = alpha * mf + beta * kf
    om = _omega_array(an["omegas"])
    probe = np.asarray(_probe_dofs(an, problem)).reshape(-1)
    elms = np.asarray(an["probe_elements"])
    young, nu = P._material(problem, "cpu", "young", "poisson")
    b = P._centroid_b(problem, "cpu").numpy()[elms]
    dmat = P._dmat(young, nu, False).numpy()[elms]
    dm = problem.dof_map()[elms]
    psd, quad = [], []
    full = np.zeros(problem.ndof, dtype=complex)
    for w in om:
        full[free] = spl.splu((kf - w * w * mf + 1j * w * cf).tocsc()
                              ).solve(problem.loads[free].astype(complex))
        psd.append(np.abs(full[probe]) ** 2)
        s3 = np.einsum("mij,mj->mi", dmat, np.einsum("mia,ma->mi", b,
                                                     full[dm]))
        s6 = np.zeros((elms.size, 6), dtype=complex)
        s6[:, 0], s6[:, 1], s6[:, 5] = s3[:, 0], s3[:, 1], s3[:, 2]
        quad.append(np.einsum("mi,ij,mj->m", s6.conj(), _VM_Q6, s6).real)
    psd, quad = np.asarray(psd), np.asarray(quad)
    return psd, np.sqrt(np.trapezoid(quad, om, axis=0))


def spectral_documents(workdir: Path, dev, card: str) -> dict:
    """22(d): dyn-plane-spectrum.json and a spectrum and a random document
    of the solid, frame, space-frame and plate families through main() on
    the card, each against the port's run of the same document on the CPU
    at SPECTRAL_RTOL; the 8,010-DOF wall's random document with Dirlik
    fatigue at SPECTRAL_WALL_FREQS frequencies on the card, its PSDs and
    equivalent stress RMS against scipy's float64 sweep, ms a frequency
    (one sweep serves the response and the stress FRFs); no repo
    kernel."""
    import numpy as np

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io import (frame3d_io, frame_io, plane_io,
                                       plate_io, solid_io)
    from pinn_fem_tpu_torch.ops import kernels

    runners = {"plane": plane_io.run_plane_document,
               "solid": solid_io.run_solid_document,
               "frame": frame_io.run_frame_document,
               "frame3d": frame3d_io.run_frame3d_document,
               "plate": plate_io.run_plate_document}
    docs = {"dyn-plane-spectrum": json.loads(
        (ROOT / "examples" / "json" / "dyn-plane-spectrum.json")
        .read_text())}
    direction = {"solid": [0.2, 1.0, 0.1], "frame": [1.0, 0.0],
                 "frame3d": [0.3, 1.0, 0.0]}
    probe_nodes = {"solid": [31, 35], "frame": [4, 9], "frame3d": [3, 7],
                   "plate": [31, 40]}
    for family in ("solid", "frame", "frame3d", "plate"):
        base = spectral_documents_of(family)
        w = float(runners[family](dict(base, analysis={
            "type": "modal", "n_modes": 3}), "cpu")["omegas"][2])
        spec = {"type": "spectrum", "n_modes": 4, "combination": "cqc",
                "sa": {"omegas": [0.0, 2.0 * w], "values": [3.0, 1.0]}}
        if family in direction:
            spec["direction"] = direction[family]
        docs[f"{family}-spectrum"] = dict(base, analysis=spec)
        rand = {"type": "random", "psd": 1.0,
                "probe_nodes": probe_nodes[family],
                "omegas": {"start": 0.1 * w, "stop": 2.0 * w, "num": 24},
                "damping": [0.02 * w, 0.01 / w]}
        if family != "frame3d":
            rand["fatigue"] = {"sn": {"exponent": 4.0,
                                      "coefficient": 1e20},
                               "method": "dirlik", "duration": 60.0}
            rand["probe_elements"] = [0, 3]
        docs[f"{family}-random"] = dict(base, analysis=rand)
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    kernels.reset_launch_counts()
    gaps = {}
    for name, doc in docs.items():
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(doc))
        card_s, rc = synced(lambda: main([str(path)]))
        require(rc == 0, f"22(d) {name}: exit code 0")
        got = json.loads((workdir / f"{name}.res.json").read_text())
        t0 = time.perf_counter()
        want = json.loads(json.dumps(runners[doc["element_type"]](
            json.loads(json.dumps(doc)), "cpu")))
        doc_gaps = tree_gaps(got, want)
        gaps[name] = {"max": max(doc_gaps.values()),
                      "worst": max(doc_gaps, key=doc_gaps.get), "s": card_s,
                      "cpu_s": time.perf_counter() - t0}
        require(gaps[name]["max"] <= SPECTRAL_RTOL,
                f"22(d) {name}: within {SPECTRAL_RTOL} of the CPU run")
    wall = spectral_wall_document()
    s, gb, out = peak_run(dev, lambda: plane_io.run_plane_document(
        json.loads(json.dumps(wall)), dev))
    t0 = time.perf_counter()
    psd, eq_rms = wall_reference(wall)
    ref_s = time.perf_counter() - t0
    psd_gap = float(np.abs(np.asarray(out["psd"]) - psd).max()
                    / np.abs(psd).max())
    rms_gap = float(np.abs(np.asarray(out["fatigue"]["stress_rms"])
                           - eq_rms).max() / np.abs(eq_rms).max())
    launches = kernels.launch_counts()
    log("phase22d_spectral", card=card, gaps=gaps, wall=dict(
        ndof=2 * (SPECTRAL_WALL[0] + 1) * (SPECTRAL_WALL[1] + 1),
        frequencies=SPECTRAL_WALL_FREQS, s=s, peak_gb=gb,
        ms_per_frequency=1e3 * s / SPECTRAL_WALL_FREQS,
        psd_gap=psd_gap, eq_rms_gap=rms_gap, reference_s=ref_s,
        damage_rate=out["fatigue"]["damage_rate"]), launches=launches)
    require(psd_gap <= SPECTRAL_WALL_RTOL and rms_gap <= SPECTRAL_WALL_RTOL,
            f"22(d) the wall: within {SPECTRAL_WALL_RTOL} of scipy")
    require(zero_launches(launches), "22(d): no repo kernel")
    return launches


def plate_refusals(workdir: Path, dev, card: str) -> None:
    """22(e): dyn-plate-identify.json with "banded": false beside its
    zones through the CLI's run() (the JAX package's ValueError) and a
    plate's bare reliability and sizing blocks (ported in phase 25, the
    JAX package's ValueErrors), each refused before any launch (the
    shell's refusals: 23(e))."""
    from pinn_fem_tpu_torch.cli.generic import run
    from pinn_fem_tpu_torch.io.plate_io import run_plate_document
    from pinn_fem_tpu_torch.ops import kernels

    ident = json.loads((ROOT / "examples" / "json"
                        / "dyn-plate-identify.json").read_text())
    ident["analysis"]["banded"] = False
    ident_path = workdir / "dyn-plate-identify.json"
    ident_path.write_text(json.dumps(ident))
    small = plate_document(4, 0.05)
    calls = {
        "plate_identification": (lambda: run(str(ident_path), device=dev),
                                 ValueError, "rides the banded tier"),
    }
    for kind, words in (("reliability", "needs at least one random"),
                        ("sizing", 'plate sizing needs "displacement_limit"')):
        calls[f"plate_{kind}"] = (lambda kind=kind: run_plate_document(
            dict(small, analysis={"type": kind}), dev), ValueError, words)
    refused = {}
    kernels.reset_launch_counts()
    for name, (call, kind, text) in calls.items():
        try:
            call()
            refused[name] = None
        except kind as e:
            refused[name] = str(e)
            require(text in str(e), f"22(e) {name}: the message names "
                    f"{text}")
    launches = kernels.launch_counts()
    log("phase22e_refusals", card=card, refused=refused, launches=launches)
    for name, msg in refused.items():
        require(msg is not None, f"22(e): {name} refused")
    require(zero_launches(launches), "22(e): no launch before refusal")


def phase_plate(workdir: Path, dev, card: str) -> dict:
    """Phase 22: the plate family and the continuum spectrum / random
    analyses on the card.  Returns the kernels' launches on each of its
    paths and the kernels' figures on the slab's operator."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches, slab_stats = plate_slab(workdir, dev, card)
    lap("a-b")
    launches["dense_8k"] = plate_dense(workdir, dev, card)
    lap("c")
    launches["spectral"] = spectral_documents(workdir, dev, card)
    lap("d")
    plate_refusals(workdir, dev, card)
    lap("e")
    log("phase22_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches, "slab": slab_stats}


SHELL_ROOF = 96                 # 23(a): 56,454 DOFs, 69 diagonals
SHELL_TOL = 1e-7                # solve_shell_static_banded's default
SHELL_U_RTOL = 1e-3             # against float64 of the same diagonals
SHELL_PUBLISHED = 0.3024        # the Scordelis-Lo midside free-edge target
SHELL_PUBLISHED_RTOL = 1e-2
SHELL_PUBLISHED_ROOF = 32       # 6,534 DOFs: the largest mesh whose own
                                # float64 solution lies within 1e-2 of it
                                # (ROADMAP fault 3.34)
SHELL_WARM_RUNS = 3
SHELLNL_STRIP = (16, 512)       # 23(b): 52,326 DOFs, 8,192 facets
SHELLNL_LOADS = (0.25, 0.5, 0.75, 1.0)
SHELLNL_EXACT_RTOL = 3e-3       # benchmarks/scaling.py:741's gate
SHELL_DENSE_ROOF = 17           # 23(d): 1,944 DOFs, under DENSE_DOF_LIMIT
SHELL_DYN_ROOF = 35             # 23(d): 7,776 DOFs
SHELL_DENSE_RTOL = 1e-10        # card against the port's CPU run, float64
SHELL_SHAPE_ATOL = 1e-7         # of max |phi|, by cluster spans
SHELL_PLASTIC_RTOL = 1e-9       # plastic strain: the Newton tolerance
SHELL_DYN_RTOL = 1e-9           # 35 x 35 against scipy.sparse float64
SHELL_NEWMARK_STEPS = 100
SHELL_HARMONIC_FREQS = 8
SHELL_PLASTIC_STRIP = (40, 8)   # 23(d): 2,214 DOFs, the float32 tier
# The matmul operations of one facet's Marguerre blocks
# (solvers/shell_nonlinear._marguerre_blocks): 1,186 a Gauss point, 4
# points, and the bending and drilling forces.
MARGUERRE_OPS = 4 * 1186 + 288 + 32


def shell_roof_document(n: int, **analysis) -> dict:
    """dyn-shell.json (the Scordelis-Lo roof, self-weight, end diaphragms)
    refined to n x n, the analysis block `analysis`."""
    doc = json.loads((ROOT / "examples" / "json" / "dyn-shell.json")
                     .read_text())
    doc["mesh"].update(nx=n, ny=n)
    doc["analysis"] = analysis
    return doc


def midside(n: int) -> int:
    """The roof's midside free-edge node (x > 0, y = L / 2)."""
    return (n // 2) * (n + 1) + n


def shell_roof(workdir: Path, dev, card: str):
    """23(a), 23(c) on its operator: the n x n roof at full width through
    solve_shell_static_banded(tol=1e-7) and as a document through main()
    probing the midside node: u against a float64 scipy solve of the same
    float32 diagonals (and, beside it, of the float64 operator, fault
    3.23), the launches (kernel 1: 1, kernels 2 and 3: 32 ceil(it / 32)),
    the PCG iterations and ms an iteration, the layout build, warm wall
    (median of SHELL_WARM_RUNS), the idle share; the midside deflection
    recorded; the published 0.3024 held on the SHELL_PUBLISHED_ROOF roof
    (fault 3.34: the facet model itself departs from it past 32 x 32)."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.shell_io import parse_shell_document
    from pinn_fem_tpu_torch.models import shell as SH
    from pinn_fem_tpu_torch.ops import dia, kernels

    n = SHELL_ROOF
    mid = midside(n)
    doc = shell_roof_document(n, type="static", tolerance=SHELL_TOL,
                              probe_nodes=[mid])
    problem = parse_shell_document(doc)[0]
    t0 = time.perf_counter()
    layout = SH.shell_dia_layout(problem)
    layout_s = time.perf_counter() - t0
    _, diags, mask = SH._banded_operator(problem, torch.float32, dev)
    stats = operator_kernels(layout, diags, mask, dev, card, "23(c)",
                             "the roof", "phase23c_roof_kernels", 23)

    def solve():
        return SH.solve_shell_static_banded(problem, tol=SHELL_TOL,
                                            device=dev)

    kernels.reset_launch_counts()
    with Timed(dia, "dia_cg_solve") as pcg_calls:
        cold_s, (res, iters, rel) = synced(solve)
    launches = {"shell_roof_api": kernels.launch_counts()}
    pcg_s = pcg_calls[0][0]
    warm = [synced(solve)[0] for _ in range(SHELL_WARM_RUNS)]
    f64 = SH._static_loads(problem, "cpu").numpy()
    prof = pcg_profile(layout, diags, torch.as_tensor(
        f64, dtype=torch.float32, device=dev), mask)
    idle = idle_profile(solve)
    free = problem.free_dofs()
    t0 = time.perf_counter()
    u_same = float64_sparse_solve(dia_csr64(layout, diags), f64, free)
    ref_s = time.perf_counter() - t0
    diags64 = SH._banded_operator(problem, torch.float64, dev)[1]
    u64 = float64_sparse_solve(dia_csr64(layout, diags64), f64, free)
    del diags64
    u = res.displacements
    scale = np.abs(u64).max()
    u_gap = float(np.abs(u - u_same).max() / scale)
    w = float(u[6 * mid + 2])
    rounds = 32 * -(-iters // 32)
    expected = {"dia_matvec": 1, "dia_dir_matvec": rounds,
                "cg_update": rounds, "material_coefficients": 0,
                "material_coefficients_backward": 0}

    path = workdir / "shell_roof.json"
    path.write_text(json.dumps(doc))
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    kernels.reset_launch_counts()
    cli_s, rc = synced(lambda: main([str(path)]))
    launches["shell_roof_cli"] = kernels.launch_counts()
    require(rc == 0, "23(a): the roof document's exit code 0")
    out = json.loads((workdir / "shell_roof.res.json").read_text())
    cli_w = out["probe_displacements"][2]
    cli_gap = abs(cli_w - u_same[6 * mid + 2]) / scale
    cli_rounds = 32 * -(-out["iterations"] // 32)

    m = SHELL_PUBLISHED_ROOF
    small = parse_shell_document(shell_roof_document(m))[0]
    pub_s, (pub, pub_iters, pub_rel) = synced(
        lambda: SH.solve_shell_static_banded(small, tol=SHELL_TOL,
                                             device=dev))
    w_pub = float(pub.displacements[6 * midside(m) + 2])
    pub_err = abs(abs(w_pub) - SHELL_PUBLISHED) / SHELL_PUBLISHED
    log("phase23a_roof", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth, iterations=iters,
        relative_residual=rel, midside_w=w,
        midside_w_float64_operator=float(u64[6 * mid + 2]),
        published=SHELL_PUBLISHED, u_gap_vs_same_system=u_gap,
        u_gap_vs_float64=float(np.abs(u - u64).max() / scale),
        float32_representation_floor=float(np.abs(u_same - u64).max()
                                           / scale),
        cold_s=cold_s, warm_s=warm, warm_median_s=float(np.median(warm)),
        pcg_s=pcg_s, pcg_ms_per_iteration=1e3 * pcg_s / max(iters, 1),
        profile=prof, solve_idle=idle, layout_build_s=layout_s,
        float64_reference_s=ref_s, launches=launches, expected=expected,
        cli_s=cli_s, cli_iterations=out["iterations"],
        cli_relative_residual=out["relative_residual"],
        cli_midside_gap_vs_same_system=cli_gap, cli_tier=out["tier"],
        published_roof=dict(n=m, ndof=small.ndof, s=pub_s,
                            iterations=pub_iters, relative_residual=pub_rel,
                            midside_w=w_pub, published_err=pub_err))
    require(rel <= SHELL_TOL, "23(a): relative residual <= 1e-7")
    require(u_gap <= SHELL_U_RTOL, f"23(a): u within {SHELL_U_RTOL} of "
            "the float64 solve of the same diagonals")
    require(launches["shell_roof_api"] == expected,
            "23(a): the launches of the formula")
    require(out["tier"] == "banded" and out["relative_residual"]
            <= SHELL_TOL, "23(a): the document's banded tier")
    require(cli_gap <= SHELL_U_RTOL, "23(a): the document's midside probe")
    require(launches["shell_roof_cli"] == dict(
        expected, dia_dir_matvec=cli_rounds, cg_update=cli_rounds),
        "23(a): the document's launches of the formula")
    require(pub_rel <= SHELL_TOL and pub_err <= SHELL_PUBLISHED_RTOL,
            f"23(a): the {m} x {m} roof's midside deflection within "
            f"{SHELL_PUBLISHED_RTOL} of {SHELL_PUBLISHED}")
    return launches, stats


def shellnl_strip():
    """The JAX package's banded Marguerre benchmark strip
    (benchmarks/scaling.py:676-718): the immovable pinned-edge von Karman
    strip, nu = 0, theta_x held, extruded ny elements long, span the fast
    numbering axis, under the pressure that puts w / t near 1.04; and the
    exact midspan deflection of the von Karman beam (the cosh closed form
    with the scalar membrane-force fixpoint)."""
    import numpy as np
    from scipy.optimize import brentq

    from pinn_fem_tpu_torch.models.shell import ShellProblem

    nx, ny = SHELLNL_STRIP
    span, young, t = 4.0, 2e5, 0.1
    d = young * t ** 3 / 12.0
    q = 3.0 * 0.15 * 384.0 * d / (5.0 * span ** 4)
    xs = np.linspace(0.0, span, nx + 1)
    nodes = np.array([[x, y, 0.0] for y in np.arange(ny + 1.0) for x in xs])
    na = nx + 1
    elems = np.asarray([[j * na + i, j * na + i + 1, j * na + i + 1 + na,
                         j * na + i + na]
                        for j in range(ny) for i in range(nx)])
    n = nodes.shape[0]
    fixed = []
    for nd in range(n):
        if nodes[nd, 0] in (0.0, span):
            fixed += [6 * nd + 0, 6 * nd + 1, 6 * nd + 2]
        fixed.append(6 * nd + 3)
    problem = ShellProblem(nodes=nodes, elements=elems, young=young,
                           poisson=0.0, thickness=t, density=1.0,
                           loads=np.zeros(6 * n),
                           fixed_dofs=np.array(sorted(set(fixed))),
                           pressure=-q)

    def resid(nf):
        kk = np.sqrt(nf / d)
        c = np.cosh(kk * span / 2.0)
        xg = np.linspace(-span / 2.0, span / 2.0, 4001)
        wp = (q / nf) * (np.sinh(kk * xg) / (kk * c) - xg)
        return nf - young * t / (2.0 * span) * np.trapezoid(wp ** 2, xg)

    nf = brentq(resid, 1e-3, 5e3, xtol=1e-12)
    kk = np.sqrt(nf / d)
    c = np.cosh(kk * span / 2.0)
    w_ex = abs((q / nf) * ((1.0 - c) / (kk ** 2 * c) + span ** 2 / 8.0))
    mid = 6 * (ny // 2 * na + nx // 2) + 2
    return problem, w_ex, mid, 5.0 * q * span ** 4 / (384.0 * d)


def shell_marguerre(dev, card: str):
    """23(b), 23(c) on its operator: solve_shell_nonlinear_banded on the
    strip in 4 load steps (the JAX row shellnl_banded_solve): converged,
    the midspan w within 3e-3 of the exact von Karman beam, the launches
    (kernel 1: 0; kernels 2 and 3: the sum over the run's PCG solves, one
    a Newton iteration, of 32 ceil(it / 32)); Newton iterations, ms a
    Newton iteration (warm) split into the block build, the DIA scatter,
    the PCG and the line search's force evaluations (each call
    synchronized in a second warm run), the block build's operations per
    second against the FP32 peak, the idle share."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.models import shell as SH
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import shell_nonlinear as SN

    problem, w_ex, mid, w_lin = shellnl_strip()
    lfs = np.asarray(SHELLNL_LOADS)
    t0 = time.perf_counter()
    layout = SH.shell_dia_layout(problem)
    layout_s = time.perf_counter() - t0

    def run():
        return SN.solve_shell_nonlinear_banded(problem, load_factors=lfs,
                                               device=dev)

    kernels.reset_launch_counts()
    with Timed(SN, "dia_cg_solve") as pcg_calls:
        cold_s, res = synced(run)
    launches = {"shellnl_api": kernels.launch_counts()}
    pcg_its = [int(c[1][1]) for c in pcg_calls]
    rounds = sum(32 * -(-it // 32) for it in pcg_its)
    expected = {"dia_matvec": 0, "dia_dir_matvec": rounds,
                "cg_update": rounds, "material_coefficients": 0,
                "material_coefficients_backward": 0}
    warm_s, _ = synced(run)
    with Timed(SN, "_tangent_blocks") as blocks, \
            Timed(SN, "assemble_dia_blocks") as scatter, \
            Timed(SN, "dia_cg_solve") as pcg, \
            Timed(SN, "_internal_force") as forces:
        split_s, _ = synced(run)
    idle = idle_profile(run)
    newton = int(res.iterations.sum())
    w_fe = abs(float(res.displacements[-1][mid]))
    exact_err = abs(w_fe - w_ex) / w_ex

    def per_call_ms(calls):
        return 1e3 * sum(c[0] for c in calls) / max(len(calls), 1)

    block_ms = per_call_ms(blocks)
    ops = MARGUERRE_OPS * problem.nelm
    split = {"block_build_ms": block_ms, "scatter_ms": per_call_ms(scatter),
             "pcg_ms": per_call_ms(pcg),
             "pcg_iterations": [int(c[1][1]) for c in pcg],
             "line_search_force_ms": per_call_ms(forces),
             "line_search_evaluations": len(forces),
             "synchronized_run_s": split_s}
    geo64 = SN._marguerre_geometry(problem, SH._DRILL_EPS_BANDED, dev)
    geo = tuple(a.float() for a in (geo64.bm, geo64.gw, geo64.g0,
                                    geo64.det, geo64.kb, geo64.kd,
                                    geo64.dm))
    u = torch.as_tensor(res.displacements[-1], dtype=torch.float32,
                        device=dev)
    ke, _ = SN._tangent_blocks(geo, u[geo64.dof_map])
    diags = SN.assemble_dia_blocks(layout, ke).contiguous()
    del ke, geo, geo64
    mask = torch.as_tensor(problem.free_mask(), dtype=torch.float32,
                           device=dev)
    stats = operator_kernels(layout, diags, mask, dev, card, "23(c)",
                             "the Marguerre strip",
                             "phase23c_marguerre_kernels", 231)
    log("phase23b_marguerre", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_diags=layout.n_diags,
        bandwidth=layout.bandwidth, layout_build_s=layout_s,
        load_factors=lfs.tolist(), converged=res.converged,
        newton_iterations=res.iterations.tolist(),
        residuals=res.residuals.tolist(), pcg_iterations=pcg_its,
        cold_s=cold_s, warm_s=warm_s,
        ms_per_newton_iteration=1e3 * warm_s / max(newton, 1),
        split=split, block_build_ops=ops,
        block_build_ops_per_s=ops / max(block_ms / 1e3, 1e-12),
        block_build_mfu=ops / max(block_ms / 1e3, 1e-12) / FLOPS,
        w_over_t=w_fe / 0.1, w_exact=w_ex, exact_err=exact_err,
        stiffening_vs_linear=w_fe / w_lin, solve_idle=idle,
        launches=launches, expected=expected)
    require(res.converged, "23(b): the banded Marguerre Newton converged")
    require(exact_err <= SHELLNL_EXACT_RTOL, "23(b): the midspan w within "
            f"{SHELLNL_EXACT_RTOL} of the exact von Karman beam")
    require(launches["shellnl_api"] == expected,
            "23(b): the launches of the formula")
    return launches, stats


def shell_sparse(problem):
    """(K, ridged M) of a shell problem as float64 scipy CSR matrices from
    the port's facet blocks on the CPU."""
    import numpy as np
    import scipy.sparse as sp

    from pinn_fem_tpu_torch.models import shell as SH

    dm = problem.dof_map()
    n = problem.ndof
    rows = np.repeat(dm[:, :, None], 24, 2).ravel()
    cols = np.repeat(dm[:, None, :], 24, 1).ravel()
    mats = [sp.csr_matrix((b(problem, "cpu").numpy().ravel(), (rows, cols)),
                          shape=(n, n))
            for b in (SH._stiffness_blocks, SH._mass_blocks)]
    k, m = mats
    return k, m + SH._MASS_RIDGE * m.diagonal().max() * sp.eye(n)


def shell_dense(workdir: Path, dev, card: str) -> dict:
    """23(d): the dense float64 shell analyses on the card against the
    port's CPU run at 1e-10: on the 17 x 17 roof (1,944 DOFs) statics,
    modal (shapes by cluster spans), buckling under its own membrane state,
    Guyan reduction and a random document with fatigue through main() (its
    PSDs, |X|^2, at 2e-10, its damage rates and lives, stress^3, at
    3e-10); a cylindrical panel's spectrum document
    (`shell_panel_document`); dyn-shell.json, dyn-shell-snap.json (Riks
    through both folds) and dyn-shell-plastic.json (the float64 tier, at
    its Newton tolerance 1e-9) through main(); on the 35 x 35 roof (7,776 DOFs) Newmark and a harmonic sweep
    against scipy.sparse float64 replays at 1e-9; a strip of the plastic
    document refined above DENSE_DOF_LIMIT through main() on the float32
    tier beside the float64 tier on the card (its residuals recorded, as
    22(c) did); wall and peak memory of each card run.  No repo kernel."""
    import numpy as np
    import scipy.sparse.linalg as spl
    import torch

    from pinn_fem_tpu_torch.cli.generic import main
    from pinn_fem_tpu_torch.io.shell_io import (parse_shell_document,
                                                run_shell_document)
    from pinn_fem_tpu_torch.models import shell as SH
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import newton
    from pinn_fem_tpu_torch.solvers import shell_plasticity as SPL
    from pinn_fem_tpu_torch.solvers.plane_plasticity import float64_loop
    from pinn_fem_tpu_torch.ops.plastic import params_arrays

    report, gates = {}, []

    def rel(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    def on_card(label, fn):
        s, gb, out = peak_run(dev, fn)
        report[label] = {"s": s, "peak_gb": gb}
        return out

    def gate(label, gap, bound, what="gap"):
        report[label][what] = gap
        gates.append((gap <= bound, f"23(d) {label} {what}"))

    n = SHELL_DENSE_ROOF
    mid = midside(n)
    problem = parse_shell_document(shell_roof_document(n))[0]
    free = problem.free_dofs()
    kernels.reset_launch_counts()
    g = on_card("static", lambda: SH.solve_shell_static(problem, device=dev))
    c = SH.solve_shell_static(problem, device="cpu")
    gate("static", max(rel(getattr(g, k), getattr(c, k)) for k in (
        "displacements", "membrane_forces", "moments", "reactions")),
        SHELL_DENSE_RTOL)
    k, m = (a.numpy() for a in SH.shell_matrices(problem, device="cpu"))
    mf = SH._ridged(torch.as_tensor(m))[free][:, free].numpy()
    g = on_card("modal", lambda: SH.shell_modal(problem, 6, device=dev))
    c = SH.shell_modal(problem, 6, device="cpu")
    gate("modal", rel(g.eigenvalues, c.eigenvalues), SHELL_DENSE_RTOL,
         "eig_gap")
    gate("modal", cluster_gap(c.eigenvalues, g.mode_shapes[:, free],
                              c.mode_shapes[:, free], mf),
         SHELL_SHAPE_ATOL, "shape_gap")
    report["modal"]["frequencies_hz"] = g.frequencies_hz.tolist()
    g = on_card("buckling", lambda: SH.shell_buckling(problem, n_modes=3,
                                                      device=dev))
    c = SH.shell_buckling(problem, n_modes=3, device="cpu")
    gate("buckling", rel(g.load_factors, c.load_factors), SHELL_DENSE_RTOL)
    gate("buckling", cluster_gap(c.load_factors, g.modes[:, free],
                                 c.modes[:, free], k[free][:, free]),
         SHELL_SHAPE_ATOL, "shape_gap")
    report["buckling"]["load_factors"] = g.load_factors.tolist()
    docs = {
        "reduction": shell_roof_document(
            n, type="reduction", method="guyan",
            master_nodes=[mid, mid - 2, mid - n - 1]),
        "spectrum": shell_panel_document(
            type="spectrum", n_modes=4, combination="cqc",
            direction=[0.3, 1.0, -0.2],
            sa={"omegas": [0.0, 200.0], "values": [3.0, 1.0]}),
        "random": shell_roof_document(
            n, type="random", psd=1.0, probe_nodes=[mid],
            omegas={"start": 5.0, "stop": 60.0, "num": 12},
            damping=[2.0, 5e-4], probe_elements=[0, n // 2, n * n - 1],
            fatigue={"sn": {"exponent": 3.0, "coefficient": 1e15},
                     "method": "dirlik", "duration": 60.0}),
    }
    for name in ("dyn-shell", "dyn-shell-snap", "dyn-shell-plastic"):
        docs[name] = json.loads((ROOT / "examples" / "json"
                                 / f"{name}.json").read_text())
    os.environ["PINN_FEM_TORCH_DEVICE"] = DEVICE
    for name, doc in docs.items():
        path = workdir / f"shell-{name}.json"
        path.write_text(json.dumps(doc))
        rc = on_card(name, lambda: main([str(path)]))
        gates.append((rc == 0, f"23(d) {name}: exit code 0"))
        got = json.loads(path.with_suffix(".res.json").read_text())
        want = json.loads(json.dumps(run_shell_document(
            json.loads(json.dumps(doc)), "cpu")))
        if name == "dyn-shell-plastic":
            gate(name, rel(got["final"].pop("eq_plastic_strain"),
                           want["final"].pop("eq_plastic_strain")),
                 SHELL_PLASTIC_RTOL, "eq_plastic_gap")
        if "max_displacement_dof" in want:
            # The symmetric roof's two free edges tie for the largest |u|:
            # the card's pick must hold that largest value.
            pick = got.pop("max_displacement_dof")
            want.pop("max_displacement_dof")
            gate(name, abs(abs(want["displacements"][pick])
                           - want["max_displacement"])
                 / want["max_displacement"], SHELL_DENSE_RTOL, "max_pick")
        gaps = tree_gaps(got, want)
        if name == "reduction":
            # Ratios of nearly equal frequencies: held absolutely.
            gate(name, max(abs(a - b) for a, b in zip(
                got["frequency_rel_errors"], want["frequency_rel_errors"])),
                SHELL_DENSE_RTOL, "frequency_rel_errors_gap")
            gaps.pop("/frequency_rel_errors")
        if name == "random":
            # A PSD is |X|^2 S and a Basquin damage rate the stress to the
            # S-N exponent 3: 2 and 3 times the response's relative gap.
            for key, power in (("/psd", 2), ("/fatigue/damage_rate", 3),
                               ("/fatigue/life_s", 3)):
                gate(name, gaps.pop(key), power * SHELL_DENSE_RTOL,
                     key.rsplit("/", 1)[1] + "_gap")
        worst = max(gaps, key=gaps.get)
        report[name].update(worst=worst)
        # The plastic runs each stop at |r| / |f| <= 1e-9.
        gate(name, gaps[worst], SHELL_PLASTIC_RTOL
             if name == "dyn-shell-plastic" else SHELL_DENSE_RTOL)

    n = SHELL_DYN_ROOF
    mid = midside(n)
    problem = parse_shell_document(shell_roof_document(n))[0]
    free = problem.free_dofs()
    ks, ms = shell_sparse(problem)
    kf, mf = ks[free][:, free].tocsc(), ms[free][:, free].tocsc()
    om1 = float(np.sqrt(spl.eigsh(kf, k=1, M=mf, sigma=0.0, which="LM",
                                  return_eigenvectors=False)[0]))
    damping = (0.02 * om1, 0.02 / om1)
    cf = (damping[0] * mf + damping[1] * kf).tocsc()
    f = SH._static_loads(problem, "cpu").numpy()
    probe = [6 * mid + 2, 6 * (mid - 1) + 2]
    dt = 2.0 * np.pi / om1 / 40.0
    amp = np.sin(0.5 * om1 * dt * np.arange(SHELL_NEWMARK_STEPS))
    g = on_card("newmark", lambda: SH.solve_shell_transient(
        problem, dt, SHELL_NEWMARK_STEPS, damping=damping, amplitude=amp,
        probe_dofs=probe, record_every=1, device=dev))
    report["newmark"]["ndof"] = problem.ndof
    gate("newmark", rel(g.displacements, newmark_replay(
        kf, mf, cf, f[free], free, problem.ndof, dt, amp, probe, every=1)),
        SHELL_DYN_RTOL)
    om = np.linspace(0.3 * om1, 3.0 * om1, SHELL_HARMONIC_FREQS)
    g = on_card("harmonic", lambda: SH.shell_harmonic(
        problem, om, damping=damping, probe_dofs=probe, device=dev))
    gate("harmonic", rel(g.amplitude, harmonic_replay(
        kf, mf, cf, f[free], om, np.searchsorted(free, probe))),
        SHELL_DYN_RTOL)
    report["harmonic"]["ms_per_frequency"] = \
        1e3 * report["harmonic"]["s"] / om.size

    doc = shell_plastic_strip_document()
    fine = parse_shell_document(doc)[0]
    path = workdir / "shell_plastic_fine.json"
    path.write_text(json.dumps(doc))
    rc = on_card("plastic_float32", lambda: main([str(path)]))
    out = json.loads(path.with_suffix(".res.json").read_text())
    an = doc["analysis"]
    sy, hi, hk = params_arrays(fine.nelm, an["sigma_y"])
    lfs = np.asarray(an["load_factors"], dtype=float)
    system = SPL._ShellSystem(fine, sy, hi, hk, an["n_layers"], 1e-8,
                              torch.float64, dev)
    f64 = on_card("plastic_float64", lambda: SPL._result(
        lfs, *float64_loop(system, lfs, 1e-9, 30, 1e-12)))
    probe = np.asarray(out["probe_dofs"])
    u32 = np.asarray(out["displacements"], dtype=float)
    u64 = f64.displacements[:, probe]
    report["plastic_float32"].update(
        ndof=fine.ndof, dense_limit=newton.DENSE_DOF_LIMIT,
        success=out["success"], iterations=out["iterations"],
        max_residual=out["max_residual"], n_plastic=out["n_plastic"],
        probe_gap_vs_float64_by_step=(np.abs(u32 - u64).max(axis=1)
                                      / np.abs(u64).max(axis=1)).tolist())
    report["plastic_float64"].update(
        iterations=f64.iterations.tolist(),
        residuals=f64.residuals.tolist(), n_plastic=f64.n_plastic.tolist())
    gates += [(rc == 0, "23(d) refined plastic strip: exit code 0"),
              (fine.ndof > newton.DENSE_DOF_LIMIT,
               "23(d) refined plastic strip: the float32 tier"),
              (f64.converged, "23(d) refined plastic strip: float64 "
               "converged")]
    launches = kernels.launch_counts()
    report["launches"] = launches
    log("phase23d_dense", card=card, **report)
    for ok, what in gates:
        require(ok, what)
    require(zero_launches(launches), "23(d): no repo kernel")
    return launches


def shell_panel_document(**analysis) -> dict:
    """A 40-degree cylindrical panel (R 25, L 40, t 2, 8 x 6 facets)
    cantilevered from its y = 0 edge under self-weight and a normal
    pressure, the global theta_z held at every node: the JAX package's
    spectrum refuses a shell whose drilling rotations are free (ROADMAP
    fault 3.33)."""
    return {"element_type": "shell",
            "mesh": {"type": "cylinder_panel", "radius": 25.0,
                     "length": 40.0, "half_angle_deg": 40.0, "nx": 8,
                     "ny": 6},
            "material": {"young": 4.32e8, "poisson": 0.2, "thickness": 2.0,
                         "density": 2.0},
            "supports": [{"nodes": "y_min", "dofs": [0, 1, 2, 3, 4, 5]},
                         {"nodes": list(range(63)), "dofs": [5]}],
            "body_force": [0.0, 0.0, -90.0], "pressure": 20.0,
            "analysis": analysis}


def shell_plastic_strip_document() -> dict:
    """dyn-shell-plastic.json's clamped strip (4 x 1, E 2e5, t 0.1, sigma_y
    300, 20 layers) meshed SHELL_PLASTIC_STRIP, its axial force and end
    moment spread over the right edge's nodes: above DENSE_DOF_LIMIT."""
    import numpy as np

    doc = json.loads((ROOT / "examples" / "json" / "dyn-shell-plastic.json")
                     .read_text())
    nx, ny = SHELL_PLASTIC_STRIP
    xs, ys = np.linspace(0.0, 4.0, nx + 1), np.linspace(0.0, 1.0, ny + 1)
    doc["nodes"] = [[x, y, 0.0] for y in ys for x in xs]
    na = nx + 1
    doc["elements"] = [[j * na + i, j * na + i + 1, j * na + i + 1 + na,
                        j * na + i + na] for j in range(ny) for i in range(nx)]
    right = [j * na + nx for j in range(ny + 1)]
    w = np.full(ny + 1, 1.0 / ny)
    w[[0, -1]] = 0.5 / ny                   # the edge's tributary widths
    doc["point_loads"] = [[nd, 0, 15.0 * wi] for nd, wi in zip(right, w)] \
        + [[nd, 4, -0.5625 * wi] for nd, wi in zip(right, w)]
    doc["analysis"]["probe_nodes"] = [right[ny // 2]]
    return doc


def shell_refusals(workdir: Path, dev, card: str) -> None:
    """23(e): bare shell "sizing" and "reliability" documents (ported in
    phase 25) and an identification document without a measurement
    through the CLI's run(), and shell modal and buckling above
    DENSE_DOF_LIMIT (the JAX package's ValueErrors), each refused before
    any launch."""
    from pinn_fem_tpu_torch.cli.generic import run
    from pinn_fem_tpu_torch.io.shell_io import run_shell_document
    from pinn_fem_tpu_torch.ops import kernels

    calls = {}
    for kind, (exc, text) in (
            ("identification", (ValueError, 'needs "measured_dofs"')),
            ("sizing", (ValueError, 'shell sizing needs "stress_limit"')),
            ("reliability", (ValueError, "needs at least one random"))):
        path = workdir / f"shell-{kind}.json"
        path.write_text(json.dumps(shell_roof_document(4, type=kind)))
        calls[kind] = (lambda path=path: run(str(path), device=dev), exc,
                       text)
    for kind in ("modal", "buckling"):
        calls[f"{kind}_above_limit"] = (
            lambda kind=kind: run_shell_document(
                shell_roof_document(24, type=kind), dev),
            ValueError, f"shell {kind} is dense-host-only")
    refused = {}
    kernels.reset_launch_counts()
    for name, (call, kind, text) in calls.items():
        try:
            call()
            refused[name] = None
        except kind as e:
            refused[name] = str(e)
            require(text in str(e), f"23(e) {name}: the message names "
                    f"{text}")
    launches = kernels.launch_counts()
    log("phase23e_refusals", card=card, refused=refused, launches=launches)
    for name, msg in refused.items():
        require(msg is not None, f"23(e): {name} refused")
    require(zero_launches(launches), "23(e): no launch before refusal")


def phase_shell(workdir: Path, dev, card: str) -> dict:
    """Phase 23: the flat-facet shell family on the card.  Returns the
    kernels' launches on each of its paths and the kernels' figures on the
    roof's and the Marguerre strip's operators."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches, roof_stats = shell_roof(workdir, dev, card)
    lap("a")
    nl_launches, nl_stats = shell_marguerre(dev, card)
    launches.update(nl_launches)
    lap("b")
    launches["dense"] = shell_dense(workdir, dev, card)
    lap("d")
    shell_refusals(workdir, dev, card)
    lap("e")
    log("phase23_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches, "roof": roof_stats, "marguerre": nl_stats}


# Phase 24: identification on the card (ROADMAP item 23).  24(a): the 128
# x 512 plane strip (PLANE_STRIP, 132,354 DOFs) with dyn-plane-identify's
# contract: zones y < 2 and y >= 2, twin data [800, 1400] from the banded
# tier at IDENT_TOL / 100, a start at E = 1000, lr 0.2, tol 1e-8, probes
# every 11th non-zero DOF (tests/test_plane.py), IDENT_ITERS ADAM
# iterations; gates: the zones within IDENT_ZONE_RTOL of the truth, the
# first zone gradient within IDENT_GRAD_RTOL (max-normalized) of the same
# loss in float64 on the card through the plain PCG (dia_cg_solve_reference
# at IDENT_F64_TOL), that float64 gradient within IDENT_FD_RTOL of a
# central difference of the float64 loss (step IDENT_FD_STEP in log E),
# and the launches: kernel 1 once (the twin-data solve's reactions: the
# fused PCG starts from x0 = 0 and launches no stencil for r0, so an ADAM
# iteration's forward and adjoint solves launch kernel 1 no time),
# kernels 2 and 3 the sum of 32 ceil(it / 32) over every fused solve.
# 24(b): per-element log-E (65,536 parameters) and field=True, IDENT_B_ITERS
# iterations each, the first gradient within IDENT_B_GRAD_RTOL of the
# float64 twin's.  24(c): the 84k solid column (SOLID_COLUMN) gated as
# 24(a); the plate slab (PLATE_SLAB) and the 32 x 32 Scordelis-Lo roof
# at full width (launches, the loss rows); the card against the port's
# CPU run of the same case on IDENT_PLATE_SMALL / IDENT_SHELL_SMALL
# documents (the full-width cases take minutes on the CPU).  24(d): the
# seven identification documents, n_iter cut to IDENT_DOC_ITERS, against
# the port's CPU run of the same cut document (IDENT_DOC_RTOL; the
# time-domain ones cut to IDENT_TRANSIENT_DOC_ITERS).  24(e):
# refusals before any launch.
IDENT_TOL = 1e-8
IDENT_LR = 0.2
IDENT_ZONE_YOUNG = (800.0, 1400.0)
IDENT_START = 1000.0
IDENT_PROBE_STRIDE = 11
IDENT_ITERS = 120
IDENT_FALL = 1e-3
IDENT_TIMED_ITERS = 4
# The strip's zones and first gradient at its float32 floor (ROADMAP
# fault 3.38, tools/measure_identification_floor.py: the model at the true
# moduli 1.28e-2 of max |u| from its own twin data at 128 x 512 on the
# card; measured there, NVIDIA H100 80GB HBM3 at 700 W: the zones 1.8e-2
# from the truth after 120 iterations, the first gradient 8.2e-3 from the
# float64 twin); the JAX test's 5e-3 and the 1e-3 gradient bound hold on
# the column (6.8e-4, 3.2e-4 on that card).
IDENT_ZONE_RTOL = 3e-2
IDENT_GRAD_RTOL = 2e-2
IDENT_SOLID_ZONE_RTOL = 5e-3
IDENT_SOLID_GRAD_RTOL = 1e-3
IDENT_FD_RTOL = 1e-5
IDENT_FD_STEP = 1e-3
IDENT_F64_TOL = 1e-12
IDENT_F64_MAX_ITER = 200000
IDENT_B_ITERS = 5
IDENT_B_GRAD_RTOL = 2e-2
IDENT_SOLID_ZONE_YOUNG = (150.0, 250.0)
IDENT_SOLID_TOL = 1e-9
IDENT_SOLID_ITERS = 150
IDENT_PLATE_ITERS = 20
IDENT_PLATE_ZONE_YOUNG = (1.2e11, 2.4e11)
IDENT_SHELL = 32
IDENT_SHELL_ITERS = 10
IDENT_SHELL_ZONE_YOUNG = (3.6e8, 5.2e8)
IDENT_PLATE_SMALL = 24
IDENT_SHELL_SMALL = 8
IDENT_CASE_RTOL = 5e-2
IDENT_DOC_ITERS = 50
# The truss time-domain documents' step loops run ~13 torch operations a
# step forward (~600 steps, twice that backward): 0.53-0.77 s an ADAM
# iteration on an NVIDIA H100 80GB HBM3 at 700 W (launch-bound, ROADMAP
# item 9), so they take 10.
IDENT_TRANSIENT_DOC_ITERS = 10
IDENT_DOC_RTOL = 5e-2
IDENT_DOCUMENTS = ("dyn-identification", "dyn-identification-modal",
                   "dyn-identification-frf", "dyn-identification-field",
                   "dyn-plane-identify", "dyn-plate-identify",
                   "dyn-frame-identify")


class PcgTally:
    """Records the iterations of every ops.dia.dia_cg_solve call (one int
    a call) while in the with block."""

    def __init__(self):
        from pinn_fem_tpu_torch.ops import dia

        self.module, self.inner, self.iterations = dia, dia.dia_cg_solve, []

    def __enter__(self):
        def tally(*args, **kwargs):
            res = self.inner(*args, **kwargs)
            self.iterations.append(int(res[1]))
            return res

        self.module.dia_cg_solve = tally
        return self.iterations

    def __exit__(self, *exc):
        self.module.dia_cg_solve = self.inner


class FirstGradient:
    """Keeps a copy of the gradients of solvers/banded_inverse's first
    value_and_grad call while in the with block."""

    def __init__(self):
        from pinn_fem_tpu_torch.solvers import banded_inverse

        self.module = banded_inverse
        self.inner, self.grads = banded_inverse.value_and_grad, []

    def __enter__(self):
        def first(loss_fn, params):
            loss, grads = self.inner(loss_fn, params)
            if not self.grads:
                self.grads.extend(g.detach().clone() for g in grads)
            return loss, grads

        self.module.value_and_grad = first
        return self.grads

    def __exit__(self, *exc):
        self.module.value_and_grad = self.inner


class PlainPcg:
    """ops.dia.dia_cg_solve replaced by the plain Jacobi-PCG recurrence of
    dia_cg_solve_reference while in the with block (the masked system of
    ops.dia._masked_system, ops/cg.pcg_flagged's device loop), its matvec
    a float64 CSR product of the diagonals: the float64 twin of an
    identification loss on the card, ~4x faster than the twin's
    diagonal-by-diagonal matvec at 132k DOFs."""

    def __enter__(self):
        import torch

        from pinn_fem_tpu_torch.ops import dia
        from pinn_fem_tpu_torch.ops.cg import pcg_flagged

        self.module, self.inner = dia, dia.dia_cg_solve

        def plain(layout, diags, rhs, mask, tol=1e-6, max_iter=100000,
                  x0=None, precond="jacobi", components=1):
            k = csr_of(layout, diags)
            a_op, b, x, b_norm, tol_b = dia._masked_system(
                layout, diags, rhs, mask, tol, x0,
                lambda _layout, _diags, v: k @ v)
            inv = 1.0 / (dia.dia_diagonal(layout, diags) * mask
                         + (1.0 - mask))
            x, it, r = pcg_flagged(a_op, lambda v: inv * v, b, x, tol_b,
                                   max_iter)
            return x * mask, it, torch.linalg.vector_norm(r) / b_norm

        dia.dia_cg_solve = plain

    def __exit__(self, *exc):
        self.module.dia_cg_solve = self.inner


def fused_rounds(iterations) -> int:
    from pinn_fem_tpu_torch.ops.kernels import cg_kernel

    every = cg_kernel.CHECK_EVERY
    return sum(every * -(-int(it) // every) for it in iterations)


def banded_launches(iterations, reactions: int = 1) -> dict:
    rounds = fused_rounds(iterations)
    return {"dia_matvec": reactions, "dia_dir_matvec": rounds,
            "cg_update": rounds, "material_coefficients": 0,
            "material_coefficients_backward": 0}


def max_rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def zones_of(cent, axis: int, cut: float):
    import numpy as np

    return [np.flatnonzero(cent[:, axis] < cut),
            np.flatnonzero(cent[:, axis] >= cut)]


def float64_twin(layout, blocks_of, base_young, centroids, f, mask, probe,
                 meas, dev, zones=None, field=False, input_dim=2):
    """(loss(params), params0): the identification loss in float64 on the
    card, the parameterization of solvers/banded_inverse at the same
    start; evaluate and differentiate it under PlainPcg (the plain PCG
    on the forward and the adjoint)."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.ops.dia import (assemble_dia_blocks,
                                            dia_solve_diff)
    from pinn_fem_tpu_torch.solvers import banded_inverse as BI

    f64 = torch.float64
    idx, meas64, scale = BI.measurement(probe, meas, f64, dev)
    f = torch.as_tensor(np.asarray(f, float), dtype=f64, device=dev)
    mask = torch.as_tensor(np.asarray(mask, float), dtype=f64, device=dev)
    params, young_of, field_of = BI.young_parameterization(
        base_young, centroids, zones, field, 0, 2, 16, input_dim,
        torch.float32, dev)
    if field:
        # The float32 start's weights in float64 (a float64 draw from the
        # same key gives other numbers).
        net = field_of(params).to(dev, f64)
        cent = torch.as_tensor(np.asarray(centroids, float), dtype=f64,
                               device=dev)
        params = net.trainable_params() + [net.scale]

        def young_of(ps):
            return net.replace(layers=list(zip(ps[:-1:2], ps[1:-1:2])),
                               scale=ps[-1]).eval_batch(cent)
    else:
        params, young_of, _ = BI.young_parameterization(
            base_young, centroids, zones, False, 0, 2, 16, input_dim, f64,
            dev)

    def loss(ps):
        diags = assemble_dia_blocks(layout, blocks_of(young_of(ps)))
        u = dia_solve_diff(layout, diags, f, mask, tol=IDENT_F64_TOL,
                           max_iter=IDENT_F64_MAX_ITER)
        return torch.mean((u[idx] - meas64) ** 2) / scale

    return loss, params


def twin_gradient(loss64, params64):
    """(loss, flat gradient, seconds) of a float64 twin under PlainPcg."""
    import torch

    from pinn_fem_tpu_torch.solvers import banded_inverse as BI

    t0 = time.perf_counter()
    with PlainPcg():
        loss0, g64 = BI.value_and_grad(loss64, params64)
    g64 = torch.cat([g.reshape(-1) for g in g64]).cpu().numpy()
    return float(loss0), g64, time.perf_counter() - t0


def gradient_check(loss64, params64, g32, fd: bool) -> dict:
    """The float32 card gradient against the float64 twin's (max-
    normalized), and the twin's against a central difference of its loss
    in each parameter (zones only)."""
    import numpy as np
    import torch

    loss0, g64, twin_s = twin_gradient(loss64, params64)
    g32 = torch.cat([g.reshape(-1) for g in g32]).double().cpu().numpy()
    out = {"loss64": loss0, "twin_s": twin_s,
           "grad_gap": max_rel(g32, g64), "grad32_head": g32[:4].tolist(),
           "grad64_head": g64[:4].tolist()}
    if fd:
        h = IDENT_FD_STEP
        fd_g = []
        with torch.no_grad(), PlainPcg():
            for k in range(g64.size):
                step = torch.zeros_like(params64[0])
                step.view(-1)[k] = h
                up = float(loss64([params64[0] + step]))
                down = float(loss64([params64[0] - step]))
                fd_g.append((up - down) / (2.0 * h))
        out["fd_grad"] = fd_g
        out["fd_gap"] = max_rel(g64, np.asarray(fd_g))
    return out


def twin_probes(u, stride: int):
    import numpy as np

    probe = np.arange(u.size)[np.abs(u) > 1e-12][::stride]
    return probe, u[probe]


def ident_identify(fn, *args, **kwargs):
    """(wall s, (young, hist, field), PCG iterations, first gradients,
    launches, peak GiB) of one identification run on the card."""
    import torch

    from pinn_fem_tpu_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with PcgTally() as its, FirstGradient() as grads:
        wall, res = synced(lambda: fn(*args, **kwargs))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return wall, res, list(its), grads, kernels.launch_counts(), peak


def timed_split(fn, *args, **kwargs) -> dict:
    """ms an ADAM iteration split into its parts, over IDENT_TIMED_ITERS
    iterations of fn (each part synchronized, so the total runs a little
    slower than the untimed loop)."""
    from pinn_fem_tpu_torch.models import plane as TP
    from pinn_fem_tpu_torch.ops import dia
    from pinn_fem_tpu_torch.solvers import banded_inverse as BI

    n = IDENT_TIMED_ITERS
    with Timed(TP, "_k_blocks") as blocks, \
            Timed(BI, "assemble_dia_blocks") as scatter, \
            Timed(dia, "dia_cg_solve") as pcg, \
            Timed(dia, "dia_diags_grad") as dgrad, \
            Timed(BI, "adam_step") as adam, \
            Timed(BI, "value_and_grad") as total:
        fn(*args, n_iter=n, **kwargs)

    def ms(calls):
        return 1e3 * sum(s for s, _ in calls) / n

    parts = {"block_build": ms(blocks), "scatter": ms(scatter),
             "forward_pcg": ms(pcg[0::2]), "adjoint_pcg": ms(pcg[1::2]),
             "diags_grad": ms(dgrad), "adam": ms(adam),
             "loss_and_gradient": ms(total)}
    parts["gather_back_and_rest"] = (
        parts["loss_and_gradient"] - parts["block_build"] - parts["scatter"]
        - parts["forward_pcg"] - parts["adjoint_pcg"] - parts["diags_grad"])
    parts["forward_iterations"] = [int(r[1]) for _, r in pcg[0::2]]
    parts["adjoint_iterations"] = [int(r[1]) for _, r in pcg[1::2]]
    return parts


def ident_strip(dev, card: str) -> dict:
    """24(a) and 24(b) on the 128 x 512 strip."""
    import dataclasses

    import numpy as np

    from pinn_fem_tpu_torch.models import plane as TP

    problem = dataclasses.replace(plane_strip_problem(), young=IDENT_START)
    cent = problem.coords().mean(axis=1)
    zones = zones_of(cent, 1, 2.0)
    true = np.where(cent[:, 1] < 2.0, *IDENT_ZONE_YOUNG)
    layout = TP.plane_dia_layout(problem)
    from pinn_fem_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    with PcgTally() as twin_its:
        twin_s, (r, _, _) = synced(lambda: TP.solve_plane_static_banded(
            dataclasses.replace(problem, young=true), tol=IDENT_TOL * 0.01,
            device=dev))
    twin_launches = kernels.launch_counts()
    probe, meas = twin_probes(r.displacements, IDENT_PROBE_STRIDE)
    opts = dict(learning_rate=IDENT_LR, tol=IDENT_TOL, device=dev)
    wall, (young, hist, _), its, grads, launches, peak = ident_identify(
        TP.identify_plane_young_banded, problem, probe, meas, zones=zones,
        n_iter=IDENT_ITERS, **opts)
    zone_young = [float(young[z].mean()) for z in zones]
    zone_err = max(abs(z - t) / t for z, t in zip(zone_young,
                                                   IDENT_ZONE_YOUNG))
    fallen = np.flatnonzero(hist <= IDENT_FALL * hist[0])
    split = timed_split(TP.identify_plane_young_banded, problem, probe,
                        meas, zones=zones, **opts)
    idle = idle_profile(lambda: TP.identify_plane_young_banded(
        problem, probe, meas, zones=zones, n_iter=2, **opts))
    f = TP._identification_loads(problem)
    blocks_of = TP._young_blocks_of(problem, dev)
    twin = dict(layout=layout, blocks_of=blocks_of,
                base_young=problem.young, centroids=cent, f=f,
                mask=problem.free_mask(), probe=probe, meas=meas, dev=dev)
    grad = gradient_check(*float64_twin(zones=zones, **twin), grads, fd=True)
    expected = banded_launches(its, 0)
    twin_expected = banded_launches(twin_its, 1)
    log("phase24a_strip", card=card, ndof=problem.ndof,
        elements=problem.nelm, n_diags=layout.n_diags, probes=probe.size,
        twin_s=twin_s, twin_iterations=twin_its, iterations=IDENT_ITERS,
        wall_s=wall, ms_per_iteration=1e3 * wall / IDENT_ITERS,
        loss_first=float(hist[0]), loss_last=float(hist[-1]),
        fell_1e3_at=int(fallen[0]) + 1 if fallen.size else None,
        zone_young=zone_young, zone_rel_err=zone_err,
        forward_iterations=its[0::2][:8], adjoint_iterations=its[1::2][:8],
        pcg_iterations_total=sum(its), split_ms=split, idle=idle,
        peak_gib=peak, gradient=grad, launches=launches,
        expected=expected, twin_launches=twin_launches,
        twin_expected=twin_expected)
    require(zone_err <= IDENT_ZONE_RTOL, f"24(a): zones within "
            f"{IDENT_ZONE_RTOL} of {IDENT_ZONE_YOUNG}")
    require(fallen.size > 0, "24(a): the loss falls 1e3-fold")
    require(grad["grad_gap"] <= IDENT_GRAD_RTOL, "24(a): the first zone "
            f"gradient within {IDENT_GRAD_RTOL} of the float64 twin")
    require(grad["fd_gap"] <= IDENT_FD_RTOL, "24(a): the float64 gradient "
            f"within {IDENT_FD_RTOL} of its central difference")
    require(launches == expected and twin_launches == twin_expected,
            "24(a): the launches of the formula")
    total = {k: launches[k] + twin_launches[k] for k in launches}

    out = {"strip_zones": total}
    for label, mode in (("per_element", {}), ("field", {"field": True})):
        wall_b, (_, hist_b, _), its_b, grads_b, launches_b, peak_b = \
            ident_identify(TP.identify_plane_young_banded, problem, probe,
                           meas, n_iter=IDENT_B_ITERS, **mode, **opts)
        loss64, p64 = float64_twin(layout, blocks_of, problem.young, cent,
                                   f, problem.free_mask(), probe, meas, dev,
                                   field=bool(mode))
        grad_b = gradient_check(loss64, p64, grads_b, fd=False)
        expected_b = banded_launches(its_b, 0)
        log("phase24b_" + label, card=card,
            parameters=int(sum(g.numel() for g in grads_b)),
            wall_s=wall_b, ms_per_iteration=1e3 * wall_b / IDENT_B_ITERS,
            loss=hist_b.tolist(), forward_iterations=its_b[0::2],
            adjoint_iterations=its_b[1::2], peak_gib=peak_b,
            gradient=grad_b, launches=launches_b, expected=expected_b)
        require(grad_b["grad_gap"] <= IDENT_B_GRAD_RTOL,
                f"24(b): the {label} gradient within {IDENT_B_GRAD_RTOL} "
                "of the float64 twin")
        require(launches_b == expected_b, f"24(b): the {label} launches")
        out["strip_" + label] = launches_b
    return out


def ident_solid(dev, card: str) -> dict:
    """24(c), solid: the 84k column with two zones along z, gated as
    24(a)."""
    import dataclasses

    import numpy as np

    from pinn_fem_tpu_torch.models import solid as TSo
    from pinn_fem_tpu_torch.ops import kernels

    problem = solid_column(*SOLID_COLUMN)[0]
    cent = problem.coords().mean(axis=1)
    zones = zones_of(cent, 2, 2.0)
    true = np.where(cent[:, 2] < 2.0, *IDENT_SOLID_ZONE_YOUNG)
    kernels.reset_launch_counts()
    with PcgTally() as twin_its:
        twin_s, (r, _, _) = synced(lambda: TSo.solve_solid_static_banded(
            dataclasses.replace(problem, young=true),
            tol=IDENT_SOLID_TOL * 0.1, device=dev))
    twin_launches = kernels.launch_counts()
    probe, meas = twin_probes(r.displacements, 5)
    wall, (young, hist, _), its, grads, launches, peak = ident_identify(
        TSo.identify_solid_young_banded, problem, probe, meas, zones=zones,
        n_iter=IDENT_SOLID_ITERS, learning_rate=IDENT_LR,
        tol=IDENT_SOLID_TOL, device=dev)
    zone_young = [float(young[z].mean()) for z in zones]
    zone_err = max(abs(z - t) / t for z, t in zip(
        zone_young, IDENT_SOLID_ZONE_YOUNG))
    fallen = np.flatnonzero(hist <= IDENT_FALL * hist[0])
    coords = TSo._elements(problem, dev)[0]
    (nu,) = TSo._material(problem, dev, "poisson")

    def blocks_of(young_e):
        return TSo._k_blocks3(coords, TSo._dmat3(young_e, nu))

    f = problem.loads + TSo._body_force_vectors3(problem).numpy()
    loss64, p64 = float64_twin(TSo.solid_dia_layout(problem), blocks_of,
                               problem.young, cent, f, problem.free_mask(),
                               probe, meas, dev, zones=zones, input_dim=3)
    grad = gradient_check(loss64, p64, grads, fd=True)
    expected = banded_launches(its, 0)
    twin_expected = banded_launches(twin_its, 1)
    log("phase24c_solid", card=card, ndof=problem.ndof,
        elements=problem.nelm, probes=probe.size, twin_s=twin_s,
        twin_iterations=twin_its, wall_s=wall,
        ms_per_iteration=1e3 * wall / IDENT_SOLID_ITERS,
        loss_first=float(hist[0]), loss_last=float(hist[-1]),
        fell_1e3_at=int(fallen[0]) + 1 if fallen.size else None,
        zone_young=zone_young, zone_rel_err=zone_err,
        forward_iterations=its[0::2][:8], adjoint_iterations=its[1::2][:8],
        peak_gib=peak, gradient=grad, launches=launches, expected=expected,
        twin_launches=twin_launches, twin_expected=twin_expected)
    require(zone_err <= IDENT_SOLID_ZONE_RTOL, "24(c): the column's zones "
            f"within {IDENT_SOLID_ZONE_RTOL} of {IDENT_SOLID_ZONE_YOUNG}")
    require(fallen.size > 0, "24(c): the column's loss falls 1e3-fold")
    require(grad["grad_gap"] <= IDENT_SOLID_GRAD_RTOL, "24(c): the "
            f"column's first gradient within {IDENT_SOLID_GRAD_RTOL} of the "
            "float64 twin")
    require(grad["fd_gap"] <= IDENT_FD_RTOL, "24(c): the column's float64 "
            "gradient within its central difference")
    require(launches == expected and twin_launches == twin_expected,
            "24(c): the column's launches of the formula")
    return {k: launches[k] + twin_launches[k] for k in launches}


def plate_ident_document(n: int, t: float, **analysis) -> dict:
    """dyn-plate-identify's block on the n x n slab of thickness t."""
    doc = plate_document(n, t)
    block = json.loads((ROOT / "examples" / "json"
                        / "dyn-plate-identify.json").read_text())["analysis"]
    block.pop("probe_nodes")
    block.update(synthetic={"zone_young": list(IDENT_PLATE_ZONE_YOUNG)},
                 banded=True, **analysis)
    doc["analysis"] = block
    return doc


def shell_ident_document(n: int, **analysis) -> dict:
    """The n x n Scordelis-Lo roof with two zones along the axis."""
    return shell_roof_document(
        n, type="identification", zones=[{"y_max": 25.0},
                                          {"y_min": 25.0}],
        synthetic={"zone_young": list(IDENT_SHELL_ZONE_YOUNG)},
        learning_rate=IDENT_LR, tolerance=IDENT_TOL, banded=True,
        **analysis)


def ident_full_width(dev, card: str, parse, identify, solve, doc,
                     zone_axis: int, n_iter: int, label: str) -> dict:
    """24(c), plate and shell: one family's identification at full width
    (twin data from its banded statics, probes every 11th non-zero DOF):
    the launches of the formula; the loss rows, ms an iteration."""
    import dataclasses

    import numpy as np

    from pinn_fem_tpu_torch.io.identification_io import centroid_zones
    from pinn_fem_tpu_torch.ops import kernels

    problem = parse(doc)[0]
    zones = centroid_zones(problem, doc["analysis"]["zones"],
                           problem.nodes[problem.elements].mean(axis=1),
                           "xyz"[:problem.nodes.shape[1]])
    true = np.broadcast_to(problem.young, (problem.nelm,)).copy()
    for ids, e in zip(zones, doc["analysis"]["synthetic"]["zone_young"]):
        true[ids] = e
    kernels.reset_launch_counts()
    with PcgTally() as twin_its:
        twin_s, (r, _, _) = synced(lambda: solve(
            dataclasses.replace(problem, young=true), tol=IDENT_TOL * 0.01,
            device=dev))
    twin_launches = kernels.launch_counts()
    probe, meas = twin_probes(r.displacements, IDENT_PROBE_STRIDE)
    wall, (young, hist, _), its, _, launches, peak = ident_identify(
        identify, problem, probe, meas, zones=zones, n_iter=n_iter,
        learning_rate=IDENT_LR, tol=IDENT_TOL, device=dev)
    expected = banded_launches(its, 0)
    twin_expected = banded_launches(twin_its, 1)
    log(f"phase24c_{label}", card=card, ndof=problem.ndof,
        elements=problem.nelm, probes=probe.size, twin_s=twin_s,
        twin_iterations=twin_its, wall_s=wall,
        ms_per_iteration=1e3 * wall / n_iter, loss=hist.tolist(),
        zone_young=[float(young[z].mean()) for z in zones],
        forward_iterations=its[0::2], adjoint_iterations=its[1::2],
        peak_gib=peak, launches=launches, expected=expected,
        twin_launches=twin_launches, twin_expected=twin_expected)
    require(launches == expected and twin_launches == twin_expected,
            f"24(c): the {label} launches of the formula")
    return {k: launches[k] + twin_launches[k] for k in launches}


def ident_cut_document(name: str) -> dict:
    doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                     .read_text())
    cut = (IDENT_TRANSIENT_DOC_ITERS if "n_steps" in doc["analysis"]
           else IDENT_DOC_ITERS)
    doc["analysis"]["n_iter"] = min(int(doc["analysis"]["n_iter"]), cut)
    return doc


def ident_cpu_processes(workdir: Path, docs: dict,
                        sub: str = "cpu24") -> dict:
    """{name: (process, result path)}: each document through the port's
    CLI on the CPU (one torch thread), in processes that run while the
    card runs its copies (their files in workdir / sub)."""
    outdir = workdir / sub
    outdir.mkdir(exist_ok=True)
    env = dict(os.environ, PINN_FEM_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = {}
    for name, doc in docs.items():
        path = outdir / f"{name}.json"
        path.write_text(json.dumps(doc))
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "pinn_fem_tpu_torch.cli.generic",
             str(path)], cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL), outdir / f"{name}.res.json")
    return procs


def ident_values(out: dict):
    """The identified numbers of a result: the scalars, the field at the
    elements, or the per-element moduli / inertia."""
    if "identified" in out:
        return [out["identified"][k] for k in sorted(out["identified"])]
    if "identified_field" in out:
        return out["identified_field"]["at_elements"]["values"]
    return out[out["parameter"]]


def ident_documents(workdir: Path, dev, card: str, docs: dict,
                    procs: dict) -> dict:
    """24(d) and the small 24(c) cases: each document through main() on
    the card against the CPU process's result: the loss rows and the
    identified values within IDENT_DOC_RTOL (IDENT_CASE_RTOL for the 24(c)
    cases); ms an ADAM iteration and the full document's wall extrapolated
    from it."""
    launches, report = {}, {}
    for name, doc in docs.items():
        with PcgTally() as its:
            out, counts, wall, _, _ = run_cli_document(workdir, name, doc)
        proc, path = procs[name]
        require(proc.wait(timeout=600) == 0, f"24(d): {name} on the CPU")
        cpu = json.loads(path.read_text())
        n_iter = int(doc["analysis"]["n_iter"])
        full = int(json.loads((ROOT / "examples" / "json" / f"{name}.json")
                              .read_text())["analysis"]["n_iter"]) \
            if name in IDENT_DOCUMENTS else n_iter
        gaps = {"loss_history": max_rel(out["loss_history"],
                                        cpu["loss_history"]),
                "values": max_rel(ident_values(out), ident_values(cpu))}
        # A banded twin-data solve (one fused PCG beside the ADAM loop's
        # pairs) launches kernel 1 once, for its reactions.
        expected = banded_launches(its, len(its) % 2)
        report[name] = dict(wall_s=wall, ms_per_iteration=1e3 * wall / n_iter,
                            full_wall_s=wall * full / n_iter, n_iter=n_iter,
                            gaps=gaps, keys_equal=sorted(out) == sorted(cpu),
                            launches=counts, expected=expected,
                            pcg_solves=len(its))
        launches[name] = counts
        bound = (IDENT_DOC_RTOL if name in IDENT_DOCUMENTS
                 else IDENT_CASE_RTOL)
        require(sorted(out) == sorted(cpu), f"24(d): {name}'s keys")
        require(max(gaps.values()) <= bound, f"24(d): {name} within "
                f"{bound} of the CPU run")
        require(counts == expected, f"24(d): {name}'s launches")
    log("phase24d_documents", card=card, documents=report)
    return launches


def ident_refusals(workdir: Path, dev, card: str) -> None:
    """24(e): zones with a field, overlapping zones, measured_u with
    synthetic and a missing measured_dofs refused with ValueError before
    any launch."""
    from pinn_fem_tpu_torch.io.frame_io import run_frame_document
    from pinn_fem_tpu_torch.io.plane_io import run_plane_document
    from pinn_fem_tpu_torch.ops import kernels

    plane = json.loads((ROOT / "examples" / "json"
                        / "dyn-plane-identify.json").read_text())
    frame = json.loads((ROOT / "examples" / "json"
                        / "dyn-frame-identify.json").read_text())

    def variant(doc, drop=(), **analysis):
        doc = json.loads(json.dumps(doc))
        doc["analysis"].update(analysis)
        for k in drop:
            doc["analysis"].pop(k)
        return doc

    cases = {
        "zones_and_field": (run_plane_document, variant(plane, field=True),
                            "mutually exclusive"),
        "overlapping_zones": (run_plane_document, variant(
            plane, zones=[{"y_max": 2.0}, {"y_max": 3.0}]), "overlaps"),
        "measured_u_and_synthetic": (run_plane_document, variant(
            plane, measured_u=[0.0]), "not both"),
        "missing_measured_dofs": (run_frame_document, variant(
            frame, drop=("measured_dofs",)), "measured_dofs"),
    }
    seen = {}
    for label, (run, doc, words) in cases.items():
        kernels.reset_launch_counts()
        try:
            run(doc, dev)
            seen[label] = "accepted"
        except ValueError as err:
            seen[label] = str(err)
        require(words in seen[label] and zero_launches(
            kernels.launch_counts()), f"24(e): {label} refused before "
            "any launch")
    log("phase24e_refusals", card=card, refusals=seen)


def phase_identification(workdir: Path, dev, card: str) -> dict:
    """Phase 24: identification on the card.  Returns the kernels'
    launches on each of its paths."""
    from pinn_fem_tpu_torch.io.plate_io import parse_plate_document
    from pinn_fem_tpu_torch.io.shell_io import parse_shell_document
    from pinn_fem_tpu_torch.models import plate as TPl
    from pinn_fem_tpu_torch.models import shell as TS

    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    docs = {name: ident_cut_document(name) for name in IDENT_DOCUMENTS}
    docs["plate_small"] = plate_ident_document(
        IDENT_PLATE_SMALL, PLATE_SLAB[1], n_iter=IDENT_PLATE_ITERS,
        probe_nodes=list(range(1, (IDENT_PLATE_SMALL + 1) ** 2, 11)))
    docs["shell_small"] = shell_ident_document(
        IDENT_SHELL_SMALL, n_iter=IDENT_SHELL_ITERS,
        probe_nodes=list(range(0, (IDENT_SHELL_SMALL + 1) ** 2, 3)))
    launches = ident_strip(dev, card)
    lap("ab")
    # The CPU runs start after (a) and (b), whose times they would disturb.
    procs = ident_cpu_processes(workdir, docs)
    launches["solid_column"] = ident_solid(dev, card)
    launches["plate_slab"] = ident_full_width(
        dev, card, parse_plate_document, TPl.identify_plate_young_banded,
        TPl.solve_plate_static_banded,
        plate_ident_document(*PLATE_SLAB), 0, IDENT_PLATE_ITERS, "plate")
    launches["shell_roof"] = ident_full_width(
        dev, card, parse_shell_document, TS.identify_shell_young_banded,
        TS.solve_shell_static_banded, shell_ident_document(IDENT_SHELL), 1,
        IDENT_SHELL_ITERS, "shell")
    lap("c")
    launches.update(ident_documents(workdir, dev, card, docs, procs))
    lap("d")
    ident_refusals(workdir, dev, card)
    lap("e")
    log("phase24_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches}


# ------------------------------------------------------------------ phase 25
SZ_OC_GRID = (100, 200)         # 25(a): 40,000 DOFs, 79,102 members
SZ_OC_MIN_AREA = 1e-4
SZ_OC_TIMED = (2, 12)           # oc_sizing_iteration = (t(12) - t(2)) / 10
SZ_OC_PROFILED = 4
SZ_OC_RTOL = 1e-3               # against the float64 host OC
SZ_OC_DOC_ITERS = 40            # the sizing runner's default for "oc"
SZ_OC_VOLUME_RTOL = 1e-4
SZ_STRIP = (16, 64)             # 25(b)-(c): 2,048 DOFs, 3,858 members
SZ_MASS_RTOL = 1e-2             # float32 against float64, both on the card
SZ_FIELD_LENGTH = 2.0           # 25(c): E's correlation length
SZ_LIMIT_STATES = 8
SZ_MC_SAMPLES = 2048            # two chunks of 1024
SZ_MC_CHUNK = 1024
SZ_MC_CHUNK_F64 = 256           # the float64 check: the same samples
SZ_BETA_RTOL = 1e-3
SZ_MC_SE = 2.0
SZ_DOC_ITERS = 10               # 25(d): ADAM iterations a round
SZ_DOC_CUTS = {"dyn-sizing-fatigue": 5}   # fault 3.39: parts sooner
SZ_DOC_RTOL = 5e-2              # sizing documents against the CPU run
# The facet shell's float32 dense solve (membrane and bending scales, the
# drilling eps) parts from the CPU's sooner: 5.1e-2 on the thickness after
# 20 ADAM iterations, 6.4e-3 on p_f after 50 HL-RF iterations (the first
# card runs).
SZ_DOC_BOUNDS = {"shell_sizing": 2e-1,
                 "shell_reliability": 2e-2}   # 6.4e-3 on p_f (the same run)
SZ_REL_DOC_RTOL = 1e-3          # reliability documents
SZ_GATE = 1e-6                  # max_stress_ratio <= 1 + SZ_GATE
SZ_FLOOR = 1e-3                 # fatigue life / RBDO beta floors
SZ_CLOSED_FORM_RTOL = 1e-4
SZ_DOCUMENTS = ("dyn-sizing", "dyn-sizing-dynamic", "dyn-sizing-fatigue",
                "dyn-sizing-rbdo", "dyn-reliability", "dyn-plane-sizing",
                "dyn-plane-reliability")


def oc_reference_main(out_path: str, n_iter: int, rows: int,
                      cols: int) -> None:
    """The float64 host OC of 25(a) (run in a process of its own): the
    same iteration as solvers/sizing.optimize_compliance_oc on the rows x
    cols grid, each solve a scipy.sparse LU of the free block, the 60-step
    log-space bisection in numpy.  Writes areas and history."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    sys.path.insert(0, str(ROOT))
    from pinn_fem_tpu_torch.examples_grid import grid_arrays

    nodes, el, loads, fixed = grid_arrays(rows, cols)
    n = loads.size
    d = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = np.linalg.norm(d, axis=1)
    c = d / length[:, None]
    g = np.concatenate([-c, c], axis=1)
    dm = np.concatenate([2 * el[:, :1], 2 * el[:, :1] + 1, 2 * el[:, 1:],
                         2 * el[:, 1:] + 1], axis=1)
    ggt = g[:, :, None] * g[:, None, :]
    rows = np.repeat(dm, 4, axis=1).ravel()
    cols = np.tile(dm, (1, 4)).ravel()
    free = np.setdiff1d(np.arange(n), fixed)
    volume = float(np.sum(length))
    areas = np.ones(el.shape[0]) * volume / float(np.sum(length))
    areas = np.clip(areas, SZ_OC_MIN_AREA, None)
    hist = []
    for _ in range(n_iter):
        s = areas / length
        k = sp.coo_matrix(((s[:, None, None] * ggt).ravel(), (rows, cols)),
                          shape=(n, n)).tocsc()
        u = np.zeros(n)
        u[free] = spl.splu(k[free][:, free].tocsc(),
                           permc_spec="MMD_AT_PLUS_A").solve(loads[free])
        strain = np.sum(g * u[dm], axis=-1) / length
        dens = 0.5 * strain * strain
        hist.append(float(loads @ u))
        lower = np.maximum(0.8 * areas, SZ_OC_MIN_AREA)
        upper = 1.2 * areas

        def clamped(lam):
            return np.clip(areas * (dens / lam) ** 0.5, lower, upper)

        d_max = max(float(np.max(dens)), 1e-30)
        lo, hi = 1e-9 * d_max, 1e9 * d_max
        for _ in range(60):
            mid = np.sqrt(lo * hi)
            if np.sum(clamped(mid) * length) > volume:
                lo = mid
            else:
                hi = mid
        areas = clamped(np.sqrt(lo * hi))
    np.savez(out_path, areas=areas, history=np.asarray(hist))


def oc_grid(workdir: Path, dev, card: str) -> dict:
    """25(a): OC sizing on the 100 x 200 grid, uncut: the timed iteration,
    the compliance drop, PCG iterations, idle share, peak memory; areas and
    history against the float64 host OC; the document default through the
    CLI to its convergence flag; launches by the fused PCG's formula."""
    ref_path = workdir / "oc_reference.npz"
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import chip_smoke as c; c.oc_reference_main(sys.argv[2], "
         "*map(int, sys.argv[3:]))", str(ROOT), str(ref_path),
         str(SZ_OC_TIMED[1]), *map(str, SZ_OC_GRID)], cwd=str(ROOT),
        env=dict(os.environ, OMP_NUM_THREADS="2"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        return oc_grid_runs(workdir, dev, card, ref, ref_path)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()


def oc_grid_runs(workdir: Path, dev, card: str, ref, ref_path) -> dict:
    """oc_grid's card runs and checks, the float64 host OC `ref` running
    beside them."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.examples_grid import grid_document, grid_problem
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers.sizing import optimize_compliance_oc

    problem = grid_problem(*SZ_OC_GRID)
    nodes, el = problem.nodes, problem.elements
    length = np.linalg.norm(nodes[el[:, 1]] - nodes[el[:, 0]], axis=1)
    volume = float(np.sum(length))

    def run(n_iter):
        return optimize_compliance_oc(problem, volume, n_iter=n_iter,
                                      min_area=SZ_OC_MIN_AREA, device=dev)

    run(1)                                       # builds, warms the caches
    t_short, _ = synced(lambda: run(SZ_OC_TIMED[0]))
    torch.cuda.reset_peak_memory_stats(dev)
    t_long, res = synced(lambda: run(SZ_OC_TIMED[1]))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    oc_ms = 1e3 * (t_long - t_short) / (SZ_OC_TIMED[1] - SZ_OC_TIMED[0])
    kernels.reset_launch_counts()
    with PcgTally() as its:
        tallied = run(SZ_OC_TIMED[1])
    launches = kernels.launch_counts()
    expected = banded_launches(its, reactions=len(its))
    idle = idle_profile(lambda: run(SZ_OC_PROFILED))

    doc = grid_document(*SZ_OC_GRID)
    doc["analysis"] = {"type": "sizing", "method": "oc",
                       "objective": "compliance", "volume": volume,
                       "min_area": SZ_OC_MIN_AREA}
    with PcgTally() as doc_its:
        out, doc_launches, doc_wall, _, _ = run_cli_document(
            workdir, "oc_document", doc)
    doc_expected = banded_launches(doc_its, reactions=len(doc_its))

    require(ref.wait(timeout=600) == 0,
            f"25(a): the float64 host OC ({ref.stderr.read()[-400:]!r})")
    want = np.load(ref_path)
    gaps = {"areas": max_rel(res.areas, want["areas"]),
            "history": max_rel(res.history, want["history"])}
    vol = {"timed": abs(float(np.sum(res.areas * length)) - volume) / volume,
           "tallied": abs(float(np.sum(tallied.areas * length)) - volume)
           / volume}
    report = dict(
        ndof=problem.ndof, members=problem.nelm,
        oc_sizing_iteration_ms=oc_ms, wall_s={"2": t_short, "12": t_long},
        compliance_drop=float(res.history[0] / res.history[-1]),
        history=res.history.tolist(),
        pcg_per_oc_iteration=list(its),
        pcg_mean=float(np.mean(its)), peak_gb=peak, idle=idle,
        float64_gaps=gaps, volume_gaps=vol,
        area_range=[float(res.areas.min()), float(res.areas.max())],
        launches=launches, expected=expected,
        document=dict(wall_s=doc_wall, converged=out["converged"],
                      n_iter=out["n_iter"], mass=out["mass"],
                      volume_gap=abs(out["volume"] - volume) / volume,
                      area_range=out["area_range"],
                      pcg_iterations=list(doc_its),
                      launches=doc_launches, expected=doc_expected))
    log("phase25a_oc", card=card, **report)
    require(gaps["areas"] <= SZ_OC_RTOL and gaps["history"] <= SZ_OC_RTOL,
            "25(a): areas and compliance within 1e-3 of the float64 OC")
    require(max(vol.values()) <= SZ_OC_VOLUME_RTOL,
            "25(a): sum A L = V within 1e-4")
    require(float(tallied.areas.min()) >= SZ_OC_MIN_AREA * (1 - 1e-6)
            and float(out["area_range"][0]) >= SZ_OC_MIN_AREA * (1 - 1e-6),
            "25(a): min_area <= A")
    require(launches == expected, "25(a): kernel 1 once an OC iteration, "
            "kernels 2 and 3 sum 32 ceil(it / 32), 4 and 4b none")
    require(doc_launches == doc_expected, "25(a): the document's launches")
    require(out["n_iter"] == SZ_OC_DOC_ITERS,
            "25(a): the document default's 40 iterations")
    return {"oc_timed_12": launches, "oc_document": doc_launches}


def sizing_strip_problem():
    from pinn_fem_tpu_torch.examples_grid import grid_problem

    return grid_problem(*SZ_STRIP)


def sizing_strip(dev, card: str) -> dict:
    """25(b): optimize_sizing on the 16 x 64 strip with dyn-sizing.json's
    analysis (stress limit 2, 300 ADAM iterations x 4 rounds), in float32
    and in float64 on the card."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import sizing as SZ
    from pinn_fem_tpu_torch.solvers.sizing import optimize_sizing

    analysis = json.loads((ROOT / "examples" / "json" / "dyn-sizing.json")
                          .read_text())["analysis"]
    problem = sizing_strip_problem()
    kw = dict(stress_limit=float(analysis["stress_limit"]),
              min_area=float(analysis["min_area"]),
              learning_rate=float(analysis["learning_rate"]),
              n_iter=int(analysis["n_iter"]),
              outer_rounds=int(analysis["outer_rounds"]), device=dev)
    optimize_sizing(problem, **dict(kw, n_iter=2, outer_rounds=1,
                                    polish=False))                 # warm
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with Timed(SZ, "_host_area_solve") as host:
        wall, res = synced(lambda: optimize_sizing(problem, **kw))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = kernels.launch_counts()
    n_adam = kw["n_iter"] * kw["outer_rounds"]
    host_s = sum(s for s, _ in host)
    adam_ms = 1e3 * (wall - host_s) / n_adam
    idle = idle_profile(lambda: optimize_sizing(
        problem, **dict(kw, n_iter=10, outer_rounds=1, polish=False)))
    os.environ["PINN_FEM_TPU_X64"] = "1"
    try:
        wall64, res64 = synced(lambda: optimize_sizing(problem, **kw))
    finally:
        os.environ.pop("PINN_FEM_TPU_X64")
    mass_gap = abs(res.mass - res64.mass) / res64.mass
    report = dict(ndof=problem.ndof, members=problem.nelm, wall_s=wall,
                  adam_iterations=n_adam, ms_per_adam_iteration=adam_ms,
                  polish_and_checks_s=host_s, peak_gb=peak, idle=idle,
                  converged=res.converged,
                  max_stress_ratio=res.max_stress_ratio, mass=res.mass,
                  mass_initial=res.mass_initial, mass_float64=res64.mass,
                  converged_float64=res64.converged, wall_float64_s=wall64,
                  mass_gap=mass_gap,
                  area_range=[float(res.areas.min()), float(res.areas.max())],
                  launches=launches)
    log("phase25b_sizing", card=card, **report)
    require(res.converged, "25(b): converged")
    require(res.max_stress_ratio <= 1.0 + SZ_GATE,
            "25(b): max_stress_ratio <= 1 + 1e-6 after the polish")
    require(res.mass < res.mass_initial, "25(b): mass below the start")
    # One-sided: the strip's sizing is not convex, and the float32 and
    # float64 trajectories land in different local optima (ROADMAP fault
    # 3.39: a CPU rehearsal landed float32 5.5 % lighter); a float32
    # design heavier than the float64 one by more than 1e-2 fails.
    require(res.mass <= res64.mass * (1.0 + SZ_MASS_RTOL),
            "25(b): mass at most 1e-2 above float64's")
    require(res64.converged and res64.max_stress_ratio <= 1.0 + SZ_GATE,
            "25(b): the float64 run converged and feasible")
    require(zero_launches(launches), "25(b): no repo kernel on the dense "
            "path")
    return launches


def strip_reliability_inputs(problem):
    """25(c)'s variables and limit state on the strip: dyn-reliability's
    load scale and resistance, E a lognormal random field in two groups
    (cross-braced diagonals share midpoints: one group would repeat a
    correlation row), the resistance's mean 1.3 x the largest stress of the
    SZ_LIMIT_STATES members at the support."""
    import numpy as np

    from pinn_fem_tpu_torch.solvers.sizing import _host_area_solve

    el = problem.elements
    cols = problem.nodes[:, 0]
    slash = (cols[el[:, 0]] > cols[el[:, 1]])          # the "/" diagonals
    _, sigma = _host_area_solve(problem, np.ones(problem.nelm))
    at_support = np.flatnonzero((cols[el[:, 0]] == 0) | (cols[el[:, 1]]
                                                         == 0))
    ls = at_support[np.argsort(-np.abs(sigma[at_support]))[
        :SZ_LIMIT_STATES]]
    base = json.loads((ROOT / "examples" / "json" / "dyn-reliability.json")
                      .read_text())["analysis"]["variables"]
    field = {"correlation_length": SZ_FIELD_LENGTH}
    variables = [
        dict(base[0], name="E", elements=np.flatnonzero(~slash).tolist(),
             field=field),
        dict(base[0], name="E2", elements=np.flatnonzero(slash).tolist(),
             field=field),
        base[1],
        dict(base[2], mean=1.3 * float(np.max(np.abs(sigma[ls])))),
    ]
    return variables, {"type": "stress", "variable": "R",
                       "elements": ls.tolist()}


def strip_reliability(dev, card: str) -> dict:
    """25(c): form_reliability on the strip (E a random field: 3,858
    per-element variables and their Nataf factor), 8 stress limit states,
    2,048 crude Monte-Carlo samples in chunks of 1,024 (each one batched
    dense solve of (1024, 2048, 2048) float32); the float64 run on the
    card (the same samples, chunks of 256) for beta and p_f."""
    import numpy as np
    import torch

    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers import reliability as R

    problem = sizing_strip_problem()
    variables, ls = strip_reliability_inputs(problem)
    R.form_reliability(problem, variables, dict(ls, elements=ls[
        "elements"][:1]), n_iter=2, device=dev)           # warm
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with Timed(R, "_attach_monte_carlo") as mc, Timed(R, "_hlrf") as hlrf:
        wall, res = synced(lambda: R.form_reliability(
            problem, variables, ls, mc_samples=SZ_MC_SAMPLES,
            mc_chunk=SZ_MC_CHUNK, mc_seed=0, device=dev))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = kernels.launch_counts()
    chunk_ms = 1e3 * mc[0][0] / (SZ_MC_SAMPLES / SZ_MC_CHUNK)
    os.environ["PINN_FEM_TPU_X64"] = "1"
    try:
        wall64, res64 = synced(lambda: R.form_reliability(
            problem, variables, ls, mc_samples=SZ_MC_SAMPLES,
            mc_chunk=SZ_MC_CHUNK_F64, mc_seed=0, device=dev))
    finally:
        os.environ.pop("PINN_FEM_TPU_X64")
    beta_gap = max_rel(res.beta, res64.beta)
    se = max(res.mc_std_error, res64.mc_std_error)
    report = dict(n_vars=len(res.variables), limit_states=len(res.labels),
                  wall_s=wall, hlrf_s=hlrf[0][0],
                  hlrf_ms_per_iteration=1e3 * hlrf[0][0] / res.n_iter,
                  mc_chunk_ms=chunk_ms, mc_samples=res.mc_n, peak_gb=peak,
                  beta=res.beta.tolist(), beta_float64=res64.beta.tolist(),
                  beta_gap=beta_gap, mc_pf=res.mc_pf,
                  mc_pf_float64=res64.mc_pf, mc_std_error=res.mc_std_error,
                  system_pf_bounds=[res.system_pf_lower,
                                    res.system_pf_upper],
                  converged=res.converged.tolist(), wall_float64_s=wall64,
                  launches=launches)
    log("phase25c_reliability", card=card, **report)
    require(bool(np.all(res.converged)), "25(c): every limit state "
            "converged")
    require(beta_gap <= SZ_BETA_RTOL, "25(c): beta within 1e-3 of float64")
    require(abs(res.mc_pf - res64.mc_pf) <= SZ_MC_SE * se,
            "25(c): Monte-Carlo p_f within 2 standard errors of float64")
    require(zero_launches(launches), "25(c): no repo kernel on the dense "
            "path")
    return launches


def sizing_family_documents() -> dict:
    """25(d)'s small family documents: frame sizing, RBDO and reliability,
    plate and shell thickness sizing, plane, solid, plate and shell
    reliability."""
    frame = {"element_type": "frame",
             "nodes": [[0, 0], [0, 3], [4, 3], [4, 0]],
             "elements": [[0, 1], [1, 2], [2, 3]],
             "material": {"young": 200.0, "area": 0.4, "inertia": 0.05,
                          "density": 2.0, "section_modulus": 0.2},
             "loads": [0, 0, 0, 1.0, 0, 0, 0.5, 0, 0, 0, 0, 0],
             "fixed_nodes": [0, 3]}
    e_s = [{"name": "E", "kind": "young", "mean": 200.0, "cov": 0.1},
           {"name": "S", "kind": "load_scale", "mean": 1.0, "std": 0.2}]
    plane = json.loads((ROOT / "examples" / "json"
                        / "dyn-plane-reliability.json").read_text())
    plate = plate_document(6, 0.05)
    shell = shell_roof_document(4)
    solid = solid_column(1, 1, 3)[1]
    few = {"n_iter": SZ_DOC_ITERS, "outer_rounds": 2}
    return {
        "frame_sizing": dict(frame, analysis=dict(
            type="sizing", displacement_limit=0.2, probe_dofs=[3], **few)),
        "frame_rbdo": dict(frame, analysis=dict(
            type="sizing", displacement_limit=0.3, probe_dofs=[3],
            reliability={"variables": e_s, "target_beta": 2.0}, **few)),
        "frame_reliability": dict(frame, analysis={
            "type": "reliability", "variables": e_s + [
                {"name": "R", "kind": "resistance", "mean": 12.0,
                 "cov": 0.1}],
            "limit_state": {"type": "stress", "variable": "R"}}),
        "plate_sizing": dict(plate, analysis=dict(
            type="sizing", displacement_limit=2e-3, probe_nodes=[24],
            **few)),
        "shell_sizing": dict(shell, analysis=dict(
            type="sizing", stress_limit=3e5, **few)),
        "plane_reliability": dict(plane, analysis={
            "type": "reliability", "variables": [
                plane["analysis"]["variables"][0],
                {"name": "E", "kind": "young", "mean": 200.0, "cov": 0.1}],
            "limit_state": {"type": "displacement", "limit": 0.03,
                            "probe_dofs": [8]}}),
        "solid_reliability": dict(solid, analysis={
            "type": "reliability", "variables": e_s,
            "limit_state": {"type": "displacement", "limit": 0.15,
                            "probe_dofs": [38]}}),
        "plate_reliability": dict(plate, analysis={
            "type": "reliability", "variables": [
                dict(e_s[0], mean=2e11), e_s[1],
                {"name": "t", "kind": "thickness", "mean": 0.05,
                 "cov": 0.05}],
            "limit_state": {"type": "displacement", "limit": 9e-6,
                            "probe_dofs": [64]}}),
        "shell_reliability": dict(shell, analysis={
            "type": "reliability", "variables": [
                dict(e_s[0], mean=4.32e8), e_s[1]],
            "limit_state": {"type": "displacement", "limit": 0.5,
                            "probe_dofs": [86]}}),
    }


def sizing_cut_document(name: str) -> dict:
    """A corpus document, its ADAM iterations cut to SZ_DOC_ITERS a
    round."""
    doc = json.loads((ROOT / "examples" / "json" / f"{name}.json")
                     .read_text())
    if doc["analysis"]["type"] == "sizing":
        doc["analysis"]["n_iter"] = min(int(doc["analysis"].get(
            "n_iter", 300)), SZ_DOC_CUTS.get(name, SZ_DOC_ITERS))
    return doc


def sizing_iterations(doc: dict) -> int:
    """ADAM iterations (sizing) or HL-RF iterations (reliability)."""
    a = doc["analysis"]
    if a["type"] == "reliability":
        return int(a.get("n_iter", 50))
    return int(a.get("n_iter", 300)) * int(a.get("outer_rounds", 4))


SZ_VALUE_KEYS = ("history", "areas", "thickness", "inertia", "beta", "pf",
                 "mass", "weight", "min_reliability_beta",
                 "min_fatigue_life_s")


def sizing_gaps(out: dict, cpu: dict) -> dict:
    """Largest relative difference of each result value the card and the
    CPU run share (an unreachable limit state's beta is null in both)."""
    import numpy as np

    gaps = {}
    for k in SZ_VALUE_KEYS:
        if k in out:
            a = np.asarray(out[k], dtype=float).ravel()
            b = np.asarray(cpu[k], dtype=float).ravel()
            ok = np.isfinite(b)
            gaps[k] = max_rel(a[ok], b[ok]) if ok.any() else 0.0
    return gaps


def corpus_gates(name: str, out: dict) -> list:
    """benchmarks/dyn_corpus.py's gates of the seven documents, reimplemented:
    the names of the gates that fail."""
    import math

    bad = []
    a = out["analysis"]
    if name == "dyn-plane-sizing":
        import numpy as np

        if np.max(np.abs(np.asarray(out["thickness"]) - 0.5)) \
                > SZ_CLOSED_FORM_RTOL * 0.5 \
                or abs(out["weight"] - 2.0) > SZ_CLOSED_FORM_RTOL * 2.0:
            bad.append("thickness 0.5 / weight 2.0")
        return bad
    if name == "dyn-plane-reliability":
        zr, zs = math.sqrt(math.log1p(0.15 ** 2)), math.sqrt(
            math.log1p(0.2 ** 2))
        b = math.log((2.0 / math.sqrt(1.0225)) / (1.0 / math.sqrt(1.04))) \
            / math.hypot(zr, zs)
        if abs(out["beta_min"] - b) > SZ_CLOSED_FORM_RTOL * b:
            bad.append("closed-form lognormal R - S beta")
        return bad
    if a == "sizing":
        if not out["converged"]:
            bad.append("converged")
        if "max_stress_ratio" in out \
                and out["max_stress_ratio"] > 1.0 + SZ_GATE:
            bad.append("max_stress_ratio")
        if "min_fatigue_life_s" in out and out["min_fatigue_life_s"] \
                < out["fatigue_min_life_s"] * (1.0 - SZ_FLOOR):
            bad.append("fatigue life floor")
        if "min_reliability_beta" in out and out["min_reliability_beta"] \
                < out["target_beta"] * (1.0 - SZ_FLOOR):
            bad.append("RBDO beta floor")
    elif not all(out["converged"]):
        bad.append("converged")
    return bad


def sizing_documents(workdir: Path, dev, card: str, docs: dict,
                     procs: dict) -> dict:
    """25(d): each document through main() on the card against the CPU
    process's result (SZ_DOC_RTOL for sizing, SZ_REL_DOC_RTOL for
    reliability), the corpus gates, ms an iteration, no repo kernel."""
    launches, report = {}, {}
    for name, doc in docs.items():
        out, counts, wall, _, _ = run_cli_document(workdir, name, doc)
        proc, path = procs[name]
        require(proc.wait(timeout=600) == 0, f"25(d): {name} on the CPU")
        cpu = json.loads(path.read_text())
        n_it = sizing_iterations(doc)
        gaps = sizing_gaps(out, cpu)
        bound = SZ_DOC_BOUNDS.get(name, (
            SZ_REL_DOC_RTOL if doc["analysis"]["type"] == "reliability"
            else SZ_DOC_RTOL))
        gates = corpus_gates(name, out) if name in SZ_DOCUMENTS else []
        report[name] = dict(wall_s=wall, iterations=n_it,
                            ms_per_iteration=1e3 * wall / n_it, gaps=gaps,
                            keys_equal=sorted(out) == sorted(cpu),
                            failed_gates=gates, launches=counts)
        launches[name] = counts
        log("phase25d_document", card=card, name=name, **report[name])
        require(sorted(out) == sorted(cpu), f"25(d): {name}'s keys")
        require(max(gaps.values(), default=0.0) <= bound,
                f"25(d): {name} within {bound} of the CPU run")
        require(not gates, f"25(d): {name}'s corpus gates {gates}")
        require(zero_launches(counts), f"25(d): {name} runs no repo "
                "kernel")
    log("phase25d_documents", card=card,
        total_s=sum(r["wall_s"] for r in report.values()))
    return launches


def sizing_refusals(workdir: Path, dev, card: str) -> None:
    """25(e): ADAM and FSD sizing above 2,048 DOFs (the "oc" hint), FORM
    above the dense limit, solid sizing, "oc" without a volume and mesh=,
    each refused before any launch."""
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.io.sizing_io import run_sizing
    from pinn_fem_tpu_torch.io.solid_io import run_solid_analysis
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers.continuum_reliability import (
        continuum_reliability)
    from pinn_fem_tpu_torch.solvers.reliability import form_reliability

    big = grid_problem(24, 48)                  # 2,304 DOFs
    small = grid_problem(2, 4)
    solid = solid_column(1, 1, 2)[0]
    v = json.loads((ROOT / "examples" / "json" / "dyn-reliability.json")
                   .read_text())["analysis"]["variables"]
    cases = {
        "adam_above_dense_limit": (lambda: run_sizing(
            big, {"type": "sizing", "stress_limit": 1.0}, dev), ValueError,
            'use method "oc"'),
        "fsd_above_dense_limit": (lambda: run_sizing(
            big, {"type": "sizing", "method": "fsd", "stress_limit": 1.0},
            dev), ValueError, 'use method "oc"'),
        "form_above_dense_limit": (lambda: form_reliability(
            big, v, {"type": "stress", "variable": "R"}, device=dev),
            ValueError, "FORM traces the dense solve"),
        "solid_sizing": (lambda: run_solid_analysis(
            solid, {"type": "sizing"}, dev), ValueError,
            "analysis.type must be"),
        "oc_without_volume": (lambda: run_sizing(
            small, {"type": "sizing", "method": "oc",
                    "objective": "compliance"}, dev), ValueError,
            'method "oc" needs the volume budget'),
        "mesh_form": (lambda: form_reliability(
            small, v, {"type": "stress", "variable": "R"}, mesh=object(),
            device=dev), NotImplementedError, "item 15"),
        "mesh_continuum": (lambda: continuum_reliability(
            solid, v[1:2], {"type": "displacement", "limit": 1.0,
                            "probe_dofs": [0]}, "solid", mesh=object(),
            device=dev), NotImplementedError, "item 15"),
    }
    seen = {}
    for label, (call, kind, words) in cases.items():
        kernels.reset_launch_counts()
        try:
            call()
            seen[label] = None
        except kind as err:
            seen[label] = str(err)
        require(seen[label] is not None and words in seen[label]
                and zero_launches(kernels.launch_counts()),
                f"25(e): {label} refused before any launch")
    log("phase25e_refusals", card=card, refusals=seen)


def phase_sizing(workdir: Path, dev, card: str) -> dict:
    """Phase 25: sizing and reliability on the card.  Returns the kernels'
    launches on each of its paths."""
    seconds = {}
    clock = time.perf_counter()

    def lap(item):
        nonlocal clock
        seconds[item] = time.perf_counter() - clock
        clock = time.perf_counter()

    launches = oc_grid(workdir, dev, card)
    lap("a")
    docs = {name: sizing_cut_document(name) for name in SZ_DOCUMENTS}
    docs.update(sizing_family_documents())
    procs = ident_cpu_processes(workdir, docs, "cpu25")
    try:
        launches["strip_sizing"] = sizing_strip(dev, card)
        lap("b")
        launches["strip_reliability"] = strip_reliability(dev, card)
        lap("c")
        launches.update(sizing_documents(workdir, dev, card, docs, procs))
        lap("d")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    sizing_refusals(workdir, dev, card)
    lap("e")
    log("phase25_done", card=card, seconds=seconds,
        total_s=sum(seconds.values()))
    return {"launches": launches}


def main() -> int:
    card = phase_card()
    phase_build()
    import torch

    dev = torch.device(DEVICE)
    stats = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(Path(tmp))
        phase4 = dict(launches)
        phase_dense(Path(tmp))
        mat_stats = phase_material(dev)
        launches.update(phase_gd_main_path(Path(tmp), dev))
        phase_gd_corpus(Path(tmp))
        second_order = phase_second_order(Path(tmp), dev)
        truss_ext = phase_truss_extensions(Path(tmp), dev, card)
        legacy = phase_api(Path(tmp), dev, card)
        meshes = phase_meshes(Path(tmp), dev, card, phase4)
        dynamics = phase_dynamics(Path(tmp), dev, card)
        multigrid = phase_multigrid(dev, card)
        batched = phase_batched(Path(tmp), dev, card)
        eigen = phase_eigen(Path(tmp), dev, card)
        frequency = phase_frequency(Path(tmp), dev, card)
        nonlinear = phase_nonlinear(Path(tmp), dev, card)
        plane = phase_plane(Path(tmp), dev, card)
        solid = phase_solid(Path(tmp), dev, card)
        frame = phase_frame(Path(tmp), dev, card)
        plate = phase_plate(Path(tmp), dev, card)
        shell = phase_shell(Path(tmp), dev, card)
        ident = phase_identification(Path(tmp), dev, card)
        sizing = phase_sizing(Path(tmp), dev, card)

    grid = dict(stats["grid_40k"], **mat_stats)
    entries = []
    for name, (source, replaces) in KERNELS.items():
        err = (max(stats[m][name]["err"] for m in stats if name in stats[m])
               if name in BANDED
               else mat_stats[name]["err"])
        k = grid[name]
        entries.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "device_us": k.get("device_us"),
            "wrapper_ms": k.get("wrapper_ms"),
            **{key: k[key] for key in ("host_us", "twin_ms", "s_only_ms",
                                       "s_only_device_us", "s_only_bound_ms")
               if key in k},
        })
        if name == "material_coefficients":
            entries[-1]["launches_second_order"] = second_order
        if name in MATERIAL:
            entries[-1]["launches_legacy"] = {
                path: counts[name] for path, counts in legacy.items()}
        if name in BANDED:
            entries[-1]["launches_truss_ext"] = {
                doc: counts[name] for doc, counts in truss_ext.items()}
        entries[-1]["launches_meshes"] = {
            path: counts[name] for path, counts in meshes.items()}
        entries[-1]["launches_dynamics"] = {
            path: counts[name] for path, counts in dynamics.items()}
        entries[-1]["launches_multigrid"] = {
            path: counts[name]
            for path, counts in multigrid["launches"].items()}
        entries[-1]["launches_batched"] = {
            path: counts[name]
            for path, counts in batched["launches"].items()}
        entries[-1]["launches_eigen"] = {
            path: counts[name] for path, counts in eigen.items()}
        entries[-1]["launches_frequency"] = {
            path: counts[name] for path, counts in frequency.items()}
        entries[-1]["launches_nonlinear"] = {
            path: counts[name] for path, counts in nonlinear.items()}
        entries[-1]["launches_plane"] = {
            path: counts[name] for path, counts in plane["launches"].items()}
        entries[-1]["launches_solid"] = {
            path: counts[name] for path, counts in solid["launches"].items()}
        entries[-1]["launches_frame"] = {
            path: counts[name] for path, counts in frame["launches"].items()}
        entries[-1]["launches_plate"] = {
            path: counts[name] for path, counts in plate["launches"].items()}
        entries[-1]["launches_shell"] = {
            path: counts[name] for path, counts in shell["launches"].items()}
        entries[-1]["launches_identification"] = {
            path: counts[name] for path, counts in ident["launches"].items()}
        entries[-1]["launches_sizing"] = {
            path: counts[name] for path, counts in sizing["launches"].items()}
        if name in BANDED:
            entries[-1]["plane_strip"] = {
                key: plane["strip"][name][key]
                for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "bit_equal")}
            entries[-1]["solid_column"] = {
                key: solid["column"][name].get(key)
                for key in ("err", "ms", "device_us", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "bit_equal")}
            for label, ops in (("frame_tower", frame["tower"]),
                               ("frame3d_grid", frame["grid"]),
                               ("plate_slab", plate["slab"]),
                               ("shell_roof", shell["roof"]),
                               ("shell_marguerre", shell["marguerre"])):
                entries[-1][label] = {
                    key: ops[name].get(key)
                    for key in ("err", "ms", "device_us", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "bit_equal")}
        if name in MATERIAL:
            side = ("forward" if name == "material_coefficients"
                    else "backward")
            entries[-1]["members"] = {
                str(b): batched["members"][b][side]
                for b in BATCH_MEMBERS}
        if name == "dia_matvec":
            entries[-1]["multigrid_level_shapes"] = [
                {k: shape[k] for k in ("ndof", "n_diags", "bandwidth", "ms",
                                       "device_us", "plain_ms", "bound_ms",
                                       "bound_by")}
                for shape in multigrid["level_shapes"]]
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
