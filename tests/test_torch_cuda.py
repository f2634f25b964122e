"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The banded kernels sum in the twins' order with separately rounded
multiplies and adds, and the twins reduce by the kernels' partitions and
trees, so those comparisons are exact, the PCG loop's device state
included; the direction kernel (kernel 2) is also held on misaligned
views, a ragged end and a system below one tile.  The material kernels
(kernel 4) are held to their twin at the JAX kernel test's bounds
(forward) and to 1e-4 of the largest gradient entry (backward); the
backward (4b) also to its plain version, within 1e-5 of the largest
gradient entry, as one device kernel per call, and on two streams at
once; with a member axis (B = 1, 3, 32), each member against the
one-member kernels and the plain batched version.  The gather-based PCG (no repo kernel) is held to the same functions
on the CPU, and a resumed Newton run to the uninterrupted one.  The
multigrid V-cycle (kernel 1 on every level) is held bit for bit to the
plain cycle, its PCG to the CPU solve, and its float64 refusal.  The
banded modal and buckling eigensolvers launch kernels 1-3 exactly as
their block solves and products count, a block solve bit-equal to the
twin recurrence, their eigenvalues within 1e-3 of the CPU and dense runs.
The plane family's banded statics launches kernels 2 and 3 in whole rounds
of 32 PCG iterations and kernel 1 once (the reactions), within 1e-4 of
the CPU run; its dense analyses on the card equal the CPU's at 1e-10.  So
does the solid family's banded statics (99 diagonals), and one central
step of its banded transient (kernel 1) equals the CPU's within 1e-5.
The frame families' banded statics (3 and 6 DOFs a node) launch the
kernels as the plane's does, within 1e-3 of the dense solve; their dense
analyses on the card equal the CPU's at 1e-10.  So do the plate's banded
statics (33 diagonals) and dense analyses, and the continuum spectrum,
random and fatigue analyses equal the CPU's at 1e-10.  The shell's
banded statics (69 diagonals) and banded Marguerre Newton launch the
kernels as their PCG solves count, within 1e-3 of the CPU twins' runs;
its dense analyses, Newton and Riks equal the CPU's at 1e-10, its
plastic host tier at its Newton tolerance, 1e-9.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest
import torch

import pinn_fem_tpu_torch as T

from pinn_fem_tpu_torch.examples_grid import (chain_problem, grid_arrays,
                                              grid_problem)
from pinn_fem_tpu_torch.ops import kernels
from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
from pinn_fem_tpu_torch.ops.dia import assemble_dia, dia_layout
from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel
from pinn_fem_tpu_torch.ops.kernels import material_kernel

pytestmark = pytest.mark.cuda

MESHES = {"chain3000": lambda: chain_problem(3000),
          "grid16x72": lambda: grid_problem(16, 72)}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def system(mesh, dev, problem=None):
    p = MESHES[mesh]() if problem is None else problem
    data = p.to_device(dev)
    layout = dia_layout(data.dof_map.cpu().numpy(), p.ndof)
    diags = assemble_dia(layout, stiffness_coefficients(data, p.material, 1.0),
                         data.gvec)
    return data, layout, diags


def compressed_strip(rows, cols):
    """Cross-braced grid strip, left edge fixed, unit compression on each
    right-edge node's x-DOF (tests/test_buckling.py's compressed_grid)."""
    nodes, elements, _, fixed = grid_arrays(rows, cols)
    loads = np.zeros(2 * rows * cols)
    loads[2 * (np.arange(rows) * cols + cols - 1)] = -1.0
    return T.TrussProblem(nodes, elements,
                          T.Material(young=100.0, area=1.0, density=1.0),
                          loads, fixed, 2)


def band_layout(n, offsets=range(-3, 4)):
    """A DIA layout of n rows with the given offsets (a chain's: -3..3)."""
    from pinn_fem_tpu_torch.ops.dia import DiaLayout

    offs = np.asarray(list(offsets), np.int64)
    return DiaLayout(offsets=offs, entry_slot=np.zeros((0, 2, 2), np.int64),
                     ndof=n, bandwidth=int(np.abs(offs).max()))


def update_operands(n, dev, seed=4):
    """The update's operands, with as many direction partials as the
    direction kernel writes for a chain of n rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x, r, p, ap = (torch.randn(n, generator=g, device=dev) for _ in range(4))
    inv_diag = torch.rand(n, generator=g, device=dev) + 0.1
    pap = torch.rand(cg_kernel.n_direction_partials(band_layout(n)),
                     generator=g, device=dev) + 0.5
    return pap, x, r, p, ap, inv_diag


def update_both(args, state, max_iter):
    """cg_update and its twin on copies of the same operands: the
    kernel's and the twin's (x, r, z, partials, state)."""
    pap, x, r, p, ap, inv_diag = args
    out = []
    for fn in (kernels.cg_update, cg_kernel.cg_update_reference):
        xs, rs, st = x.clone(), r.clone(), state.clone()
        zs = torch.zeros_like(x)
        parts = torch.zeros(cg_kernel.UPDATE_BLOCKS, 2, dtype=torch.float64,
                            device=x.device)
        fn(pap, xs, rs, p, ap, inv_diag, zs, st, max_iter, parts)
        out.append((xs, rs, zs, parts, st))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_kernels_equal_twins_on_card(cuda_device, mesh):
    dev = cuda_device
    data, layout, d = system(mesh, dev)
    rng = np.random.default_rng(4)
    u, z, p = (torch.tensor(rng.normal(size=layout.ndof),
                            dtype=torch.float32, device=dev)
               for _ in range(3))
    before = kernels.launch_counts()
    assert dia_kernel.stencil_plan(layout).staged
    assert torch.equal(kernels.dia_matvec(layout, d, u),
                       dia_kernel.dia_matvec_reference(layout, d, u))
    beta = torch.tensor(0.37, device=dev)
    got = kernels.dia_dir_matvec(beta, z, p, layout, d, data.free_mask)
    want = cg_kernel.dir_matvec_reference(beta, z, p, layout, d,
                                          data.free_mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    state = cg_kernel.new_state(torch.tensor(3.0, device=dev),
                                torch.tensor(2.0, device=dev),
                                torch.tensor(1e-9, device=dev), 100)
    k, t = update_both(update_operands(layout.ndof, dev), state, 100)
    assert all(torch.equal(a, b) for a, b in zip(k, t))
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1
               for k in ("dia_matvec", "dia_dir_matvec", "cg_update"))


def test_stencil_wide_band_and_misaligned_views(cuda_device):
    """The kernel's unstaged path (a band far wider than shared memory)
    and a u and diagonals that start 4 bytes past a 16-byte boundary, on
    both paths: bit-equal to the twin."""
    from pinn_fem_tpu_torch.ops.dia import DiaLayout

    dev = cuda_device
    offs = np.array([1290 * j for j in range(-31, 32)], np.int64)
    wide = DiaLayout(offsets=offs, entry_slot=np.zeros((0, 2, 2), np.int64),
                     ndof=100_001, bandwidth=int(offs.max()))
    _, grid, _ = system("grid16x72", dev)
    assert not dia_kernel.stencil_plan(wide).staged
    g = torch.Generator(device=dev).manual_seed(9)
    for layout in (wide, grid):
        n, nd = layout.ndof, layout.n_diags
        d = torch.randn(nd * n + 1, generator=g, device=dev)
        u = torch.randn(n + 1, generator=g, device=dev)
        for dd, uu in ((d[:-1].view(nd, n), u[:-1]),
                       (d[1:].view(nd, n), u[1:])):
            assert torch.equal(kernels.dia_matvec(layout, dd, uu),
                               dia_kernel.dia_matvec_reference(layout, dd, uu))


@pytest.mark.parametrize("case", ["live", "pap_zero", "rz_new_negative",
                                  "rz_new_not_finite", "max_iter",
                                  "ragged_end"])
def test_update_epilogue_equals_twin_on_card(cuda_device, case):
    """The update kernel and its twin, state included, on the epilogue's
    guards; then a stopped state, which neither changes."""
    dev = cuda_device
    n = 70_003 if case == "ragged_end" else 4096
    pap, x, r, p, ap, inv_diag = update_operands(n, dev, seed=11)
    rz, it, max_iter = 3.0, 0, 100
    if case == "pap_zero":
        pap.zero_()
    elif case == "rz_new_negative":
        inv_diag = -inv_diag
    elif case == "rz_new_not_finite":
        inv_diag[5] = float("inf")
    elif case == "max_iter":
        it, max_iter = 36, 37
    state = cg_kernel.new_state(torch.tensor(rz, device=dev),
                                torch.tensor(2.0, device=dev),
                                torch.tensor(1e-9, device=dev), max_iter)
    cg_kernel.state_views(state)[1][0] = it
    args = (pap, x, r, p, ap, inv_diag)
    k, t = update_both(args, state, max_iter)
    assert all(torch.equal(a, b) for a, b in zip(k[:4], t[:4]))
    assert torch.equal(k[4], t[4])  # the state, bytes and all
    stopped = case not in ("live", "ragged_end")
    assert bool(cg_kernel.state_views(k[4])[2]) == stopped
    if stopped:
        k2, t2 = update_both((pap, k[0], k[1], p, ap, inv_diag), k[4],
                             max_iter)
        assert torch.equal(k2[4], k[4]) and torch.equal(k2[0], k[0])


def test_update_refuses_misaligned_vectors(cuda_device):
    pap, x, r, p, ap, inv_diag = update_operands(4097, cuda_device)
    state = cg_kernel.new_state(*(torch.tensor(v, device=cuda_device)
                                  for v in (1.0, 1.0, 0.0)), 10)
    x = x[1:]
    with pytest.raises(ValueError, match="16-byte"):
        kernels.cg_update(pap, x, r[1:], p[1:], ap[1:], inv_diag[1:],
                          torch.empty_like(x), state, 10)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fused_cg_on_card_equals_twin_recurrence(cuda_device, mesh):
    """Iterations, x and the residual bit for bit, at a reachable tol and
    at tol 0 (300 iterations).  The chain is pulled at its free end, x of
    node 0 and every y pinned, as in chip_smoke.py."""
    data, layout, d = system(mesh, cuda_device)
    rhs, mask = data.loads, data.free_mask
    if mesh.startswith("chain"):
        mask = torch.ones(layout.ndof, device=cuda_device)
        mask[0] = 0.0
        mask[1::2] = 0.0
        rhs = torch.zeros(layout.ndof, device=cuda_device)
        rhs[-2] = 1.0
    for tol in (1e-5, 0.0):
        x, it, res = kernels.fused_cg_solve(layout, d, rhs, mask, tol=tol,
                                            max_iter=300)
        x_ref, it_ref, res_ref = kernels.fused_cg_solve_reference(
            layout, d, rhs, mask, tol=tol, max_iter=300)
        assert int(it) == int(it_ref) > 0 and torch.equal(x, x_ref)
        assert torch.equal(res, res_ref)
        assert float(torch.max(torch.abs(x * (1 - mask)))) == 0.0


def test_wrappers_refuse_float64_on_card(cuda_device):
    data, layout, d = system("chain3000", cuda_device)
    with pytest.raises(TypeError, match="float32"):
        kernels.dia_matvec(layout, d.double(), data.loads.double())


def test_stop_flag_freezes_kernels(cuda_device):
    n = 1000
    x = torch.zeros(n, device=cuda_device)
    r, z = x + 1.0, x + 2.0
    state = cg_kernel.new_state(*(torch.tensor(v, device=cuda_device)
                                  for v in (1.0, 1.0, 0.0)), 0)
    before = state.clone()
    kernels.cg_update(torch.ones(4, device=cuda_device), x, r, r, r, r, z,
                      state, 0)
    assert float(x.abs().max()) == 0.0 and float((r - 1).abs().max()) == 0.0
    assert float((z - 2).abs().max()) == 0.0
    assert torch.equal(state, before)


def device_kernels(fn):
    """The device kernels of one call of fn, from the first of three
    torch.profiler windows that recorded anything (on the card a window
    now and then comes back empty)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        found = [ev.name for ev in prof.events()
                 if getattr(ev, "device_type", None)
                 == torch.autograd.DeviceType.CUDA
                 and getattr(ev, "device_time_total", 0) > 0]
        if found:
            return found
    return []


def direction_case(case, dev):
    """(layout, diags) of one direction-kernel case."""
    if case == "grid_40k":
        _, layout, d = system(None, dev, grid_problem(100, 200))
        return layout, d
    layout = {
        "chain_2M": lambda: band_layout(2_000_002),
        "wide_band": lambda: band_layout(100_001,
                                         [1290 * j for j in range(-31, 32)]),
        "ragged": lambda: band_layout(70_003),
        "below_one_tile": lambda: band_layout(30),
    }[case]()
    g = torch.Generator(device=dev).manual_seed(3)
    return layout, torch.randn(layout.n_diags, layout.ndof, generator=g,
                               device=dev)


@pytest.mark.parametrize("case", ["grid_40k", "chain_2M", "wide_band",
                                  "ragged", "below_one_tile"])
def test_dir_matvec_equals_twin_on_card(cuda_device, case):
    """Kernel 2 bit for bit against dir_matvec_reference (p_new, ap and
    the per-block partials), also on views of every operand that start 4
    bytes past a 16-byte boundary; one device kernel and one counted
    launch per call; with the stop flag set it writes nothing."""
    dev = cuda_device
    layout, d = direction_case(case, dev)
    n, nd = layout.ndof, layout.n_diags
    plan = dia_kernel.direction_plan(layout)
    assert plan.staged == (case != "wide_band")
    assert plan.blocks == cg_kernel.n_direction_partials(layout)
    if case == "below_one_tile":
        assert plan.blocks == 1 and n < plan.tile
    g = torch.Generator(device=dev).manual_seed(8)
    beta = torch.tensor(-0.37, device=dev)
    z, p = (torch.randn(n + 1, generator=g, device=dev) for _ in range(2))
    mask = (torch.rand(n + 1, generator=g, device=dev) > 0.2).float()
    d_off = torch.randn(nd * n + 1, generator=g, device=dev)
    views = {"aligned": (z[:-1], p[:-1], mask[:-1], d),
             "misaligned": (z[1:], p[1:], mask[1:], d_off[1:].view(nd, n))}
    for label, (zz, pp, mm, dd) in views.items():
        want = cg_kernel.dir_matvec_reference(beta, zz, pp, layout, dd, mm)
        outs = [torch.full((n + 1,), float("nan"), device=dev)
                for _ in range(2)]
        lo = 1 if label == "misaligned" else 0
        out = (outs[0][lo:lo + n], outs[1][lo:lo + n],
               torch.full((plan.blocks,), float("nan"), device=dev))
        before = kernels.launch_counts()["dia_dir_matvec"]
        got = kernels.dia_dir_matvec(beta, zz, pp, layout, dd, mm, out=out)
        assert kernels.launch_counts()["dia_dir_matvec"] == before + 1
        for k, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (case, label, k, float(
                (a - b).abs().nan_to_num(float("inf")).max()))
    names = device_kernels(lambda: kernels.dia_dir_matvec(
        beta, z[:-1], p[:-1], layout, d, mask[:-1], out=out))
    assert len(names) == 1 and "dia_dir_matvec_kernel" in names[0], names
    stop = torch.ones(1, dtype=torch.bool, device=dev)
    frozen = [t.clone() for t in out]
    kernels.dia_dir_matvec(beta, z[:-1], p[:-1], layout, d, mask[:-1],
                           stop=stop, out=out)
    assert [torch.equal(a, b) for a, b in zip(out, frozen)] == [True] * 3


def test_material_backward_per_stream_scratch(cuda_device):
    """Two backward calls of kernel 4b in flight together on two streams
    each give the result of a call made alone: each stream has its own
    float64 scratch and tickets."""
    dev = cuda_device
    n = 1_000_000
    rng = np.random.default_rng(12)
    mid = torch.from_numpy(rng.uniform(0, 50, (n, 2)).astype(np.float32))
    inv_len = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(2, 4, n)).astype(np.float32))
    mid, inv_len, c = (t.to(dev) for t in (mid, inv_len, c))
    mat = mlp_material(2, dev)
    fields = material_kernel._fields(mat)
    params = torch.cat([t.reshape(-1) for f in fields
                        for t in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields])
    widths = material_kernel._widths(mat)
    e, a, _, _ = material_kernel.material_coefficients(
        mid, inv_len, 0.8, params, scales, widths)

    def backward(k):
        return material_kernel.material_coefficients_backward(
            mid, inv_len, 0.8, params, scales, widths, e, a, tuple(c[k]))

    alone = [backward(k) for k in (0, 1)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    main = torch.cuda.current_stream(dev)
    for _ in range(3):
        got = []
        for k, s in enumerate(streams):
            s.wait_stream(main)
            with torch.cuda.stream(s):
                got.append([backward(k) for _ in range(4)])
        for s in streams:
            main.wait_stream(s)
        torch.cuda.synchronize()
        for k in (0, 1):
            assert all(torch.equal(g, alone[k]) for g in got[k])
    plans = [material_kernel._grad_plan(dev, s.cuda_stream, widths, n)
             for s in streams]
    assert plans[0][0].partial != plans[1][0].partial
    assert plans[0][0].tickets != plans[1][0].tickets


def mlp_material(hidden_layers, dev):
    g = torch.Generator().manual_seed(11)
    fields = [T.make_mlp_field(g, hidden_layers=hidden_layers,
                               neurons_per_layer=w, input_dim=3, scale=s)
              for w, s in ((20, 2.0), (15, 0.5), (10, 7.0))]
    return T.Material(*fields).to(dev)


@pytest.mark.parametrize("hidden_layers", [1, 2])
@pytest.mark.parametrize("lf", [0.3, 1.0])
def test_material_kernels_match_twin_on_card(cuda_device, hidden_layers, lf):
    from pinn_fem_tpu_torch.solvers.gd import get_theta, set_theta

    data = grid_problem(16, 72).to_device(cuda_device)
    mat = mlp_material(hidden_layers, cuda_device)
    theta = [[(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in layers] for layers in get_theta(mat)]
    mat = set_theta(mat, theta)
    params = [t for layers in theta for layer in layers for t in layer]
    c = torch.randn(4, data.nelm, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))

    def run(fn):
        out = fn()
        loss = sum(torch.sum(ci * o) for ci, o in zip(c, out))
        return out, torch.autograd.grad(loss, params)

    before = kernels.launch_counts()
    got, g_got = run(lambda: material_kernel.fused_material_coefficients(
        data, mat, lf))
    after = kernels.launch_counts()
    assert after["material_coefficients"] == before["material_coefficients"] + 1
    assert after["material_coefficients_backward"] == \
        before["material_coefficients_backward"] + 1
    want, g_want = run(lambda: material_kernel.material_coefficients_reference(
        data.mid, data.inv_len, lf, mat))
    for k, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=3e-5 if k == 3 else 2e-5,
                                   atol=1e-6)
    scale = max(float(g.abs().max()) for g in g_want)
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max()) <= 1e-4 * scale
    # The backward repeats bit for bit (no atomics).
    _, g_again = run(lambda: material_kernel.fused_material_coefficients(
        data, mat, lf))
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_again))


# (elements, midpoint dimension, (h1, h2) of the three nets): every padded
# width Q = 1..8 with odd widths and h1 != h2 at both depths; n = 0, below
# one block, not a multiple of the plan's block, and several passes a warp;
# dim 1, dim 2, and dim 2 from a view 4 bytes off an 8-byte boundary (the
# kernel's float2 loads do not apply).
FORWARD_CASES = {
    "q123_two": (1001, 2, ((1, 3), (5, 7), (11, 9))),
    "q456_two": (1001, 2, ((15, 13), (17, 19), (21, 23))),
    "q788_two": (1001, 1, ((25, 27), (31, 29), (32, 30))),
    "q123_one": (1001, 1, ((3, 0), (5, 0), (9, 0))),
    "q456_one": (1001, 2, ((13, 0), (17, 0), (21, 0))),
    "q788_one": (1001, 2, ((25, 0), (31, 0), (32, 0))),
    "empty": (0, 2, ((20, 20), (15, 15), (10, 10))),
    "below_one_block": (50, 2, ((1, 32), (17, 5), (32, 1))),
    "many_passes": (300_007, 2, ((20, 20), (15, 15), (10, 10))),
    "misaligned_2d": (777, 2, ((20, 20), (15, 15), (10, 10))),
}


def random_material(shapes, seed, dev):
    """Three MLP fields of the given (h1, h2) shapes, input_dim 3, weights
    uniform in +-1/sqrt(fan in) and the output layer at three times that,
    biases in +-0.1, drawn with numpy."""
    rng = np.random.default_rng(seed)
    fields = []
    for (h1, h2), scale in zip(shapes, (2.0, 0.5, 7.0)):
        dims = [3, h1] + ([h2] if h2 else []) + [1]
        layers = []
        for k, (i, o) in enumerate(zip(dims, dims[1:])):
            gain = 3.0 if k == len(dims) - 2 else 1.0
            w = gain * rng.uniform(-1, 1, (i, o)) / np.sqrt(i)
            b = rng.uniform(-0.1, 0.1, o)
            layers.append((torch.tensor(w, dtype=torch.float32, device=dev),
                           torch.tensor(b, dtype=torch.float32, device=dev)))
        fields.append(T.MLPField(layers=layers, input_dim=3,
                                 scale=torch.tensor(scale, device=dev),
                                 enforce_positive=True))
    return T.Material(*fields)


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_material_forward_shapes_on_card(cuda_device, case):
    """The forward kernel (4) against the twin at every padded width, both
    depths, dim 1 and 2 and ragged n: within rtol 2e-5 (3e-5 for s) and
    atol 1e-6, bit for bit across two calls, one counted launch a call
    (none for n = 0)."""
    n, dim, shapes = FORWARD_CASES[case]
    rng = np.random.default_rng(n + dim)
    flat = rng.uniform(0, 50, 2 * n + 1).astype(np.float32)
    if case == "misaligned_2d":
        mid = torch.from_numpy(flat).to(cuda_device)[1:].view(n, 2)
        assert mid.data_ptr() % 8 == 4 and mid.is_contiguous()
    else:
        mid = torch.from_numpy(flat[:n * dim].reshape(n, dim)).to(cuda_device)
    inv_len = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)
                               ).to(cuda_device)
    mat = random_material(shapes, n + 3, cuda_device)
    fields = material_kernel._fields(mat)
    params = torch.cat([t.reshape(-1) for f in fields
                        for t in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields])
    widths = material_kernel._widths(mat)
    assert widths == tuple(h for pair in shapes for h in pair)
    for lf in (0.3, 1.0):
        before = kernels.launch_counts()["material_coefficients"]
        got = material_kernel.material_coefficients(mid, inv_len, lf, params,
                                                    scales, widths)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["material_coefficients"] == \
            before + (1 if n else 0)
        assert all(t.shape == (n,) for t in got)
        want = material_kernel.material_coefficients_reference(
            mid, inv_len, lf, mat)
        for k, (a, b) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, b, rtol=3e-5 if k == 3 else 2e-5,
                                       atol=1e-6)
        again = material_kernel.material_coefficients(mid, inv_len, lf,
                                                      params, scales, widths)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    if n:
        plan, occupancy = material_kernel._forward_plan(cuda_device, widths,
                                                        n)
        assert occupancy[3] == 0, f"the forward spills: {occupancy}"
        assert plan == material_kernel.forward_plan(
            n, occupancy[0], occupancy[1], plan.per_thread, plan.threads)


# (elements, midpoint dimension, hidden layers, upstream gradients given)
BACKWARD_CASES = {
    "ragged_2d": (1001, 2, 2, (0, 1, 2, 3)),
    "below_one_tile": (50, 2, 2, (0, 1, 2, 3)),
    "one_hidden_layer": (777, 2, 1, (0, 1, 2, 3)),
    "s_only": (1001, 2, 2, (3,)),
    "chain_1d": (3000, 1, 2, (0, 1, 2, 3)),
}


@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_material_backward_kernel_matches_plain_version(cuda_device, case):
    """The backward kernel (4b) against its plain version within 1e-5 of
    max|grad| and the twin's autograd within 1e-4; bit-reproducible; one
    device kernel and one counted launch per call; the density block
    exactly zero without grho."""
    from torch.profiler import ProfilerActivity, profile

    from pinn_fem_tpu_torch.solvers.gd import get_theta

    n, dim, hidden, which = BACKWARD_CASES[case]
    rng = np.random.default_rng(n + dim)
    mid = torch.from_numpy(rng.uniform(0, 50, (n, dim)).astype(np.float32))
    inv_len = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32))
    mid, inv_len, c = (t.to(cuda_device) for t in (mid, inv_len, c))
    mat = mlp_material(hidden, cuda_device)
    fields = material_kernel._fields(mat)
    params = torch.cat([t.reshape(-1) for f in fields
                        for t in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields])
    widths = material_kernel._widths(mat)
    lf = 0.8
    e, a, _, _ = material_kernel.material_coefficients(
        mid, inv_len, lf, params, scales, widths)
    grads = tuple(c[k] if k in which else None for k in range(4))

    def backward():
        return material_kernel.material_coefficients_backward(
            mid, inv_len, lf, params, scales, widths, e, a, grads)

    before = kernels.launch_counts()["material_coefficients_backward"]
    got = backward()
    assert kernels.launch_counts()["material_coefficients_backward"] == \
        before + 1
    plain = material_kernel.material_coefficients_backward_reference(
        mid, inv_len, lf, params, scales, widths, e, a, grads)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    theta = [t for layers in get_theta(mat) for layer in layers
             for t in layer]
    with torch.enable_grad():
        for t in theta:
            t.requires_grad_(True)
        vals = material_kernel.material_coefficients_reference(
            mid, inv_len, lf, mat)
        twin = torch.autograd.grad(
            sum(torch.sum(c[k] * vals[k]) for k in which), theta,
            allow_unused=True)
        for t in theta:
            t.requires_grad_(False)
    twin = torch.cat([torch.zeros_like(t).reshape(-1) if g is None
                      else g.reshape(-1) for t, g in zip(theta, twin)])
    assert float((got - twin).abs().max()) <= 1e-4 * float(twin.abs().max())
    assert torch.equal(got, backward())
    if 2 not in which:
        assert bool((got[-mat.density.n_params():] == 0).all())
    # The first profiler window that recorded anything (on the card a
    # window now and then comes back empty, the first of a process among
    # them).
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            backward()
            torch.cuda.synchronize()
        device_ops = [ev for ev in prof.events()
                      if getattr(ev, "device_type", None)
                      == torch.autograd.DeviceType.CUDA
                      and getattr(ev, "device_time_total", 0) > 0]
        if device_ops:
            break
    assert len(device_ops) == 1
    assert "material_grad_kernel" in device_ops[0].name


def member_params(mat, members, seed):
    """(B, P) flat parameters: the material's, each member's perturbed by
    seeded noise of 10 % of each entry's size, and (B,) load factors."""
    fields = material_kernel._fields(mat)
    base = torch.cat([t.reshape(-1) for f in fields
                      for t in f.trainable_params()])
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.normal(
        size=(members, base.numel())).astype(np.float32)).to(base.device)
    params = (base * (1.0 + 0.1 * noise)).contiguous()
    lfs = torch.from_numpy(rng.uniform(0.2, 1.2, members).astype(
        np.float32)).to(base.device)
    return params, lfs


@pytest.mark.parametrize("members", [1, 3, 32])
@pytest.mark.parametrize("hidden_layers", [1, 2])
def test_material_kernels_member_axis_on_card(cuda_device, members,
                                              hidden_layers):
    """Kernels 4 and 4b with a member axis: one counted launch each for B
    members; each member's forward rows bit-equal to the one-member kernel
    on that member and within the single kernel's twin bounds; each
    member's gradient within 1e-5 of its max|grad| of the plain batched
    version (the per-member partition) and of the one-member kernel;
    bit for bit across two calls; B = 1 bit-equal to the one-member
    launch.  The 1,001 elements make every member's blocks finish in one
    wave, where tickets shared between members would mix their rows."""
    dev = cuda_device
    n = 1001
    rng = np.random.default_rng(5)
    mid = torch.from_numpy(rng.uniform(0, 50, (n, 2)).astype(np.float32))
    inv_len = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32))
    mid, inv_len = mid.to(dev), inv_len.to(dev)
    mat = mlp_material(hidden_layers, dev)
    fields = material_kernel._fields(mat)
    scales = torch.stack([f.scale for f in fields])
    widths = material_kernel._widths(mat)
    params, lfs = member_params(mat, members, members + hidden_layers)
    c = torch.from_numpy(rng.normal(size=(4, members, n)).astype(
        np.float32)).to(dev)

    def forward():
        return material_kernel.material_coefficients_batched(
            mid, inv_len, lfs, params, scales, widths)

    before = kernels.launch_counts()
    got = forward()
    e, a = got[0], got[1]

    def backward():
        return material_kernel.material_coefficients_backward_batched(
            mid, inv_len, lfs, params, scales, widths, e, a, tuple(c))

    grad = backward()
    after = kernels.launch_counts()
    assert after["material_coefficients"] == \
        before["material_coefficients"] + 1
    assert after["material_coefficients_backward"] == \
        before["material_coefficients_backward"] + 1
    assert all(t.shape == (members, n) for t in got)
    assert grad.shape == params.shape
    plain = material_kernel.material_coefficients_backward_batched_reference(
        mid, inv_len, lfs, params, scales, widths, e, a, tuple(c))
    for b in range(members):
        lf = float(lfs[b])
        one = material_kernel.material_coefficients(
            mid, inv_len, lf, params[b], scales, widths)
        assert all(torch.equal(x[b], y) for x, y in zip(got, one)), b
        want = material_kernel.material_coefficients_batched_reference(
            mid, inv_len, lfs[b:b + 1], params[b:b + 1], scales, widths)
        for k, (x, y) in enumerate(zip(got, want)):
            torch.testing.assert_close(x[b], y[0],
                                       rtol=3e-5 if k == 3 else 2e-5,
                                       atol=1e-6)
        scale = float(plain[b].abs().max())
        assert float((grad[b] - plain[b]).abs().max()) <= 1e-5 * scale, b
        single = material_kernel.material_coefficients_backward(
            mid, inv_len, lf, params[b], scales, widths, e[b], a[b],
            tuple(c[:, b]))
        assert float((grad[b] - single).abs().max()) <= 1e-5 * scale, b
        if members == 1:
            assert torch.equal(grad[0], single)
    assert all(torch.equal(x, y) for x, y in zip(got, forward()))
    assert torch.equal(grad, backward())


def test_batched_material_dispatch_on_card(cuda_device):
    """fused_material_coefficients_batched on the card: one launch of each
    kernel for B = 4 members of the 16 x 72 grid, values and the (B, P)
    autograd gradient within the single kernel's bounds of the CPU twin's
    (material_coefficients_batched_reference) on the same inputs."""
    data = grid_problem(16, 72).to_device(cuda_device)
    mat = mlp_material(2, cuda_device)
    params, lfs = member_params(mat, 4, 9)
    c = torch.randn(4, 4, data.nelm, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))

    def run(dev):
        d = data if dev.type == "cuda" else grid_problem(16, 72).to_device(
            "cpu")
        th = params.to(dev).requires_grad_()
        out = material_kernel.fused_material_coefficients_batched(
            d, mat.to(dev), lfs.to(dev), th)
        loss = sum(torch.sum(ci.to(dev) * o) for ci, o in zip(c, out))
        return [o.detach().cpu() for o in out], \
            torch.autograd.grad(loss, th)[0].cpu()

    kernels.reset_launch_counts()
    got, g_got = run(cuda_device)
    counts = kernels.launch_counts()
    assert counts["material_coefficients"] == 1
    assert counts["material_coefficients_backward"] == 1
    want, g_want = run(torch.device("cpu"))
    for k, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=3e-5 if k == 3 else 2e-5,
                                   atol=1e-6)
    for b in range(4):
        scale = float(g_want[b].abs().max())
        assert float((g_got[b] - g_want[b]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("kind", ["thermal", "settlement"])
def test_truss_extension_documents_on_card(cuda_device, tmp_path, kind):
    """The 24 x 48 thermal and settlement documents (banded Newton)
    through the CLI on the card against the CPU run (the twins): both
    converge, u and the reactions within the grid's 1e-4 of each other's
    largest entry (each lies within 3.4e-5 of float64 on the CPU), the
    settled values kept exactly, and kernels 1-3 launched with one update
    per direction pass."""
    import json

    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.cli.generic import run

    doc = (eg.thermal_grid_document(24, 48, tolerance=1e-4, n_increments=1)
           if kind == "thermal" else
           eg.settlement_grid_document(24, 48, tolerance=1e-4))
    outs = {}
    for dev in ("cpu", "cuda"):
        path = tmp_path / f"{dev}.json"
        path.write_text(json.dumps(doc))
        kernels.reset_launch_counts()
        outs[dev] = run(str(path), device=dev)
        counts = kernels.launch_counts()
    for name in ("dia_matvec", "dia_dir_matvec", "cg_update"):
        assert counts[name] > 0, name
    assert counts["dia_dir_matvec"] == counts["cg_update"]
    cpu, card = outs["cpu"], outs["cuda"]
    assert cpu["converged"] is card["converged"] is True
    for key in ("displacements", "reactions"):
        want = np.asarray(cpu[key], float)
        np.testing.assert_allclose(card[key], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    if kind == "settlement":
        pd = doc["prescribed_displacements"]
        u = np.asarray(card["displacements"]).reshape(-1)
        assert np.all(u[pd["dofs"]] == np.float32(pd["values"][0]))


def test_x64_refused_at_kernel_dispatch_on_card(cuda_device, monkeypatch):
    """Under PINN_FEM_TPU_X64=1 a float64 tensor at the dispatch of
    kernels 1-3 (the banded Newton) or of kernels 4 / 4b (the material
    fields) raises one ValueError naming the variable and the kernel, and
    nothing launches; the dense Newton path runs in float64 on the card."""
    from pathlib import Path

    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import (parse_problem_dict,
                                              parse_problem_file)
    from pinn_fem_tpu_torch.ops.assembly import material_coefficients

    monkeypatch.setenv("PINN_FEM_TPU_X64", "1")
    kernels.reset_launch_counts()
    banded = grid_problem(24, 48)
    assert banded.ndof > 2048
    with pytest.raises(ValueError, match="PINN_FEM_TPU_X64") as err:
        T.solve_nr(banded, device=cuda_device)
    assert "dia_matvec" in str(err.value)

    parsed = parse_problem_dict(pinn_grid_document(4, 8))
    data = parsed.problem.to_device(cuda_device)
    assert data.loads.dtype == torch.float64
    with pytest.raises(ValueError, match="PINN_FEM_TPU_X64") as err:
        material_coefficients(data, parsed.problem.material.to(cuda_device),
                              1.0)
    assert "material_coefficients" in str(err.value)
    assert not any(kernels.launch_counts().values())

    example1 = Path(__file__).resolve().parents[1] / "examples" / "json" \
        / "example1.json"
    dense = parse_problem_file(example1).problem
    assert dense.to_device(cuda_device).loads.dtype == torch.float64
    result = T.solve_nr(dense, device=cuda_device)
    assert result.converged
    np.testing.assert_allclose(result.displacements.reshape(-1),
                               [0, 0, 1, 0, 2, 0, 3, 0], rtol=0, atol=1e-12)


def test_legacy_gd_launches_the_material_kernels_once_an_iteration(
        cuda_device):
    """solve_pinn_gradient_descent on the 8 x 16 PINN grid: one kernel 4
    and one kernel 4b launch per iteration; its first history row within
    1e-5 of the CPU run's (the twin), as chip_smoke.py holds the GD
    path's."""
    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict

    doc = pinn_grid_document(8, 16)
    cfg = T.PINNGradientDescentConfig(max_iterations=30, tolerance=0.0,
                                      learning_rate_u=1e-3,
                                      learning_rate_theta=1e-3)
    runs = {}
    for dev in ("cpu", cuda_device):
        parsed = parse_problem_dict(doc)
        kernels.reset_launch_counts()
        runs[str(dev)] = T.solve_pinn_gradient_descent(
            parsed.problem, parsed.problem.loads, parsed.measured_disp,
            parsed.measured_dofs, cfg, device=dev)
    counts = kernels.launch_counts()
    card = runs[str(cuda_device)]
    assert len(card.history) == 30
    assert counts["material_coefficients"] == 30
    assert counts["material_coefficients_backward"] == 30
    first_cpu = np.array(list(runs["cpu"].history[0].values()))
    first_card = np.array(list(card.history[0].values()))
    assert np.abs(first_card - first_cpu).max() <= 1e-5 * np.abs(
        first_cpu).max()


def test_gather_operator_on_card_equals_cpu(cuda_device):
    """The gather-based K u, diag(K) and PCG (ops/cg.py: torch ops, no
    repo kernel) on the card against the same functions on the CPU, on the
    shuffled 24 x 48 grid: K u and diag(K) within 1e-6 of the largest
    entry (float32 terms summed in float64 on both), the device-flag PCG
    loop to its tolerance with x within 1e-4 of the CPU's plain loop."""
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.ops import cg

    doc, _ = eg.shuffled_document(eg.grid_document(24, 48), seed=3)
    problem = parse_problem_dict(doc).problem
    rng = np.random.default_rng(3)
    u = torch.tensor(rng.standard_normal(problem.ndof), dtype=torch.float32)
    s = torch.tensor(rng.uniform(0.5, 2.0, problem.nelm),
                     dtype=torch.float32)
    b = torch.tensor(doc["loads"], dtype=torch.float32)
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        data = problem.to_device(dev)
        out[str(dev)] = (
            cg.apply_stiffness(data, s.to(dev), u.to(dev)).cpu(),
            cg.stiffness_diagonal(data, s.to(dev)).cpu(),
            cg.cg_solve(data, s.to(dev), b.to(dev), tol=1e-6,
                        max_iter=20_000))
    assert not any(kernels.launch_counts().values())
    cpu, card = out["cpu"], out[str(cuda_device)]
    for a, want in zip(card[:2], cpu[:2]):
        assert (a - want).abs().max() <= 1e-6 * want.abs().max()
    x_cpu, it_cpu, res_cpu = cpu[2]
    x_card, it_card, res_card = card[2]
    assert float(res_card) <= 1e-6 and float(res_cpu) <= 1e-6
    assert int(it_card) > 10 and int(it_cpu) > 10
    x_card = x_card.cpu()
    assert (x_card - x_cpu).abs().max() <= 1e-4 * x_cpu.abs().max()


def test_resume_on_card(cuda_device, tmp_path):
    """The 24 x 48 grid as an nr run on the card: the driver's state after
    increment 1, resumed, gives the uninterrupted run's u within 1e-5 of
    its largest entry, with kernels 1-3 launched for the one re-run
    increment only; the state on disk holds u in float64."""
    from pinn_fem_tpu_torch.utils.checkpoint import load_increment_state

    def run(n_increments, lf=1.0, **kw):
        cfg = T.SolverConfig(method="nr", tolerance=1e-5,
                             n_increments=n_increments, load_factor_final=lf)
        kernels.reset_launch_counts()
        res = T.solve(grid_problem(24, 48), cfg, verbose=False,
                      device=cuda_device, **kw)
        return res, kernels.launch_counts()

    whole, launches_whole = run(2)
    ckpt = str(tmp_path / "ckpt")
    run(1, 0.5, checkpoint_dir=ckpt)
    inc, u1, _ = load_increment_state(ckpt, [])
    assert inc == 1 and u1.dtype == np.float64
    resumed, launches = run(2, checkpoint_dir=ckpt, resume=True)
    assert resumed.converged and whole.converged
    want = whole.displacements
    assert np.abs(resumed.displacements - want).max() <= 1e-5 * np.abs(
        want).max()
    newton = int(resumed.history[0]["iterations"])
    assert launches["dia_matvec"] == 2 * newton + 1
    assert 0 < launches["cg_update"] < launches_whole["cg_update"]
    assert load_increment_state(ckpt, [])[0] == 2


@pytest.mark.parametrize("method", ["central", "newmark"])
def test_banded_transient_on_card_equals_cpu(cuda_device, method):
    """solve_transient on the 24 x 48 grid (2,304 DOFs, banded): central
    difference on kernel 1 (1 + n + 2 n / r launches with beta = 0) and
    Newmark on the fused PCG (kernels 2 and 3 once each per round), both
    against the CPU run (the twins): 1e-5 of max |u| for central, whose
    recurrence is kernel 1 and elementwise ops; 2e-3 for Newmark, whose
    PCG stops where the card's and the CPU's rounding leave it."""
    problem = grid_problem(24, 48)
    dt = T.stable_dt(problem, device=cuda_device)
    n, every = 100, 10
    kw = dict(n_steps=n, record_every=every, damping=(0.05, 0.0),
              method=method)
    if method == "newmark":
        dt, kw["damping"] = 8.0 * dt, (0.05, 1e-3)
    runs = {}
    for dev in ("cpu", cuda_device):
        kernels.reset_launch_counts()
        runs[str(dev)] = T.solve_transient(problem, dt, device=dev, **kw)
        counts = kernels.launch_counts()
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    assert counts["material_coefficients"] == 0
    if method == "central":
        assert counts["dia_matvec"] == 1 + n + 2 * n // every
        assert counts["dia_dir_matvec"] == counts["cg_update"] == 0
        bound = 1e-5
    else:
        assert counts["dia_dir_matvec"] == counts["cg_update"] > 0
        assert counts["cg_update"] % 32 == 0
        bound = 2e-3
    scale = np.abs(cpu.displacements).max()
    np.testing.assert_allclose(card.displacements, cpu.displacements,
                               rtol=0, atol=bound * scale)


def test_x64_banded_transient_refused_on_card(cuda_device, monkeypatch):
    """Under PINN_FEM_TPU_X64=1 a banded transient on the card raises the
    ValueError that names PINN_FEM_TPU_X64 and kernel 1; nothing
    launches."""
    monkeypatch.setenv("PINN_FEM_TPU_X64", "1")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="PINN_FEM_TPU_X64") as err:
        T.solve_transient(grid_problem(24, 48), 0.1, 10, device=cuda_device)
    assert "dia_matvec" in str(err.value)
    assert not any(kernels.launch_counts().values())


def test_mg_on_card_equals_plain_cycle_and_cpu(cuda_device):
    """The multigrid (ops/mg.py) on the card: every level's matvec is
    kernel 1, bit-equal to its twin, so the V-cycle equals the plain cycle
    on the same hierarchy; the MG-PCG launches kernel 1 exactly
    (1 + V)(1 + iterations) times and lands within 1e-3 of max |x| of the
    CPU solve (two solves that each meet tol 1e-6 differ by up to cond(K)
    times that), and the hierarchy within 1e-5 of the CPU's."""
    from pinn_fem_tpu_torch.ops import mg
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve

    data, layout, d = system("grid16x72", cuda_device)
    h = mg.build_hierarchy(layout, d, data.free_mask, components=2)
    h_cpu = mg.build_hierarchy(layout, d.cpu(), data.free_mask.cpu(),
                               components=2)
    for lvl, ref in zip(h.levels, h_cpu.levels):
        assert lvl.offsets == ref.offsets and lvl.ndof == ref.ndof
        scale = float(ref.diags.abs().max())
        assert float((lvl.diags.cpu() - ref.diags).abs().max()) \
            <= 1e-5 * scale
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b = torch.randn(layout.ndof, device=cuda_device, generator=gen)
    kernels.reset_launch_counts()
    v = mg.v_cycle(h, b)
    assert kernels.launch_counts()["dia_matvec"] == mg.cycle_matvecs(h)
    assert torch.equal(v, mg.v_cycle_reference(h, b))

    kernels.reset_launch_counts()
    x, it, res = dia_cg_solve(layout, d, data.loads, data.free_mask,
                              tol=1e-6, precond="mg", components=2)
    counts = kernels.launch_counts()
    assert counts["dia_matvec"] == (1 + mg.cycle_matvecs(h)) * (1 + int(it))
    assert counts["dia_dir_matvec"] == counts["cg_update"] == 0
    x_cpu, _, _ = dia_cg_solve(layout, d.cpu(), data.loads.cpu(),
                               data.free_mask.cpu(), tol=1e-6, precond="mg",
                               components=2)
    assert float(res) <= 1e-6
    assert float((x.cpu() - x_cpu).abs().max()) \
        <= 1e-3 * float(x_cpu.abs().max())


def test_x64_mg_refused_on_card(cuda_device, monkeypatch):
    """A float64 CUDA operand on the multigrid path (dia_cg_solve and the
    banded Newton) raises the ValueError naming PINN_FEM_TPU_X64 and
    kernel 1; nothing launches."""
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve

    data, layout, d = system("grid16x72", cuda_device)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="PINN_FEM_TPU_X64") as err:
        dia_cg_solve(layout, d.double(), data.loads.double(),
                     data.free_mask.double(), precond="mg", components=2)
    assert "dia_matvec" in str(err.value)
    monkeypatch.setenv("PINN_FEM_TPU_X64", "1")
    with pytest.raises(ValueError, match="PINN_FEM_TPU_X64") as err:
        T.solve_nr(grid_problem(24, 48), linear_solver="cg-dia",
                   cg_precond="mg", device=cuda_device)
    assert "dia_matvec" in str(err.value)
    assert not any(kernels.launch_counts().values())


def spy_solves(monkeypatch):
    """Records (args, kwargs, result) of every ops.dia.dia_cg_solve call,
    the banded eigensolvers' block solves included."""
    from pinn_fem_tpu_torch.ops import dia

    calls, inner = [], dia.dia_cg_solve

    def spy(*args, **kwargs):
        result = inner(*args, **kwargs)
        calls.append((args, kwargs, result))
        return result

    monkeypatch.setattr(dia, "dia_cg_solve", spy)
    return calls


def pcg_rounds(calls) -> int:
    """Kernels 2 and 3's launches over fused PCG solves: the loop runs in
    whole rounds of CHECK_EVERY iterations until its flag read finds the
    solve stopped."""
    every = cg_kernel.CHECK_EVERY
    return sum(every * -(-int(res[1]) // every) for _, _, res in calls)


def check_block_solve_against_twin(calls):
    """The last block solve again on the twin recurrence, on the card:
    the same iterations and x bit for bit."""
    args, kwargs, (x, it, _) = calls[-1]
    x_twin, it_twin, _ = kernels.fused_cg_solve_reference(*args, **kwargs)
    assert int(it) == int(it_twin) and torch.equal(x, x_twin)


def test_banded_modal_on_card(cuda_device, monkeypatch):
    """modal_analysis on the 6 x 12 grid (144 DOFs) with DENSE_DOF_LIMIT
    below it: each of the n_iter x k block solves is one fused PCG
    (kernel 1 for its warm start, kernels 2-3 in whole rounds), the
    residual check one kernel 1 a mode; a block solve bit-equal to the
    twin recurrence; eigenvalues within 1e-3 of the CPU run (the plain
    recurrence) and of the dense float64 path."""
    from pinn_fem_tpu_torch.solvers import newton

    problem = grid_problem(6, 12)
    dense = T.modal_analysis(problem, n_modes=3, device=cuda_device)
    monkeypatch.setattr(newton, "DENSE_DOF_LIMIT", 64)
    calls = spy_solves(monkeypatch)
    n_modes, n_iter, k = 3, 12, 10
    kernels.reset_launch_counts()
    card = T.modal_analysis(problem, n_modes=n_modes, n_iter=n_iter,
                            device=cuda_device)
    counts = kernels.launch_counts()
    assert len(calls) == n_iter * k
    assert counts["dia_matvec"] == n_iter * k + n_modes
    assert counts["dia_dir_matvec"] == counts["cg_update"] == pcg_rounds(
        calls)
    assert counts["material_coefficients"] == 0
    check_block_solve_against_twin(calls)
    cpu = T.modal_analysis(problem, n_modes=n_modes, n_iter=n_iter,
                           device="cpu")
    np.testing.assert_allclose(card.eigenvalues, cpu.eigenvalues, rtol=1e-3)
    np.testing.assert_allclose(card.eigenvalues, dense.eigenvalues,
                               rtol=1e-3)
    assert card.ok


def test_banded_buckling_on_card(cuda_device, monkeypatch):
    """buckling_analysis on the 4 x 16 compressed grid strip (128 DOFs)
    with DENSE_DOF_LIMIT below it: the base state one fused PCG from
    zero (no kernel 1), then per iteration k block solves and 3k banded
    block products (kernel 1 each); a block solve bit-equal to the twin
    recurrence; the critical factor within 1e-3 of the CPU run and of the
    dense float64 path."""
    from pinn_fem_tpu_torch.solvers import newton

    problem = compressed_strip(4, 16)
    dense = T.buckling_analysis(problem, n_modes=1, device=cuda_device)
    monkeypatch.setattr(newton, "DENSE_DOF_LIMIT", 64)
    calls = spy_solves(monkeypatch)
    n_iter, k = 20, 6
    kernels.reset_launch_counts()
    card = T.buckling_analysis(problem, n_modes=1, n_iter=n_iter,
                               device=cuda_device)
    counts = kernels.launch_counts()
    assert len(calls) == 1 + n_iter * k
    assert counts["dia_matvec"] == 4 * n_iter * k
    assert counts["dia_dir_matvec"] == counts["cg_update"] == pcg_rounds(
        calls)
    check_block_solve_against_twin(calls)
    cpu = T.buckling_analysis(problem, n_modes=1, n_iter=n_iter,
                              device="cpu")
    np.testing.assert_allclose(card.load_factors, cpu.load_factors,
                               rtol=1e-3)
    np.testing.assert_allclose(card.load_factors, dense.load_factors,
                               rtol=1e-3)
    assert card.ok


def test_x64_banded_eigensolvers_refused_on_card(cuda_device, monkeypatch):
    """Float64 CUDA operands on the banded modal and buckling paths raise
    the ValueError naming PINN_FEM_TPU_X64 and kernels 1-3; nothing
    launches."""
    from pinn_fem_tpu_torch.solvers import newton

    monkeypatch.setattr(newton, "DENSE_DOF_LIMIT", 64)
    problem = grid_problem(6, 12)
    data = problem.to_device(cuda_device, torch.float64)
    kernels.reset_launch_counts()
    for fn in (T.modal_analysis, T.buckling_analysis):
        with pytest.raises(ValueError, match="PINN_FEM_TPU_X64") as err:
            fn(problem, n_modes=2, data=data)
        assert "kernels 1-3" in str(err.value)
    assert not any(kernels.launch_counts().values())


def test_plane_banded_statics_on_card(cuda_device):
    """solve_plane_static_banded on the 16 x 64 strip (21 diagonals):
    kernels 2 and 3 launch 32 ceil(iterations / 32) times, kernel 1 once,
    u within 1e-4 of the CPU run."""
    from pinn_fem_tpu_torch.examples_grid import plane_strip_document
    from pinn_fem_tpu_torch.io.plane_io import parse_plane_document

    problem, _ = parse_plane_document(plane_strip_document(16, 64))
    kernels.reset_launch_counts()
    card, iters, rel = T.models.plane.solve_plane_static_banded(
        problem, device=cuda_device)
    counts = kernels.launch_counts()
    rounds = 32 * -(-iters // 32)
    assert counts["dia_dir_matvec"] == counts["cg_update"] == rounds
    assert counts["dia_matvec"] == 1 and rel <= 1e-7
    cpu, _, _ = T.models.plane.solve_plane_static_banded(problem,
                                                         device="cpu")
    scale = np.abs(cpu.displacements).max()
    assert np.abs(card.displacements - cpu.displacements).max() \
        <= 1e-4 * scale


def test_plane_dense_analyses_on_card(cuda_device):
    """plane_modal and solve_plane_static in float64 on the card equal the
    CPU runs at 1e-10 (mode shapes sign-aligned); no repo kernel runs."""
    from pinn_fem_tpu_torch.examples_grid import plane_strip_document
    from pinn_fem_tpu_torch.io.plane_io import parse_plane_document

    problem, _ = parse_plane_document(plane_strip_document(8, 16))
    kernels.reset_launch_counts()
    card = T.plane_modal(problem, 4, device=cuda_device)
    stat = T.solve_plane_static(problem, device=cuda_device)
    assert not any(kernels.launch_counts().values())
    cpu = T.plane_modal(problem, 4, device="cpu")
    np.testing.assert_allclose(card.eigenvalues, cpu.eigenvalues,
                               rtol=1e-10)
    s = np.sign(np.sum(card.mode_shapes * cpu.mode_shapes, axis=1))
    np.testing.assert_allclose(card.mode_shapes * s[:, None],
                               cpu.mode_shapes, atol=1e-10)
    np.testing.assert_allclose(
        stat.displacements,
        T.solve_plane_static(problem, device="cpu").displacements,
        rtol=1e-10, atol=1e-14)


def test_solid_banded_statics_on_card(cuda_device):
    """solve_solid_static_banded on the 4 x 4 x 12 column (99 diagonals,
    bandwidth 95): kernels 2 and 3 launch 32 ceil(iterations / 32) times,
    kernel 1 once, u within 1e-4 of the CPU run and the closed form u_z =
    sigma z / E within 2e-3."""
    from pinn_fem_tpu_torch.examples_grid import solid_column_document
    from pinn_fem_tpu_torch.io.solid_io import parse_solid_document

    problem, _ = parse_solid_document(solid_column_document(4, 4, 12))
    kernels.reset_launch_counts()
    card, iters, rel = T.solve_solid_static_banded(problem, tol=1e-7,
                                                   device=cuda_device)
    counts = kernels.launch_counts()
    rounds = 32 * -(-iters // 32)
    assert counts["dia_dir_matvec"] == counts["cg_update"] == rounds
    assert counts["dia_matvec"] == 1 and rel <= 1e-7
    cpu, _, _ = T.solve_solid_static_banded(problem, tol=1e-7, device="cpu")
    scale = np.abs(cpu.displacements).max()
    assert np.abs(card.displacements - cpu.displacements).max() \
        <= 1e-4 * scale
    uz = card.displacements[2::3]
    assert np.abs(uz - 5.0 * problem.nodes[:, 2] / 200.0).max() \
        <= 2e-3 * 5.0 * 4.0 / 200.0


def test_solid_central_step_on_card(cuda_device):
    """One central-difference step of solve_solid_transient_banded (beta =
    0, recorded at once: 1 + 1 + 2 launches of kernel 1) on the card
    against the CPU run within 1e-5 of max |u|."""
    from pinn_fem_tpu_torch.examples_grid import solid_column_document
    from pinn_fem_tpu_torch.io.solid_io import parse_solid_document

    problem, _ = parse_solid_document(solid_column_document(4, 4, 12))
    dt = T.solid_stable_dt(problem, device="cpu")
    kernels.reset_launch_counts()
    card = T.solve_solid_transient_banded(problem, dt, 1,
                                          device=cuda_device)
    assert kernels.launch_counts()["dia_matvec"] == 4
    cpu = T.solve_solid_transient_banded(problem, dt, 1, device="cpu")
    scale = np.abs(cpu.displacements).max()
    assert scale > 0
    assert np.abs(card.displacements - cpu.displacements).max() \
        <= 1e-5 * scale


FRAME_OPERATORS = {
    "frame_tower": ("frame_tower_document", (8, 4), "frame",
                    "parse_frame_document", "solve_frame_static_banded",
                    "solve_frame_static"),
    "frame3d_grid": ("space_frame_grid_document", (6, 2, 3), "frame3d",
                     "parse_frame3d_document",
                     "solve_space_frame_static_banded",
                     "solve_space_frame_static"),
}


@pytest.mark.parametrize("name", list(FRAME_OPERATORS))
def test_frame_banded_statics_on_card(cuda_device, name):
    """The banded statics of the 2D tower (3 DOFs a node) and the space
    skeleton (6): kernels 2 and 3 launch 32 ceil(iterations / 32) times,
    kernel 1 once, u within 1e-3 of the CPU run and of the float64 dense
    solve."""
    import importlib

    from pinn_fem_tpu_torch import examples_grid

    make, size, family, parse, banded, dense = FRAME_OPERATORS[name]
    io = importlib.import_module(f"pinn_fem_tpu_torch.io.{family}_io")
    model = importlib.import_module(f"pinn_fem_tpu_torch.models.{family}")
    problem, _ = getattr(io, parse)(getattr(examples_grid, make)(*size))
    kernels.reset_launch_counts()
    card, iters, rel = getattr(model, banded)(problem, tol=1e-8,
                                              device=cuda_device)
    counts = kernels.launch_counts()
    rounds = 32 * -(-iters // 32)
    assert counts["dia_dir_matvec"] == counts["cg_update"] == rounds
    assert counts["dia_matvec"] == 1 and rel <= 1e-8
    cpu = getattr(T, dense)(problem, device="cpu")
    scale = np.abs(cpu.displacements).max()
    assert np.abs(card.displacements - cpu.displacements).max() \
        <= 1e-3 * scale


def test_frame_dense_analyses_on_card(cuda_device):
    """The frame families' dense float64 analyses on the card (statics,
    modal with prestress, buckling, the pushover, a space-frame modal)
    equal the CPU runs at 1e-10 (shapes sign-aligned; the square
    skeleton's degenerate sway pair by its projector); no repo kernel
    runs."""
    from pinn_fem_tpu_torch.examples_grid import (frame_tower_document,
                                                  space_frame_grid_document)
    from pinn_fem_tpu_torch.io.frame3d_io import parse_frame3d_document
    from pinn_fem_tpu_torch.io.frame_io import parse_frame_document

    tower, _ = parse_frame_document(frame_tower_document(4, 3))
    grid, _ = parse_frame3d_document(space_frame_grid_document(3, 2, 2))
    tower.loads[1::3] -= 500.0 * (tower.nodes[:, 1] > 0)

    def space_modal(device):
        res = T.space_frame_modal(grid, 3, device=device)
        return res.eigenvalues, res.mode_shapes.T @ res.mode_shapes

    runs = {
        "static": lambda d: T.solve_frame_static(tower, device=d)
        .displacements,
        "modal": lambda d: T.frame_modal(
            tower, 4, prestress_u=T.solve_frame_static(
                tower, device="cpu").displacements, device=d).mode_shapes,
        "buckling": lambda d: T.frame_buckling(tower, 2, device=d).modes,
        "pushover": lambda d: T.frame_pushover(tower, 2e4,
                                               device=d).displacements,
        "space_eigenvalues": lambda d: space_modal(d)[0],
        "space_projector": lambda d: space_modal(d)[1],
    }
    kernels.reset_launch_counts()
    card = {k: fn(cuda_device) for k, fn in runs.items()}
    assert not any(kernels.launch_counts().values())
    for k, fn in runs.items():
        cpu = fn("cpu")
        got = card[k]
        if k in ("modal", "buckling"):
            got = got * np.sign(np.sum(got * cpu, axis=1))[:, None]
        assert np.abs(got - cpu).max() <= 1e-10 * np.abs(cpu).max(), k


def plate_square(n: int, t: float):
    from pinn_fem_tpu_torch.io.plate_io import parse_plate_document

    return parse_plate_document({
        "element_type": "plate",
        "mesh": {"type": "rect", "width": 1.0, "height": 1.0, "nx": n,
                 "ny": n},
        "material": {"young": 2e11, "poisson": 0.3, "thickness": t,
                     "density": 7850.0},
        "pressure": -1000.0,
        "supports": {"simply_supported": ["left", "right", "bottom",
                                          "top"]}})[0]


def test_plate_banded_statics_on_card(cuda_device):
    """The plate's banded statics (33 diagonals, 3 DOFs a node): kernels 2
    and 3 launch 32 ceil(iterations / 32) times, kernel 1 once, u within
    1e-3 of the CPU's dense float64 solve."""
    problem = plate_square(24, 0.05)
    kernels.reset_launch_counts()
    card, iters, rel = T.solve_plate_static_banded(problem, tol=1e-8,
                                                   device=cuda_device)
    counts = kernels.launch_counts()
    rounds = 32 * -(-iters // 32)
    assert counts["dia_dir_matvec"] == counts["cg_update"] == rounds
    assert counts["dia_matvec"] == 1 and rel <= 1e-8
    cpu = T.solve_plate_static(problem, device="cpu")
    scale = np.abs(cpu.displacements).max()
    assert np.abs(card.displacements - cpu.displacements).max() \
        <= 1e-3 * scale


def test_plate_dense_analyses_on_card(cuda_device):
    """The plate's dense float64 analyses on the card (statics, modal with
    a membrane prestress as eigenvalues and cluster projectors, buckling,
    the plastic float64 tier) equal the CPU runs at 1e-10; no repo
    kernel runs."""
    problem = plate_square(8, 0.05)
    mass = T.plate_matrices(problem, device="cpu")[1].numpy()

    def modal(device):
        res = T.plate_modal(problem, 6, membrane_force=[-1e4, 0.0, 0.0],
                            device=device)
        return res.eigenvalues, res.mode_shapes.T @ res.mode_shapes @ mass

    runs = {
        "static": lambda d: T.solve_plate_static(problem, device=d)
        .displacements,
        "eigenvalues": lambda d: modal(d)[0],
        "projector": lambda d: modal(d)[1],
        "buckling": lambda d: T.plate_buckling(problem, [-1.0, 0.0, 0.0],
                                               n_modes=1, device=d)
        .load_factors,
        "plastic": lambda d: T.solve_plate_plastic(
            problem, sigma_y=2e8, n_layers=4, n_steps=3,
            target_load_factor=30.0, device=d).displacements,
    }
    kernels.reset_launch_counts()
    card = {k: fn(cuda_device) for k, fn in runs.items()}
    assert not any(kernels.launch_counts().values())
    for k, fn in runs.items():
        cpu = fn("cpu")
        assert np.abs(card[k] - cpu).max() <= 1e-10 * np.abs(cpu).max(), k


def test_continuum_spectrum_on_card(cuda_device):
    """Spectrum (CQC), random and Dirlik fatigue of a plane wall and a
    plate on the card equal the CPU runs at 1e-10 (participations by
    magnitude); no repo kernel runs."""
    from pinn_fem_tpu_torch.io.plane_io import parse_plane_document

    wall = parse_plane_document({
        "element_type": "plane",
        "mesh": {"type": "rect", "width": 4.0, "height": 8.0, "nx": 4,
                 "ny": 8},
        "material": {"young": 200.0, "poisson": 0.3, "thickness": 0.5,
                     "density": 2.0},
        "fixed_nodes": "bottom",
        "edge_loads": [{"nodes": "top", "traction": [1.0, 0.0]}]})[0]
    om = np.linspace(0.05, 2.0, 16)
    runs = {}
    for name, problem in (("wall", wall), ("plate", plate_square(6, 0.05))):
        runs[f"{name}_spectrum"] = lambda d, p=problem: (
            lambda r: np.concatenate([r.displacements, r.von_mises,
                                      np.abs(r.participation)]))(
            T.continuum_response_spectrum(p, 2.5, n_modes=4,
                                          combination="cqc", device=d))
        runs[f"{name}_random"] = lambda d, p=problem: \
            T.continuum_random_response(p, 1.0, om * (
                1.0 if p is wall else 2e3), damping=(0.02, 0.001),
                device=d).rms
        runs[f"{name}_fatigue"] = lambda d, p=problem: \
            T.continuum_spectral_fatigue(
                p, 1.0, om * (1.0 if p is wall else 2e3),
                damping=(0.02, 0.001), sn_exponent=3.0,
                sn_coefficient=1e12, device=d).fatigue.damage_rate
    kernels.reset_launch_counts()
    card = {k: fn(cuda_device) for k, fn in runs.items()}
    assert not any(kernels.launch_counts().values())
    for k, fn in runs.items():
        cpu = fn("cpu")
        assert np.abs(card[k] - cpu).max() <= 1e-10 * np.abs(cpu).max(), k


def shell_roof(n: int, t: float = 0.25):
    """dyn-shell.json's Scordelis-Lo roof on an n x n mesh."""
    import json
    from pathlib import Path

    from pinn_fem_tpu_torch.io.shell_io import parse_shell_document

    doc = json.loads((Path(__file__).resolve().parents[1] / "examples"
                      / "json" / "dyn-shell.json").read_text())
    doc["mesh"].update(nx=n, ny=n)
    doc["material"]["thickness"] = t
    return parse_shell_document(doc)[0]


def test_shell_banded_paths_on_card(cuda_device):
    """The shell's banded statics (69 diagonals, 6 DOFs a node): kernels 2
    and 3 launch 32 ceil(iterations / 32) times, kernel 1 once, u within
    1e-3 of the CPU twins' run; the banded Marguerre Newton on a
    16-element von Karman strip: kernel 1 never, kernels 2 and 3 the sum
    of 32 ceil(it / 32) over its PCG solves, u within 1e-3 of the CPU
    twins' run."""
    from pinn_fem_tpu_torch.models.shell import solve_shell_static_banded
    from pinn_fem_tpu_torch.solvers import shell_nonlinear as SN

    problem = shell_roof(12, t=1.0)
    kernels.reset_launch_counts()
    card, iters, rel = solve_shell_static_banded(problem, tol=1e-7,
                                                 device=cuda_device)
    counts = kernels.launch_counts()
    rounds = 32 * -(-iters // 32)
    assert counts["dia_dir_matvec"] == counts["cg_update"] == rounds
    assert counts["dia_matvec"] == 1 and rel <= 1e-7
    cpu, _, _ = solve_shell_static_banded(problem, tol=1e-7, device="cpu")
    scale = np.abs(cpu.displacements).max()
    assert np.abs(card.displacements - cpu.displacements).max() \
        <= 1e-3 * scale

    nodes, el = T.arch_strip_mesh(4.0, 1.0, 0.0, 16)
    n = len(nodes)
    ends = np.flatnonzero((nodes[:, 0] < 1e-9) | (nodes[:, 0] > 4.0 - 1e-9))
    strip = T.ShellProblem(
        nodes=nodes, elements=el, young=2e5, poisson=0.0, thickness=0.1,
        density=1.0, loads=np.zeros(6 * n),
        fixed_dofs=np.union1d((6 * ends[:, None] + np.arange(3)).ravel(),
                              6 * np.arange(n) + 3), pressure=-0.1)
    lfs = [0.5, 1.0]
    its = []
    inner = SN.dia_cg_solve

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        its.append(int(out[1]))
        return out

    SN.dia_cg_solve = counted
    try:
        kernels.reset_launch_counts()
        card = T.solve_shell_nonlinear_banded(strip, load_factors=lfs,
                                              device=cuda_device)
        counts = kernels.launch_counts()
    finally:
        SN.dia_cg_solve = inner
    rounds = sum(32 * -(-it // 32) for it in its)
    assert card.converged and counts["dia_matvec"] == 0
    assert counts["dia_dir_matvec"] == counts["cg_update"] == rounds
    cpu = T.solve_shell_nonlinear_banded(strip, load_factors=lfs,
                                         device="cpu")
    scale = np.abs(cpu.displacements).max()
    assert np.abs(card.displacements - cpu.displacements).max() \
        <= 1e-3 * scale


def test_shell_dense_analyses_on_card(cuda_device):
    """The shell's dense float64 analyses on the card (statics, modal as
    eigenvalues and cluster projectors, buckling under its own membrane
    state, the Marguerre Newton and Riks on a half-sine arch) equal the
    CPU runs at 1e-10, dyn-shell-plastic's float64 tier at its Newton
    tolerance, 1e-9; no repo kernel runs."""
    import json
    from pathlib import Path

    from pinn_fem_tpu_torch.io.shell_io import parse_shell_document

    problem = shell_roof(4)
    mass = T.shell_matrices(problem, device="cpu")[1].numpy()
    nodes, el = T.arch_strip_mesh(4.0, 1.0, 0.15, 8)
    n = len(nodes)
    ends = np.flatnonzero((nodes[:, 0] < 1e-9) | (nodes[:, 0] > 4.0 - 1e-9))
    arch = T.ShellProblem(
        nodes=nodes, elements=el, young=2e5, poisson=0.0, thickness=0.1,
        density=1.0, loads=np.zeros(6 * n),
        fixed_dofs=np.union1d((6 * ends[:, None] + np.arange(3)).ravel(),
                              6 * np.arange(n) + 3), pressure=-1.0)
    doc = json.loads((Path(__file__).resolve().parents[1] / "examples"
                      / "json" / "dyn-shell-plastic.json").read_text())
    strip = parse_shell_document(doc)[0]

    def modal(device):
        res = T.shell_modal(problem, 6, device=device)
        return res.eigenvalues, res.mode_shapes.T @ res.mode_shapes @ mass

    runs = {
        "static": lambda d: T.solve_shell_static(problem, device=d)
        .displacements,
        "eigenvalues": lambda d: modal(d)[0],
        "projector": lambda d: modal(d)[1],
        "buckling": lambda d: T.shell_buckling(problem, n_modes=2,
                                               device=d).load_factors,
        "newton": lambda d: T.solve_shell_nonlinear(
            arch, load_factors=[0.5, 1.0], device=d).displacements,
        "riks": lambda d: T.solve_shell_riks(arch, n_steps=12, dl0=0.02,
                                             device=d).load_factors,
        "plastic": lambda d: T.solve_shell_plastic(
            strip, sigma_y=300.0, n_layers=20,
            load_factors=doc["analysis"]["load_factors"],
            device=d).displacements,
    }
    kernels.reset_launch_counts()
    card = {k: fn(cuda_device) for k, fn in runs.items()}
    assert not any(kernels.launch_counts().values())
    for k, fn in runs.items():
        cpu = fn("cpu")
        bound = 1e-9 if k == "plastic" else 1e-10
        assert np.abs(card[k] - cpu).max() <= bound * np.abs(cpu).max(), k
