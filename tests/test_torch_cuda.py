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
once.
"""

import numpy as np
import pytest
import torch

import pinn_fem_tpu_torch as T

from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
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
