"""The backward kernel's plain version (4b) against the JAX package, on the
CPU.

`material_coefficients_backward_reference` (ops/kernels/material_kernel.py)
does what the CUDA backward does: it recomputes each net's activations and
deltas, sums the parameter terms over each tile's row slices in float32 and
adds those sums in float64 in the kernel's tile, slice, block and group
order, skipping nets without an upstream gradient.  Here it is held to
jax.grad of the JAX package's material_values (the XLA form) and to the
port's autograd twin, within 1e-5 of the largest gradient entry, on
weights drawn by JAX and handed over with material_from_numpy and inputs
made by numpy from a seed.  The kernel itself is held to it on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
from pinn_fem_tpu.models.fields import assembly_inputs as j_inputs  # noqa: E402
from pinn_fem_tpu.ops.assembly import material_values as j_material_values  # noqa: E402
from pinn_fem_tpu.ops.cg import stiffness_coefficients as j_coeffs  # noqa: E402
from pinn_fem_tpu_torch.ops import kernels  # noqa: E402
from pinn_fem_tpu_torch.ops.kernels import material_kernel as tmk  # noqa: E402
from pinn_fem_tpu_torch.solvers.gd import get_theta  # noqa: E402
from test_torch_material import both_data, both_materials  # noqa: E402

LF = 0.7
BOUND = 1e-5   # of max |grad|: float32 sums in another order
ALL = (0, 1, 2, 3)
S_ONLY = (3,)


def flat_inputs(tmat, td):
    fields = tmk._fields(tmat)
    params = torch.cat([t.reshape(-1) for f in fields
                        for t in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields])
    e, a, _, _ = tmk.material_coefficients_reference(td.mid, td.inv_len, LF,
                                                     tmat)
    return params, scales, tmk._widths(tmat), e, a


def upstream(n, which, seed=3):
    c = np.random.default_rng(seed).normal(size=(4, n)).astype(np.float32)
    return c, [torch.from_numpy(c[k]) if k in which else None
               for k in range(4)]


def jax_grad(jmat, jd, c, which):
    """jax.grad of sum_k c_k * field_k over the JAX layers, flattened in
    theta order (net by net, W then b per layer)."""
    def loss(layers):
        mat = J.Material(young=jmat.young.replace(layers=layers[0]),
                         area=jmat.area.replace(layers=layers[1]),
                         density=jmat.density.replace(layers=layers[2]))
        e, a = j_material_values(jd, mat, LF)
        rho = mat.density.eval_batch(j_inputs(jd.mid, 2, LF))
        s = j_coeffs(jd, mat, LF)
        return sum(jnp.sum(c[k] * v) for k, v in enumerate((e, a, rho, s))
                   if k in which)

    layers = [f.layers for f in (jmat.young, jmat.area, jmat.density)]
    grads = jax.grad(loss)(layers)
    return np.concatenate([np.asarray(t).reshape(-1) for net in grads
                           for layer in net for t in layer])


def twin_grad(tmat, td, c, which):
    """The autograd twin's gradient, flattened in theta order."""
    theta = [t for layers in get_theta(tmat) for layer in layers
             for t in layer]
    for t in theta:
        t.requires_grad_(True)
    out = tmk.material_coefficients_reference(td.mid, td.inv_len, LF, tmat)
    loss = sum(torch.sum(torch.from_numpy(c[k]) * out[k]) for k in which)
    grads = torch.autograd.grad(loss, theta, allow_unused=True)
    for t in theta:
        t.requires_grad_(False)
    return torch.cat([torch.zeros_like(t).reshape(-1) if g is None
                      else g.reshape(-1) for t, g in zip(theta, grads)])


@pytest.mark.parametrize("hidden_layers", [1, 2])
@pytest.mark.parametrize("n_nodes", [778, 301, 51])
@pytest.mark.parametrize("which", [ALL, S_ONLY])
def test_plain_backward_matches_jax_grad_and_twin(hidden_layers, n_nodes,
                                                  which):
    """777 and 300 elements (not tile multiples) and 50 (below one tile),
    one and two hidden layers, all four upstream gradients or s alone."""
    jmat, tmat = both_materials(hidden_layers=hidden_layers)
    jd, td = both_data(jmat, tmat, n_nodes=n_nodes)
    params, scales, widths, e, a = flat_inputs(tmat, td)
    c, grads = upstream(td.nelm, which)
    before = kernels.launch_counts()
    got = tmk.material_coefficients_backward_reference(
        td.mid, td.inv_len, LF, params, scales, widths, e, a, grads)
    assert kernels.launch_counts() == before
    assert got.shape == params.shape and got.dtype == torch.float32
    want = jax_grad(jmat, jd, c, which)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BOUND * scale)
    np.testing.assert_allclose(got.numpy(), twin_grad(tmat, td, c, which)
                               .numpy(), rtol=0, atol=BOUND * scale)


@pytest.mark.parametrize("hidden_layers", [1, 2])
def test_s_only_skips_density_exactly(hidden_layers):
    """With gs alone the density block is exact zeros, and the rest equals
    the full computation given zero gE, gA and grho, bit for bit."""
    jmat, tmat = both_materials(hidden_layers=hidden_layers)
    _, td = both_data(jmat, tmat, n_nodes=301)
    params, scales, widths, e, a = flat_inputs(tmat, td)
    _, grads = upstream(td.nelm, S_ONLY)
    got = tmk.material_coefficients_backward_reference(
        td.mid, td.inv_len, LF, params, scales, widths, e, a, grads)
    zero = torch.zeros(td.nelm)
    full = tmk.material_coefficients_backward_reference(
        td.mid, td.inv_len, LF, params, scales, widths, e, a,
        [zero, zero, zero, grads[3]])
    n_density = tmat.density.n_params()
    assert bool((got[-n_density:] == 0).all())
    assert bool((full[-n_density:] == 0).all())
    assert torch.equal(got, full)
    assert float(got[:-n_density].abs().max()) > 0
    # No upstream at all: every net skipped, the gradient is zeros.
    none = tmk.material_coefficients_backward_reference(
        td.mid, td.inv_len, LF, params, scales, widths, e, a,
        [None] * 4)
    assert torch.equal(none, torch.zeros_like(params))


def kernel_order_emulation(td, params, scales, widths, e, a, grads, blocks):
    """The kernel's partition emulated in numpy: per net, each element's
    parameter terms (float32); block b takes elements [b n / B, (b + 1) n /
    B), TILE at a time; each row slice of a tile is summed in row order in
    float32, then in float64 over the block's tiles in tile order per
    slice, the slices in slice order, the blocks of each group in block
    order and the groups in group order."""
    x = tmk._kernel_inputs(td.mid, LF).numpy()
    n = x.shape[0]
    size = math.isqrt(blocks - 1) + 1 if blocks > 1 else 1
    out = np.zeros(params.numel(), np.float32)
    on = tmk._nets_on(grads)
    g = [None if t is None else t.numpy() for t in grads]
    p_all = params.numpy()
    for f, (h1, h2, off, count) in enumerate(tmk._nets(widths)):
        if not on[f]:
            continue
        p = p_all[off:off + count]
        w1, b1, q = p[:3 * h1].reshape(3, h1), p[3 * h1:4 * h1], p[4 * h1:]
        a1 = np.tanh(x @ w1 + b1)
        last = a1
        if h2:
            w2, b2, q = (q[:h1 * h2].reshape(h1, h2), q[h1 * h2:h1 * h2 + h2],
                         q[h1 * h2 + h2:])
            a2 = last = np.tanh(a1 @ w2 + b2)
        o = last @ q[:-1] + q[-1]
        if f == 2:
            dv = g[2]
        else:
            dv = g[f] if g[f] is not None else np.zeros(n, np.float32)
            if g[3] is not None:
                dv = dv + g[3] * (a if f == 0 else e).numpy() * \
                    td.inv_len.numpy()
        d_out = dv * (1 / (1 + np.exp(-o))) * scales[f].item()
        if h2:
            d2 = d_out[:, None] * q[:-1] * (1 - a2 * a2)
            d1 = (d2 @ w2.T) * (1 - a1 * a1)
            parts = [x[:, :, None] * d1[:, None, :], d1,
                     a1[:, :, None] * d2[:, None, :], d2,
                     a2 * d_out[:, None], d_out]
        else:
            d1 = d_out[:, None] * q[:-1] * (1 - a1 * a1)
            parts = [x[:, :, None] * d1[:, None, :], d1,
                     a1 * d_out[:, None], d_out]
        terms = np.concatenate([t.reshape(n, -1) for t in parts], axis=1)
        terms = terms.astype(np.float32)
        assert terms.shape[1] == count
        slices = tmk._grad_net(h1, h2)[1]
        bounds = [s * tmk.TILE // slices for s in range(slices + 1)]
        partial = np.zeros((blocks, count))
        for b in range(blocks):
            first, end = b * n // blocks, (b + 1) * n // blocks
            acc = np.zeros((slices, count))
            for base in range(first, end, tmk.TILE):
                for s in range(slices):
                    tile_sum = np.zeros(count, np.float32)
                    for r in range(base + bounds[s],
                                   min(base + bounds[s + 1], end)):
                        tile_sum += terms[r]
                    acc[s] += tile_sum.astype(np.float64)
            for s in range(slices):
                partial[b] += acc[s]
        total = np.zeros(count)
        for first in range(0, blocks, size):
            group = np.zeros(count)
            for b in range(first, min(first + size, blocks)):
                group += partial[b]
            total += group
        out[off:off + count] = total.astype(np.float32)
    return out


@pytest.mark.parametrize("blocks", [1, 3, 5])
@pytest.mark.parametrize("which", [ALL, S_ONLY])
def test_block_partition_emulated_matches_plain(blocks, which):
    """777 elements over 1, 3 or 5 blocks (groups of 1, 2 and 3; 259 and
    155-156 elements a block, so short last tiles):
    the numpy emulation of the kernel's partition and order agrees with
    the plain version, which differs only in how it sums within a slice;
    the partition itself moves the result only by float64 rounding."""
    jmat, tmat = both_materials(hidden_layers=2)
    _, td = both_data(jmat, tmat)
    params, scales, widths, e, a = flat_inputs(tmat, td)
    _, grads = upstream(td.nelm, which)
    got = tmk.material_coefficients_backward_reference(
        td.mid, td.inv_len, LF, params, scales, widths, e, a, grads,
        blocks=blocks)
    want = kernel_order_emulation(td, params, scales, widths, e, a, grads,
                                  blocks)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    one = tmk.material_coefficients_backward_reference(
        td.mid, td.inv_len, LF, params, scales, widths, e, a, grads,
        blocks=1)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-12 * scale)


def test_grad_plan_geometry():
    """The backward's job and slice counts and its group sizes, as
    csrc/material.cu computes them."""
    assert [tmk._grad_net(h, h) for h in (20, 15, 10)] == \
        [(41, 3), (29, 4), (19, 6)]
    assert tmk._grad_net(32, 32) == (89, 1)
    assert tmk._grad_net(20, 0) == (11, 11)
    assert [tmk.grad_groups(b) for b in (1, 2, 4, 5, 528)] == \
        [(1, 1), (2, 1), (2, 2), (3, 2), (23, 23)]
    assert [n[3] for n in tmk._nets((20, 20, 15, 15, 10, 10))] == \
        [521, 316, 161]


def test_grad_plans_per_stream_under_threads(monkeypatch):
    """_grad_plan makes one plan per (device, stream, widths, n), once,
    however many threads ask at the same time; other streams get their
    own scratch.  The library is a stand-in that counts plan requests
    (the real one needs the card)."""
    import sys
    import threading
    import time

    made = []

    class FakeLib:
        def pft_material_grad_plan(self, plan, sizes):
            time.sleep(0.01)  # a slow call: the other threads run meanwhile
            made.append(plan._obj.n)
            sizes[0], sizes[1], sizes[2] = 8, 4, 2
            return 0

    monkeypatch.setattr(tmk._build, "load_library", lambda: FakeLib())
    monkeypatch.setattr(tmk, "_PLANS", {})
    widths = (20, 20, 15, 15, 10, 10)
    cpu = torch.device("cpu", 0)
    plans, errors = [], []
    barrier = threading.Barrier(16)

    def ask(stream):
        try:
            barrier.wait(timeout=30)
            plans.append((stream, tmk._grad_plan(cpu, stream, widths, 999)))
        except Exception as exc:  # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(k % 2,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert made == [999, 999]
    by_stream = {s: {id(p) for q, p in plans if q == s} for s in (0, 1)}
    assert all(len(ids) == 1 for ids in by_stream.values())
    first = {s: next(p for q, p in plans if q == s) for s in (0, 1)}
    assert first[0][0].partial != first[1][0].partial


# ------------------------------------------------------- the member axis

MEMBERS = 3


def member_inputs(tmat, td, members=MEMBERS, seed=5):
    """(B, P) flat parameters (the nets' weights, each member's perturbed
    by 10 % seeded noise), (B,) load factors and (B, 4, n) upstream
    gradients, from numpy."""
    params, scales, widths, _, _ = flat_inputs(tmat, td)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(members, params.numel())).astype(np.float32)
    flat = params * (1.0 + 0.1 * torch.from_numpy(noise))
    lfs = torch.from_numpy(rng.uniform(0.2, 1.2, members).astype(np.float32))
    c = rng.normal(size=(members, 4, td.nelm)).astype(np.float32)
    return flat, lfs, c, scales, widths


def jax_layers(tmat, flat):
    """Member b's layers in the JAX package's form, stacked over members
    (leaves (B, ...))."""
    from pinn_fem_tpu_torch.parallel.batched import _unflat_members

    stacked = _unflat_members(flat, get_theta(tmat))
    return [[(jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
             for w, b in net] for net in stacked]


def jax_vmap_grad(jmat, jd, layers_b, lfs, c):
    """jax.vmap over members of jax.grad of sum_k c_k * field_k at the
    member's load factor, flattened (B, P) in theta order."""
    def loss(layers, lf, cm):
        mat = J.Material(young=jmat.young.replace(layers=layers[0]),
                         area=jmat.area.replace(layers=layers[1]),
                         density=jmat.density.replace(layers=layers[2]))
        e, a = j_material_values(jd, mat, lf)
        rho = mat.density.eval_batch(j_inputs(jd.mid, 2, lf))
        s = j_coeffs(jd, mat, lf)
        return sum(jnp.sum(cm[k] * v) for k, v in enumerate((e, a, rho, s)))

    grads = jax.vmap(jax.grad(loss))(layers_b, jnp.asarray(lfs.numpy()),
                                     jnp.asarray(c))
    return np.concatenate([np.asarray(t).reshape(MEMBERS, -1)
                           for net in grads for layer in net for t in layer],
                          axis=1)


@pytest.mark.parametrize("hidden_layers", [1, 2])
def test_batched_twins_equal_member_twins_and_jax_vmap_grad(hidden_layers):
    """Kernels 4 and 4b's member axis on the CPU, B = 3 members on 300
    elements, each with its own weights and load factor: the batched
    forward twin equals the one-member twin of each member bit for bit; the
    plain batched backward equals the plain one-member backward of each
    member in the batched partition (batched_grad_blocks) bit for bit; the
    batched autograd gradient and the plain batched backward lie within
    1e-5 of each member's max|grad| of JAX's vmap(grad) of
    material_values."""
    from pinn_fem_tpu_torch.ops.assembly import member_material

    jmat, tmat = both_materials(hidden_layers=hidden_layers)
    jd, td = both_data(jmat, tmat, n_nodes=301)
    flat, lfs, c, scales, widths = member_inputs(tmat, td)
    got = tmk.material_coefficients_batched_reference(
        td.mid, td.inv_len, lfs, flat, scales, widths)
    assert all(t.shape == (MEMBERS, td.nelm) for t in got)
    blocks = tmk.batched_grad_blocks(td.nelm, MEMBERS, tmk.CPU_BLOCKS)
    plain = tmk.material_coefficients_backward_batched_reference(
        td.mid, td.inv_len, lfs, flat, scales, widths, got[0], got[1],
        [torch.from_numpy(c[:, k]) for k in range(4)])
    for b in range(MEMBERS):
        one = tmk.material_coefficients_reference(
            td.mid, td.inv_len, float(lfs[b]), member_material(tmat, flat[b]))
        assert all(torch.equal(x[b], y) for x, y in zip(got, one)), b
        single = tmk.material_coefficients_backward_reference(
            td.mid, td.inv_len, float(lfs[b]), flat[b], scales, widths,
            got[0][b], got[1][b], [torch.from_numpy(c[b, k])
                                   for k in range(4)], blocks=blocks)
        assert torch.equal(plain[b], single), b
    th = flat.clone().requires_grad_()
    out = tmk.material_coefficients_batched_reference(
        td.mid, td.inv_len, lfs, th, scales, widths)
    loss = sum(torch.sum(torch.from_numpy(c[:, k]) * out[k])
               for k in range(4))
    twin = torch.autograd.grad(loss, th)[0].numpy()
    want = jax_vmap_grad(jmat, jd, jax_layers(tmat, flat), lfs, c)
    for b in range(MEMBERS):
        scale = np.abs(want[b]).max()
        np.testing.assert_allclose(twin[b], want[b], rtol=0,
                                   atol=BOUND * scale)
        np.testing.assert_allclose(plain[b].numpy(), want[b], rtol=0,
                                   atol=BOUND * scale)


def test_batched_plan_shares_the_card_out():
    """The batched backward's blocks a member: the one-member grid at
    B = 1, the resident blocks shared out over the members, at least one
    and at most one a tile; the forward's x-grid likewise
    (member_plan)."""
    assert tmk.batched_grad_blocks(79102, 1, 396) == 396
    assert tmk.batched_grad_blocks(79102, 8, 396) == 49
    assert tmk.batched_grad_blocks(79102, 1000, 396) == 1
    assert tmk.batched_grad_blocks(300, 2, 396) == 3
    plan = tmk.forward_plan(8 * 79102, 4, 132, 2, 256)
    assert tmk.member_plan(plan, 1) == plan
    assert tmk.member_plan(plan, 8).blocks == -(-plan.blocks // 8)
    assert tmk.member_plan(tmk.ForwardPlan(2, 128, 3), 8).blocks == 1
