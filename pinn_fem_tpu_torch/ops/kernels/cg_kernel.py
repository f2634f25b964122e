"""Fused Jacobi-PCG iteration on the banded operator: two CUDA kernels.

Replaces pinn_fem_tpu/ops/pallas/cg_kernel.py: `_dir_matvec_kernel`
(launched by `_dir_matvec`), `_update_kernel` (launched by `_update`) and
the scalar recurrence of `fused_cg_solve`'s while_loop body.  One PCG
iteration is exactly two launches:

  dia_dir_matvec:  p_new = z + beta * p ; ap = mask * (K p_new) ;
                   per-block partials of p_new . ap
  cg_update:       alpha = rz / pAp (every block sums the partials) ;
                   x += alpha p ; r -= alpha ap ; z = inv_diag * r (in
                   place) ; then the last block to finish sums r . z and
                   r . r and computes beta, rz, rn2, the iteration count
                   and the stop test into the loop's device state

Both are bound by memory: about (nd + 5) * ndof * 4 bytes per direction
pass and 8 * ndof * 4 bytes per update.  Folding the direction update into
the stencil pass and the dot products into both passes keeps each vector to
one trip through memory per iteration; finishing the iteration inside the
update leaves the host nothing to launch between them (see csrc/dia_cg.cu).

The loop's state is one 32-byte device buffer (`new_state`): beta, rz, rn2,
tol_b, the iteration count, live, the stop flag and the update's ticket.
When the stop test holds the flag makes both kernels return without
writing, which freezes the state; the host reads it only every CHECK_EVERY
iterations, so the iteration count is that of a loop that tested every
iteration.

The update accumulates r . z and r . r in float64 (exact products) and
rounds each once to float32.  The twins follow the kernels' partitions and
trees (`direction_partials` for the direction kernel's blocks, which
`dia_kernel.direction_plan` lays out; `update_partials` and `fixed_sum`
for the update's fixed grid of UPDATE_BLOCKS blocks), so kernel and twin
agree bit for bit, state included, and `fused_cg_solve`
and its twin recurrence `fused_cg_solve_reference` run the same
iterations.  Against the plain recurrence (ops.dia.dia_cg_solve_reference)
the sums are taken in another order, so values agree to float32 rounding;
the contract and the breakdown guards are the same.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...utils.runtime import require_float32
from . import _build
from .dia_kernel import (check_operands, dia_matvec, dia_matvec_reference,
                         direction_plan, operand_ok, window_offsets)

CHECK_EVERY = 32
THREADS = 256          # the update's block: kThreads in csrc/dia_cg.cu
UPDATE_BLOCKS = 264    # kUpdateBlocks: 2 x 132 SMs, fixed for every card
ROWS = 4               # rows a thread takes at a time in the update
TINY = 1e-30
STATE_BYTES = 32       # sizeof(PcgState)


# ---------------------------------------------------------------- the trees

def _tree(buf: torch.Tensor) -> torch.Tensor:
    """Pairwise tree over the last dimension (a power of two): entry l
    takes entry l + s, s = half the length down to 1."""
    s = buf.shape[-1] // 2
    while s:
        buf = buf[..., :s] + buf[..., s:2 * s]
        s //= 2
    return buf[..., 0]


def block_tree(v: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (...): the kernels' block sum over T threads (a
    multiple of 32, T / 32 a power of two), a shuffle tree inside each
    warp, then the same tree over the warps' sums."""
    return _tree(_tree(v.reshape(*v.shape[:-1], v.shape[-1] // 32, 32)))


def direction_partials(v: torch.Tensor, plan) -> torch.Tensor:
    """(plan.blocks,) block partials of sum(v) as the direction kernel
    takes them: thread t of block b adds its rows b * tile + R t + j R T
    + e (pass j, then e < R) in turn, then block_tree over the block's T
    threads.  Rows past the end add +0, which changes no sum."""
    t, r = plan.threads, plan.rows
    nb = max(plan.blocks, 1)
    rows = torch.nn.functional.pad(v, (0, nb * plan.tile - v.shape[0]))
    rows = rows.reshape(nb, plan.tile // (r * t), t, r)
    acc = torch.zeros(nb, t, dtype=v.dtype, device=v.device)
    for j in range(rows.shape[1]):
        for e in range(r):
            acc = acc + rows[:, j, :, e]
    return block_tree(acc)


def fixed_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D array of partials in the update kernel's fixed order:
    thread t adds entries t, t + THREADS, ... in turn, then block_tree."""
    acc = torch.zeros(THREADS, dtype=parts.dtype, device=parts.device)
    for row in parts.split(THREADS):
        acc[:row.shape[0]] += row
    return block_tree(acc)


def thread_sums(v: torch.Tensor) -> torch.Tensor:
    """(B, THREADS) per-thread sums of v under the update kernel's
    partition: thread t of block b takes the chunks of ROWS rows
    c = b * THREADS + t + j * UPDATE_BLOCKS * THREADS, j = 0, 1, ..., and
    adds their rows in turn.  B <= UPDATE_BLOCKS counts the blocks that
    get rows; the sums of the others are 0."""
    # The padded rows of a ragged end add +0, which changes no sum (the
    # sums start at +0 and never become -0).
    chunks = torch.nn.functional.pad(v, (0, -v.shape[0] % ROWS)).reshape(
        -1, ROWS)
    used = min(chunks.shape[0], UPDATE_BLOCKS * THREADS)
    acc = torch.zeros(-(-used // THREADS) * THREADS, dtype=v.dtype,
                      device=v.device)
    for seg in chunks.split(UPDATE_BLOCKS * THREADS):
        head = acc[:seg.shape[0]]
        for e in range(ROWS):
            head += seg[:, e]
    return acc.reshape(-1, THREADS)


def update_partials(v: torch.Tensor) -> torch.Tensor:
    """(UPDATE_BLOCKS,) block partials of sum(v) as the update kernel
    takes them: thread_sums, then block_tree."""
    sums = block_tree(thread_sums(v))
    return torch.nn.functional.pad(sums, (0, UPDATE_BLOCKS - sums.shape[0]))


# ---------------------------------------------------------------- the state

def state_views(state: torch.Tensor):
    """Views of the 32-byte loop state (struct PcgState in csrc/dia_cg.cu):
    floats [beta, rz, rn2, tol_b], int32 [it, live], the bool stop flag,
    the int32 ticket."""
    return (state[:16].view(torch.float32), state[16:24].view(torch.int32),
            state[24:25].view(torch.bool), state[28:32].view(torch.int32))


def new_state(rz: torch.Tensor, rn2: torch.Tensor, tol_b: torch.Tensor,
              max_iter: int) -> torch.Tensor:
    """The state before the first iteration: beta 0, it 0, live as the
    loop's test gives it, ticket 0."""
    state = torch.zeros(STATE_BYTES, dtype=torch.uint8, device=rz.device)
    f, i, stop, _ = state_views(state)
    f[1:].copy_(torch.stack([rz, rn2, tol_b]))
    live = ((0 < max_iter) & torch.isfinite(rz) & (rz > 0)
            & (torch.sqrt(rn2) > tol_b))
    i[1:].copy_(live.reshape(1))
    stop.copy_(~live.reshape(1))
    return state


# ------------------------------------------------------- launch path, shared

_P = ctypes.c_void_p


class DirectionArgs(ctypes.Structure):
    """struct DirectionArgs of csrc/dia_cg.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "device", "nd", "threads", "rows", "tile", "halo_lo", "window",
        "staged")] + [("ndof", ctypes.c_int64)] + [
        (name, _P) for name in ("beta", "z", "p", "diags", "offsets",
                                "mask", "p_out", "ap_out", "partial", "stop",
                                "stream")]


class UpdateArgs(ctypes.Structure):
    """struct UpdateArgs of csrc/dia_cg.cu."""
    _fields_ = [("device", ctypes.c_int), ("max_iter", ctypes.c_int),
                ("n_pap", ctypes.c_int64), ("n", ctypes.c_int64)] + [
        (name, _P) for name in ("pap_parts", "x", "r", "p", "ap",
                                "inv_diag", "z", "partials", "state",
                                "stream")]


def _launcher(fn, args: ctypes.Structure, what: str, wrapper):
    """launch(): fn on the filled struct, checked, counted on `wrapper`."""
    ptr = ctypes.addressof(args)

    def launch():
        _build.check(fn(ptr), what)
        wrapper.launches += 1

    launch.args = args  # the struct lives as long as the launch
    return launch


_FUNCTIONS = {}


def _function(name: str):
    """The C entry point `name`, looked up once per process; the first
    lookup checks that the library was built with this module's sizes."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        lib = _build.load_library()
        if (lib.pft_threads_per_block() != THREADS
                or lib.pft_update_blocks() != UPDATE_BLOCKS):
            raise RuntimeError("kernel library and THREADS / UPDATE_BLOCKS "
                               "disagree")
        fn = _FUNCTIONS[name] = getattr(lib, name)
    return fn


def _flag_ptr(stop: Optional[torch.Tensor], device) -> Optional[int]:
    if stop is None:
        return None
    if stop.dtype != torch.bool or stop.numel() != 1 or stop.device != device:
        raise ValueError("stop must be a one-element bool tensor on the "
                         "kernel's device")
    return stop.data_ptr()


# ------------------------------------------------------ kernel 2: direction

def n_direction_partials(layout) -> int:
    """How many partials the direction kernel writes: one a block."""
    return max(direction_plan(layout).blocks, 1)


def _direction_launch(layout, device):
    """(plan, int32 offsets on the device), made once per (layout,
    device)."""
    plan = direction_plan(layout)
    return plan, window_offsets(layout, plan, device)


def dir_matvec_reference(beta, z, p, layout, diags, mask, stop=None,
                         out=None):
    """Plain twin of the direction kernel: (p_new, ap, partials), written
    into `out` when it is given.

    Where `stop` is set the kernel writes nothing and its outputs are
    undefined; the twin computes them all the same."""
    p_new = z + beta * p
    ap = dia_matvec_reference(layout, diags, p_new) * mask
    result = (p_new, ap, direction_partials(p_new * ap,
                                            direction_plan(layout)))
    if out is None:
        return result
    for dst, src in zip(out, result):
        dst.copy_(src)
    return out


def bind_dir_matvec(beta: torch.Tensor, z: torch.Tensor, p: torch.Tensor,
                    layout, diags: torch.Tensor, mask: torch.Tensor,
                    stop: Optional[torch.Tensor] = None, out=None):
    """The direction step on fixed operands, checked once: returns
    (launch, out), where launch() runs it (the kernel on CUDA tensors, on
    the stream current now; the twin on CPU tensors) and out is
    (p_new, ap, partials), allocated when not given, the partials
    (direction_plan(layout).blocks,)."""
    dev = z.device
    if dev.type == "cpu":
        if out is None:
            out = (torch.empty_like(z), torch.empty_like(z),
                   torch.empty(n_direction_partials(layout), dtype=z.dtype))
        return (lambda: dir_matvec_reference(beta, z, p, layout, diags, mask,
                                             stop, out)), out
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n, nd = layout.ndof, layout.n_diags
    nb = n_direction_partials(layout)
    if out is None:
        out = (torch.empty_like(z), torch.empty_like(z),
               torch.empty(nb, dtype=z.dtype, device=dev))
    p_new, ap, partials = out
    vec = (n,)
    if not (operand_ok(z, vec, dev) and operand_ok(p, vec, dev)
            and operand_ok(mask, vec, dev) and operand_ok(p_new, vec, dev)
            and operand_ok(ap, vec, dev) and operand_ok(partials, (nb,), dev)
            and operand_ok(diags, (nd, n), dev)
            and operand_ok(beta, beta.shape, dev) and beta.numel() == 1):
        check_operands(n, vectors=(z, p, mask, p_new, ap), diags=diags,
                       nd=nd, scalars=(beta,))
        check_operands(nb, vectors=(partials,))
        raise ValueError("operands do not fit the direction kernel")
    plan, offsets = layout.cached(("direction", dev),
                                  lambda: _direction_launch(layout, dev))
    args = DirectionArgs(
        dev.index, nd, plan.threads, plan.rows, plan.tile, plan.halo_lo,
        plan.window, int(plan.staged), n, beta.data_ptr(), z.data_ptr(),
        p.data_ptr(),
        diags.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
        p_new.data_ptr(), ap.data_ptr(), partials.data_ptr(),
        _flag_ptr(stop, dev), _build.current_stream(dev))
    return _launcher(_function("pft_dia_dir_matvec"), args,
                     "dia_dir_matvec", dia_dir_matvec), out


def dia_dir_matvec(beta: torch.Tensor, z: torch.Tensor, p: torch.Tensor,
                   layout, diags: torch.Tensor, mask: torch.Tensor,
                   stop: Optional[torch.Tensor] = None, out=None):
    """p_new = z + beta p, ap = mask (K p_new), and per-block p_new . ap.

    beta: one-element float32 tensor on the device (never read on the
    host).  stop: optional one-element bool tensor; when true nothing is
    written.  out: optional (p_new, ap, partials) to write into, the
    partials (n_direction_partials(layout),).  Returns (p_new, ap,
    partials).
    """
    launch, out = bind_dir_matvec(beta, z, p, layout, diags, mask, stop, out)
    launch()
    return out


dia_dir_matvec.launches = 0


# --------------------------------------------------------- kernel 3: update

def cg_update_reference(pap_parts, x, r, p, ap, inv_diag, z, state,
                        max_iter, partials=None):
    """Plain twin of the update kernel.

    Updates x, r, z and the state in place, and returns the
    (UPDATE_BLOCKS, 2) float64 block partials [r . z, r . r] (written into
    `partials` when it is given).  Where the state's stop flag is set,
    nothing changes."""
    f, i, stop, _ = state_views(state)
    keep = stop.clone()
    rz, tol_b = f[1], f[3]
    tiny = torch.tensor(TINY, dtype=x.dtype, device=x.device)
    pap = fixed_sum(pap_parts)
    alpha = rz / torch.where(pap.abs() > 0, pap, tiny)
    x_new = x + alpha * p
    r_new = r - alpha * ap
    z_new = inv_diag * r_new
    rd, zd = r_new.double(), z_new.double()  # exact products
    parts = torch.stack([update_partials(rd * zd), update_partials(rd * rd)],
                        dim=1)
    rz_new = fixed_sum(parts[:, 0]).float()
    rn2_new = fixed_sum(parts[:, 1]).float()
    beta = rz_new / torch.where(rz != 0, rz, tiny)
    it = i[0] + 1
    live = ((it < max_iter) & torch.isfinite(rz_new) & (rz_new > 0)
            & (torch.sqrt(rn2_new) > tol_b))
    f.copy_(torch.where(keep, f, torch.stack([beta, rz_new, rn2_new, tol_b])))
    i.copy_(torch.where(keep, i, torch.stack([it, live.to(torch.int32)])))
    for dst, src in ((x, x_new), (r, r_new), (z, z_new)):
        dst.copy_(torch.where(keep, dst, src))
    stop.copy_(keep | ~live)
    if partials is None:
        return parts
    partials.copy_(torch.where(keep, partials, parts))
    return partials


def bind_cg_update(pap_parts: torch.Tensor, x: torch.Tensor,
                   r: torch.Tensor, p: torch.Tensor, ap: torch.Tensor,
                   inv_diag: torch.Tensor, z: torch.Tensor,
                   state: torch.Tensor, max_iter: int,
                   partials: Optional[torch.Tensor] = None):
    """The update step on fixed operands, checked once: returns
    (launch, partials), where launch() runs it (the kernel on CUDA
    tensors, on the stream current now; the twin on CPU tensors)."""
    dev = x.device
    if partials is None:
        partials = torch.empty(UPDATE_BLOCKS, 2, dtype=torch.float64,
                               device=dev)
    if dev.type == "cpu":
        return (lambda: cg_update_reference(pap_parts, x, r, p, ap, inv_diag,
                                            z, state, max_iter,
                                            partials)), partials
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n = x.shape[0]
    vectors = (x, r, p, ap, inv_diag, z)
    if not (all(operand_ok(v, (n,), dev) for v in vectors)
            and operand_ok(pap_parts, pap_parts.shape, dev)
            and pap_parts.dim() == 1):
        check_operands(n, vectors=vectors)
        check_operands(pap_parts.numel(), vectors=(pap_parts,))
        raise ValueError("operands do not fit the update kernel")
    if (partials.dtype != torch.float64 or partials.device != dev
            or partials.shape != (UPDATE_BLOCKS, 2)
            or not partials.is_contiguous()):
        raise ValueError(f"partials must be ({UPDATE_BLOCKS}, 2) float64 "
                         f"on {dev}")
    if any(v.data_ptr() % 16 for v in vectors):
        raise ValueError("the update kernel takes 16-byte aligned vectors")
    if (state.dtype != torch.uint8 or state.shape != (STATE_BYTES,)
            or state.device != dev):
        raise ValueError(f"state must be ({STATE_BYTES},) uint8 on {dev}")
    args = UpdateArgs(
        dev.index, min(int(max_iter), 2**31 - 1), pap_parts.shape[0], n,
        pap_parts.data_ptr(), *(v.data_ptr() for v in vectors),
        partials.data_ptr(), state.data_ptr(), _build.current_stream(dev))
    return _launcher(_function("pft_cg_update"), args, "cg_update",
                     cg_update), partials


def cg_update(pap_parts: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
              p: torch.Tensor, ap: torch.Tensor, inv_diag: torch.Tensor,
              z: torch.Tensor, state: torch.Tensor, max_iter: int,
              partials: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha = rz / sum(pap_parts); x += alpha p, r -= alpha ap,
    z = inv_diag r in place; then beta, rz, rn2, it, live and stop into
    `state` (see `new_state`).  Nothing is written where the stop flag is
    set.

    The six vectors must be 16-byte aligned (fresh allocations are).
    Returns the (UPDATE_BLOCKS, 2) float64 block partials [r . z, r . r]
    (the dot products accumulate in float64 and round once to float32).
    """
    launch, partials = bind_cg_update(pap_parts, x, r, p, ap, inv_diag, z,
                                      state, max_iter, partials)
    launch()
    return partials


cg_update.launches = 0


# ------------------------------------------------------------------ the loop

def _plain_binder(fn):
    """A binder (as bind_dir_matvec) that runs the plain twin `fn` on any
    device."""
    def bind(*args, **kwargs):
        return (lambda: fn(*args, **kwargs)), None
    return bind


def _pcg(matvec, bind_direction, bind_update, layout, diags, rhs, free_mask,
         tol, max_iter, x0):
    """The fused PCG recurrence over the given matvec and direction /
    update binders (kernels or twins).  Both steps are bound once for each
    of the two p buffers, so an iteration is two operation calls, and the
    host reads the live flag every CHECK_EVERY iterations."""
    from ..dia import dia_diagonal

    mask = free_mask
    dev, dt = rhs.device, rhs.dtype
    b_vec = rhs * mask
    diag = dia_diagonal(layout, diags) * mask + (1.0 - mask)
    inv_diag = (1.0 / diag) * mask  # fixed rows: r == 0 anyway
    b_norm = torch.clamp_min(torch.linalg.vector_norm(b_vec), 1e-30)
    tol_b = torch.as_tensor(tol, dtype=dt, device=dev) * b_norm

    if x0 is None:
        x = torch.zeros_like(b_vec)
        r = b_vec.clone()
    else:
        x = (x0 * mask).contiguous()
        r = b_vec - matvec(layout, diags, x) * mask
    z = inv_diag * r
    state = new_state(torch.dot(r, z), torch.dot(r, r), tol_b, max_iter)
    f, i, stop, _ = state_views(state)
    beta, live = f[:1], i[1]
    # beta = 0 on the first step: p_new = z0.  The direction step reads p
    # from one buffer and writes p_new into the other; they swap roles.
    p_bufs = (torch.zeros_like(z), torch.empty_like(z))
    ap = torch.empty_like(z)
    pap = torch.empty(n_direction_partials(layout), dtype=dt, device=dev)
    partials = torch.empty(UPDATE_BLOCKS, 2, dtype=torch.float64,
                           device=dev)
    steps = []
    for k in (0, 1):
        p, p_new = p_bufs[k], p_bufs[1 - k]
        direction, _ = bind_direction(beta, z, p, layout, diags, mask, stop,
                                      out=(p_new, ap, pap))
        update, _ = bind_update(pap, x, r, p_new, ap, inv_diag, z, state,
                                max_iter, partials)
        steps.append((direction, update))

    rounds = 0
    while rounds % CHECK_EVERY or bool(live):
        direction, update = steps[rounds % 2]
        rounds += 1
        direction()
        update()
    return x * mask, i[0].clone(), torch.sqrt(f[2]) / b_norm


def fused_cg_solve(
    layout,
    diags: torch.Tensor,
    rhs: torch.Tensor,
    free_mask: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 100000,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobi-PCG with the fused two-kernel iteration.

    Returns (x * mask, iterations, relative recurrence-residual norm) with
    the convergence and float32 breakdown gates of ops.dia.dia_cg_solve;
    iterations and residual are 0-d device tensors.  On CUDA tensors every
    iteration launches the two kernels (and r0 = b - A x0 the stencil);
    they take float32 only.  The twins keep the kernels' float32 loop
    state, so float64 CPU tensors (PINN_FEM_TPU_X64) take the plain
    recurrence, ops.dia.dia_cg_solve_reference.
    """
    if rhs.device.type == "cuda":
        require_float32(rhs.dtype, "fused PCG (kernels 1-3: dia_matvec, "
                        "dia_dir_matvec, cg_update)")
    elif rhs.dtype != torch.float32:
        from ..dia import dia_cg_solve_reference

        return dia_cg_solve_reference(layout, diags, rhs, free_mask, tol,
                                      max_iter, x0)
    return _pcg(dia_matvec, bind_dir_matvec, bind_cg_update, layout, diags,
                rhs, free_mask, tol, max_iter, x0)


def fused_cg_solve_reference(
    layout,
    diags: torch.Tensor,
    rhs: torch.Tensor,
    free_mask: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 100000,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The twin recurrence: `fused_cg_solve` on the plain twins, on any
    device.  Bit-identical to the kernel path."""
    return _pcg(dia_matvec_reference, _plain_binder(dir_matvec_reference),
                _plain_binder(cg_update_reference), layout, diags, rhs,
                free_mask, tol, max_iter, x0)
