"""Horizon-sharded (sequence-parallel) cyclic reduction and trust-region
solve on ``torch.distributed`` (counterpart of
``idto_tpu/parallel/horizon.py``).

The reference's Thomas sweep is sequential over the T+1 block rows; here
the horizon is split over the ranks of one mesh axis (a process group) and
block cyclic reduction runs distributed:

  * the penta system is packed into a block-tridiagonal system of 2k-wide
    super-rows (``ops/cyclic_reduction.py``) and padded with identity rows
    so that every rank owns a power-of-two contiguous slice; a rank packs
    only its own rows;
  * each reduction level eliminates the even local rows; the one
    cross-rank dependency is the first even row of the next rank (the row
    below each rank's last odd row): one backward halo a level, and the
    last rank takes zeros;
  * after log2(rows per rank) levels each rank holds one super-row; the
    P-row reduced system is gathered and solved redundantly on every rank
    (block Thomas);
  * back substitution unwinds the levels with one forward halo a level.

The matrix is reduced once (``factorize_sharded``) and the stored levels
serve any number of right-hand sides (``solve_factorized_sharded``), as the
trust region's Schur and Newton solves need.  Each halo is an
``all_gather`` of one boundary block row over the axis's group, where JAX
uses ``ppermute``: gloo takes CUDA tensors in its collectives but not in
point-to-point sends, and at P <= 8 the extra bytes are a few (K, K) blocks
a level.  Every rank holds the whole system and returns the whole solution,
as JAX's logical global arrays do.

``solve_trust_region_horizon_sharded`` is the whole trust-region solve
with the horizon sharded.  JAX annotates the inputs and lets GSPMD
partition it; PyTorch has no partitioner, so ``HorizonSplit`` does by hand
what GSPMD does there: each rank evaluates the physics (rollout, cost
terms, partials, N+) of its own contiguous range of knots, the pieces are
gathered so that every rank assembles the same gradient and bands, and the
linear solves go through the distributed cyclic reduction.  Every host
decision of the loop then reads values that are bit-identical on all ranks,
which keeps the ranks in step (a rank that branched differently would
deadlock the group).

On CUDA tensors over an NCCL group the loop's regions are captured with
their collectives (``optimizer/batched.py``, ``utils/graphs.py``): every
collective here reads no device value on the host and allocates its
buffers with the caching allocator, which a capture owns, and the
group's communicator comes into being in the eager warm-up before the
first capture.  Over gloo the regions run directly.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from idto_tpu_torch.ops import cyclic_reduction
from idto_tpu_torch.ops.cyclic_reduction import (
    _bmv,
    _inv,
    _pack_rhs,
    _pack_super_tridiag,
)
from idto_tpu_torch.ops.penta import PentaBands
from idto_tpu_torch.parallel.multihost import AxisGroup, axis_group


def _halo(x, ax: AxisGroup, offset: int):
    """The ``x`` of the rank ``offset`` places along the axis (zeros past
    either end, as JAX's ppermute leaves them): an all_gather of x."""
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    j = ax.index + offset
    return parts[j] if 0 <= j < ax.size else torch.zeros_like(x)


class ShardedCRFactor(NamedTuple):
    """This rank's share of a distributed cyclic reduction of (B, n, k, k)
    bands: its levels (coarsest last) and the block-Thomas factor of the
    gathered P-row system, the same on every rank."""

    ax: AxisGroup
    n: int
    k: int
    lo: int  # first real super-row of this rank
    rows: int  # real super-rows of this rank (the rest is identity padding)
    s0: int  # super-rows a rank, a power of two
    levels: tuple  # (Cinv_even, alpha, beta, L_even, U_even) a level
    W: Any  # (B, P, K, K) Thomas multipliers L_i c_{i-1}^-1 (W[:, 0] unused)
    Cinv: Any  # (B, P, K, K) inverses of the Thomas pivots
    U: Any  # (B, P, K, K) upper blocks of the reduced system
    ok: Any  # (B,) every stored block of every rank is finite


def factorize_sharded(H: PentaBands, ax: AxisGroup) -> ShardedCRFactor:
    """Reduce the bands (B, n, k, k), the same on every rank of ``ax``,
    down to the gathered P-row system and factor that."""
    n, k = H.n, H.k
    K = 2 * k
    m = (n + 1) // 2
    if m < ax.size:
        raise ValueError(f"horizon too short to shard: {m} super-rows < "
                         f"{ax.size} devices")
    s0 = 1 << (-(-m // ax.size) - 1).bit_length()  # ceil(m / P), to 2^j
    lo = min(ax.index * s0, m)
    rows = min(lo + s0, m) - lo
    B = H.C.shape[0]
    dtype, device = H.C.dtype, H.C.device
    L = torch.zeros((B, s0, K, K), dtype=dtype, device=device)
    U = torch.zeros_like(L)
    C = torch.eye(K, dtype=dtype, device=device).repeat(B, s0, 1, 1)
    if rows:
        # Super-row i packs penta rows 2i and 2i + 1 only.
        sub = H.replace(**{f: getattr(H, f)[:, 2 * lo: min(2 * (lo + rows),
                                                            n)]
                           for f in "ABCDE"})
        L[:, :rows], C[:, :rows], U[:, :rows] = _pack_super_tridiag(sub)

    levels = []
    s = s0
    while s > 1:
        L_ev, L_od = L[:, 0::2], L[:, 1::2]
        C_ev, C_od = C[:, 0::2], C[:, 1::2]
        U_ev, U_od = U[:, 0::2], U[:, 1::2]
        Cinv_ev = _inv(C_ev)
        # The last odd row's row below is the next rank's first even row.
        below = _halo(torch.stack([Cinv_ev[:, 0], L_ev[:, 0], U_ev[:, 0]],
                                  dim=1), ax, 1)
        Cinv_below = torch.cat([Cinv_ev[:, 1:], below[:, 0:1]], dim=1)
        L_below = torch.cat([L_ev[:, 1:], below[:, 1:2]], dim=1)
        U_below = torch.cat([U_ev[:, 1:], below[:, 2:3]], dim=1)
        alpha = L_od @ Cinv_ev
        beta = U_od @ Cinv_below
        levels.append((Cinv_ev, alpha, beta, L_ev, U_ev))
        L = -(alpha @ L_ev)
        C = C_od - alpha @ U_ev - beta @ L_below
        U = -(beta @ U_below)
        s //= 2

    # The reduced system, one row a rank, solved redundantly by Thomas.
    g = ax.gather(torch.stack([L[:, 0], C[:, 0], U[:, 0]], dim=1)[:, None],
                  dim=1)  # (B, P, 3, K, K)
    Lg, Cg, Ug = g[:, :, 0], g[:, :, 1], g[:, :, 2]
    W = torch.zeros_like(Lg)
    Cinv = torch.empty_like(Cg)
    Cinv[:, 0] = _inv(Cg[:, 0])
    for i in range(1, ax.size):
        W[:, i] = Lg[:, i] @ Cinv[:, i - 1]
        Cinv[:, i] = _inv(Cg[:, i] - W[:, i] @ Ug[:, i - 1])

    ok = torch.ones(B, dtype=torch.int32, device=device)
    for x in [X for lvl in levels for X in lvl] + [Cinv, W]:
        ok &= torch.isfinite(x).flatten(1).all(dim=1).to(torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=ax.group)
    return ShardedCRFactor(ax=ax, n=n, k=k, lo=lo, rows=rows, s0=s0,
                           levels=tuple(levels), W=W, Cinv=Cinv, U=Ug,
                           ok=ok.bool())


def _bmv1(A, x):
    """(B, K, K) @ (B, R, K) -> (B, R, K)."""
    return torch.einsum("bij,brj->bri", A, x)


def solve_factorized_sharded(F: ShardedCRFactor, b):
    """Solve with a sharded factor for right-hand sides b (B, n, k) or
    (B, R, n, k), the same on every rank; returns the whole solution on
    every rank."""
    single = b.ndim == 3
    bb = b[:, None] if single else b
    Bn, R = bb.shape[:2]
    K = 2 * F.k
    rhs = torch.zeros((Bn, R, F.s0, K), dtype=b.dtype, device=b.device)
    if F.rows:
        rhs[:, :, :F.rows] = _pack_rhs(
            bb[:, :, 2 * F.lo: min(2 * (F.lo + F.rows), F.n)], F.rows)

    b_evens = []
    for Cinv_ev, alpha, beta, L_ev, U_ev in F.levels:
        b_ev, b_od = rhs[:, :, 0::2], rhs[:, :, 1::2]
        b_evens.append(b_ev)
        below = _halo(b_ev[:, :, 0:1], F.ax, 1)
        b_below = torch.cat([b_ev[:, :, 1:], below], dim=2)
        rhs = b_od - _bmv(alpha, b_ev) - _bmv(beta, b_below)

    # Block Thomas on the gathered reduced right-hand sides.
    d = F.ax.gather(rhs, dim=2)  # (B, R, P, K)
    P = F.ax.size
    ds = [d[:, :, 0]]
    for i in range(1, P):
        ds.append(d[:, :, i] - _bmv1(F.W[:, i], ds[-1]))
    xs = [None] * P
    xs[P - 1] = _bmv1(F.Cinv[:, P - 1], ds[P - 1])
    for i in range(P - 2, -1, -1):
        xs[i] = _bmv1(F.Cinv[:, i], ds[i] - _bmv1(F.U[:, i], xs[i + 1]))
    x = xs[F.ax.index][:, :, None]  # (B, R, 1, K)

    for (Cinv_ev, alpha, beta, L_ev, U_ev), b_ev in zip(
            reversed(F.levels), reversed(b_evens)):
        # Even row j sits below odd row j - 1; j = 0 needs the previous
        # rank's last solved row.
        above = _halo(x[:, :, -1:], F.ax, -1)
        x_above = torch.cat([above, x[:, :, :-1]], dim=2)
        x_ev = _bmv(Cinv_ev, b_ev - _bmv(L_ev, x_above) - _bmv(U_ev, x))
        x = torch.stack([x_ev, x], dim=3).reshape(Bn, R, -1, K)
    m = (F.n + 1) // 2
    x = F.ax.gather(x, dim=2)[:, :, :m].reshape(Bn, R, 2 * m, F.k)[:, :, :F.n]
    return x[:, 0] if single else x


def solve_sharded(H: PentaBands, b, mesh, axis: str = "horizon"):
    """Solve H x = b with the block rows sharded over ``mesh[axis]``.

    H bands (B, n, k, k), b (B, n, k) or (B, R, n, k), the same on every
    rank; every rank returns the whole x.  Requires ceil(n / 2) super-rows
    >= the axis size.  On an axis of one rank this is
    ``cyclic_reduction.solve``."""
    ax = axis_group(mesh, axis)
    if ax.size == 1:
        return cyclic_reduction.solve(H, b)
    return solve_factorized_sharded(factorize_sharded(H, ax), b)


class HorizonSplit:
    """This rank's share of the horizon in a trust-region solve: the knots
    k0..k1-1 of T + 1, and so the steps lo..hi-1 (tau_t, the step from knot
    t to t + 1; the last rank has one step fewer than its knots).

    Step t reads q_{t-1}, q_t and q_{t+1}: a rank evaluates its steps on
    the knots lo-1..hi (a halo of one knot each side), and v_0 = v_init
    only on the first rank.  The pieces are gathered in one all_gather an
    evaluation, so every rank holds the whole (tau, v[, partials, N+])."""

    def __init__(self, ax: AxisGroup, num_steps: int):
        self.ax = ax
        self.T = num_steps
        knots = (num_steps + 1) // ax.size
        self.knots = knots
        self.k0 = ax.index * knots
        self.k1 = self.k0 + knots
        self.lo, self.hi = self.k0, min(self.k1, num_steps)

    # A split is part of the keys of the captured regions
    # (``utils/graphs.py``): two splits are one when they name the same
    # group object, rank, world size and knot range.  A key holds its split
    # and so the group, whose id cannot be reused while the key lives.
    def _identity(self):
        return (id(self.ax.group), self.ax.index, self.ax.size, self.k0,
                self.k1, self.T)

    def __eq__(self, other):
        return (isinstance(other, HorizonSplit)
                and self._identity() == other._identity())

    def __hash__(self):
        return hash(self._identity())

    def _local(self, model, probs, contact, q):
        """(q_ext, halo, tau, v) of this rank: tau of its steps, v of its
        knots."""
        from idto_tpu_torch.soa import rollout

        halo = self.lo > 0
        q_ext = q[:, self.lo - 1 if halo else 0: self.hi + 1]
        if self.hi > self.lo:
            tau, v = rollout.generalized_forces(model, probs, contact, q_ext,
                                                halo=halo)
        else:  # a rank that owns knot T alone: no step
            v = rollout.velocities(model, probs, q_ext, halo=halo)
            tau = v.new_zeros((q.shape[0], 0, model.nv))
        return q_ext, halo, tau, v[:, :self.k1 - self.k0]

    def forces(self, model, probs, contact, q):
        """(tau (B, T, nv), v (B, T+1, nv)) of the whole horizon."""
        _, _, tau, v = self._local(model, probs, contact, q)
        tau, v = self._gather_steps_knots([tau], [v])
        return tau[0], v[0]

    def physics(self, model, probs, params, q):
        """(tau, v, IdPartials, N+) of the whole horizon, as
        ``optimizer/batched.py`` evaluates them unsharded."""
        from idto_tpu_torch.optimizer.partials import (
            IdPartials,
            id_partials_for,
            nplus_stack,
        )

        q_ext, halo, tau, v = self._local(model, probs, params.contact, q)
        if self.hi > self.lo:
            parts = list(id_partials_for(model, probs, params, q_ext,
                                         halo=halo))
        else:
            parts = [q.new_zeros((q.shape[0], 0, model.nv, model.nq))] * 3
        nplus = nplus_stack(model, q[:, self.k0:self.k1])
        steps, knots = self._gather_steps_knots([tau] + parts, [v, nplus])
        return steps[0], knots[0], IdPartials(*steps[1:]), knots[1]

    def _gather_steps_knots(self, steps, knots):
        """Per-step pieces (this rank's hi - lo steps) and per-knot pieces
        (its k1 - k0 knots), gathered in one all_gather."""
        B = knots[0].shape[0]

        def flat(x, length):
            f = x.flatten(2)
            if f.shape[1] < length:
                f = torch.cat([f, f.new_zeros(
                    (B, length - f.shape[1], f.shape[2]))], dim=1)
            return f

        pieces = [flat(x, self.knots) for x in steps + knots]
        widths = [p.shape[2] for p in pieces]
        g = self.ax.gather(torch.cat(pieces, dim=2), dim=1)
        out = [p.reshape((B, p.shape[1]) + x.shape[2:])
               for p, x in zip(torch.split(g, widths, dim=2), steps + knots)]
        return [x[:, :self.T] for x in out[:len(steps)]], out[len(steps):]

    def factorize(self, Hs):
        """The distributed cyclic reduction's factor of the scaled bands."""
        return factorize_sharded(Hs, self.ax)


def solve_trust_region_horizon_sharded(model, prob, params, q_guess, mesh,
                                       axis: str = "horizon"):
    """The whole trust-region solve of one problem with the HORIZON sharded
    over ``mesh[axis]`` (sequence parallelism): each rank evaluates the
    physics of (T+1)/P knots, and the linear solves run as distributed
    cyclic reduction when ``params.linear_solver`` is CYCLIC_REDUCTION
    (another solver runs redundantly on every rank: the scan-Thomas is
    sequential over the horizon).  prob unbatched, q_guess (T+1, nq), the
    same on every rank; returns the unsharded ``solve``'s unbatched
    (Solution, Stats, WarmStart) on every rank.  On an axis of one rank this
    is that solve.

    Requires (T+1) divisible by the axis size, and for cyclic reduction
    ceil((T+1)/2) super-rows at least as many as the ranks
    (``factorize_sharded``).  On CUDA tensors over NCCL the loop's graphs
    hold the group's collectives: call ``utils.graphs.reset()`` before
    destroying the group."""
    from idto_tpu_torch.optimizer.batched import solve_trust_region_batched
    from idto_tpu_torch.optimizer.solver import unbatch
    from idto_tpu_torch.parallel.batching import broadcast_problem

    ax = axis_group(mesh, axis)
    n_knots = prob.num_steps + 1
    if n_knots % ax.size != 0:
        raise ValueError(
            f"horizon knots ({n_knots}) must divide the mesh ({ax.size}); "
            "pad T"
        )
    split = HorizonSplit(ax, prob.num_steps) if ax.size > 1 else None
    out = solve_trust_region_batched(model, broadcast_problem(prob, 1),
                                     params, q_guess[None], horizon=split)
    return tuple(unbatch(x) for x in out)
