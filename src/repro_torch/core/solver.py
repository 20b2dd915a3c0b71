"""Algorithm 2: solution of the per-round drift-plus-penalty problem P2 by
alternating minimisation — the port of ``repro.core.solver``.

 * ``solve_f``  — Theorem 2 closed form (cube root, clipped).
 * ``solve_p``  — Theorem 3: root of ``(1+x)ln(1+x) - x = A_1`` with
   ``x = h p / N0`` by vectorised bisection.
 * ``solve_q``  — P2.2 via Successive Upper-bound Minimisation (SUM), each
   convex surrogate solved exactly by dual water-filling over the simplex.
 * ``solve_p2`` — the outer alternating loop of Algorithm 2.

Every function runs on the device of its inputs, vectorised over ``[N]``.
The bisections have fixed trip counts (40 doublings, then
``bisect_iters`` halvings) and run as plain Python loops of tensor ops.
The SUM loop and the outer loop stop on a tolerance, as the JAX
package's ``lax.while_loop``s do: each iteration reads its convergence
norm back to the host once (one ``.item()``), so the trip counts are the
reference's, and a round does only the iterations it needs; the tracer
counts each such test as ``solver.loop_tests``.

As in the JAX package, P2.2's concave term carries the derived Q_n
weight: ``- sum_n Q_n E_n (1-q_n)^K``.  Every function takes ``k``, K
as data (see ``system_model.effective_k``); ``V`` and ``lam`` may be
Python numbers or float32 tensors (``run_scan`` passes ``[N]`` vectors,
as the JAX package's scan does).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import system_model as sm
from repro_torch.obs import trace as obs_trace

_EPS = 1e-12


class ControlDecision(NamedTuple):
    """Per-round control action (f^t, p^t, q^t), each shape [N]."""
    f: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    outer_iters: int = 24          # Algorithm 2 outer loop cap
    outer_tol: float = 1e-6        # epsilon_0
    sum_iters: int = 32            # SUM inner loop cap
    sum_tol: float = 1e-7          # epsilon_1
    bisect_iters: int = 64         # p-root + water-filling bisections
    q_floor: float = 1e-6          # numerical floor for q in (0, 1]


def _above(value: torch.Tensor, tol: float) -> bool:
    """``value > tol`` read back to the host (the loop condition of a
    ``lax.while_loop``); compared in the tensor's own float32.  Each call
    counts one ``solver.loop_tests`` in the tracer."""
    obs_trace.count("solver.loop_tests")
    return bool(value > tol)


# --------------------------------------------------------------------------
# Theorem 2 — CPU frequency
# --------------------------------------------------------------------------

def solve_f(params: sm.SystemParams, q: torch.Tensor, queues: torch.Tensor,
            V, k=None) -> torch.Tensor:
    """(f_n^t)* = clip(cbrt(V q_n / (Q_n (1-(1-q_n)^K) alpha_n))).

    Zero energy pressure (queue or selection probability zero) sends f to
    f_max, which the ``where`` and the clip reproduce.  The cube root is
    ``pow(1/3)``: its argument is never negative here.
    """
    sel = sm.selection_probability(q, sm.effective_k(params, k))
    denom = queues * sel * params.capacitance
    num = V * q
    cube = num / torch.clamp(denom, min=_EPS)
    f_star = cube.pow(1.0 / 3.0)
    f_star = torch.where(denom <= _EPS, params.f_max, f_star)
    return torch.clamp(f_star, params.f_min, params.f_max)


# --------------------------------------------------------------------------
# Theorem 3 — transmit power
# --------------------------------------------------------------------------

def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = (1+x) ln(1+x) - x ; monotone increasing, phi(0) = 0."""
    return (1.0 + x) * torch.log1p(x) - x


def solve_p(params: sm.SystemParams, q: torch.Tensor, queues: torch.Tensor,
            h: torch.Tensor, V, num_iters: int = 64, k=None
            ) -> torch.Tensor:
    """Solve ``phi(x) = A_1`` for x = h p / N0 by bisection, then clip p.

    A_{1,n} = V q_n h_n / (Q_n (1-(1-q_n)^K) N0); Q_n -> 0 sends A_1 -> inf
    and the clip returns p_max.
    """
    sel = sm.selection_probability(q, sm.effective_k(params, k))
    denom = queues * sel * params.noise_power
    a1 = V * (q * h / torch.clamp(denom, min=_EPS))
    x_max = h * params.p_max / params.noise_power

    # bracket: double hi until phi(hi) >= a1 (40 fixed doublings)
    hi = torch.clamp(x_max, min=1.0)
    for _ in range(40):
        hi = torch.where(_phi(hi) < a1, hi * 2.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(num_iters):
        mid = 0.5 * (lo + hi)
        below = _phi(mid) < a1
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    x_root = 0.5 * (lo + hi)
    p_star = x_root * params.noise_power / torch.clamp(h, min=_EPS)
    p_star = torch.where(denom <= _EPS, params.p_max, p_star)
    return torch.clamp(p_star, params.p_min, params.p_max)


# --------------------------------------------------------------------------
# P2.2 — sampling probabilities via SUM + exact water-filling
# --------------------------------------------------------------------------

def _waterfill_simplex(b: torch.Tensor, a3: torch.Tensor, q_floor: float,
                       num_iters: int) -> torch.Tensor:
    """Minimise  sum_n b_n q_n + a3_n / q_n  s.t.  sum q = 1, q in (0, 1].

    KKT: q_n(nu) = sqrt(a3_n / (b_n + nu)) clipped to (q_floor, 1]; the sum
    is continuous and decreasing in nu, so nu is found by bisection.
    """
    a3 = torch.clamp(a3, min=_EPS)

    def q_of(nu):
        denom = torch.clamp(b + nu, min=_EPS)
        return torch.clamp(torch.sqrt(a3 / denom), q_floor, 1.0)

    n = b.shape[0]
    lo = -torch.min(b) + _EPS
    hi = torch.max(a3 * (n ** 2) - b) + 1.0
    hi = torch.maximum(hi, lo + 1.0)
    for _ in range(num_iters):
        mid = 0.5 * (lo + hi)
        too_big = torch.sum(q_of(mid)) > 1.0      # need a larger nu
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    q = q_of(0.5 * (lo + hi))
    # exact simplex projection of the residual bisection error
    return q / torch.sum(q)


def p22_objective(params: sm.SystemParams, q: torch.Tensor,
                  t_round: torch.Tensor, energy: torch.Tensor,
                  queues: torch.Tensor, V, lam, k=None) -> torch.Tensor:
    """f(q) of P2.2 (with the derived Q_n weight on the concave term)."""
    w = params.data_weights
    convex = V * torch.sum(t_round * q + lam * torch.square(w) / q)
    concave = -torch.sum(queues * energy *
                         torch.pow(1.0 - q, sm.effective_k(params, k)))
    return convex + concave


def solve_q(params: sm.SystemParams, t_round: torch.Tensor,
            energy: torch.Tensor, queues: torch.Tensor, V, lam,
            q_init: torch.Tensor, cfg: SolverConfig = SolverConfig(),
            k=None) -> torch.Tensor:
    """SUM iterations for P2.2.

    Each step linearises ``-sum Q_n E_n (1-q_n)^K`` at the current iterate
    (gradient ``Q_n E_n K (1-q_n)^{K-1}``) and exactly minimises the convex
    surrogate ``sum (A2_n + c_n) q_n + A3_n / q_n`` over the simplex.  Stops
    when an iterate moves by at most ``sum_tol`` (or after ``sum_iters``).
    """
    w = params.data_weights
    a2 = V * t_round                    # A_{2,n}
    a3 = V * lam * torch.square(w)      # A_{3,n}
    kk = sm.effective_k(params, k)

    q = q_init / torch.sum(q_init)
    q_prev = q + 1.0
    it = 0
    while it < cfg.sum_iters and _above(
            torch.linalg.vector_norm(q - q_prev), cfg.sum_tol):
        grad_cve = queues * energy * kk * torch.pow(1.0 - q, kk - 1)
        b = a2 + grad_cve
        q, q_prev = _waterfill_simplex(b, a3, cfg.q_floor,
                                       cfg.bisect_iters), q
        it += 1
    return q


# --------------------------------------------------------------------------
# P2 — outer alternating loop (Algorithm 2)
# --------------------------------------------------------------------------

def p2_objective(params: sm.SystemParams, h: torch.Tensor,
                 decision: ControlDecision, queues: torch.Tensor, V, lam,
                 k=None) -> torch.Tensor:
    """V sum_n (q T + lam w^2/q) + sum_n Q_n a_n  — the P2 objective."""
    f, p, q = decision
    t = sm.round_time(params, h, p, f, k=k)
    e = sm.round_energy(params, h, p, f, k=k)
    w = params.data_weights
    penalty = V * torch.sum(q * t + lam * torch.square(w) / q)
    a = (sm.selection_probability(q, sm.effective_k(params, k)) * e -
         params.energy_budget)
    return penalty + torch.sum(queues * a)


def solve_p2(params: sm.SystemParams, h: torch.Tensor, queues: torch.Tensor,
             V, lam, cfg: SolverConfig = SolverConfig(),
             k=None) -> ControlDecision:
    """Algorithm 2: alternate the (f, p) closed forms with SUM on q.

    Initial guesses follow the paper: mid-range f and p, uniform q.  Stops
    when the normalised decision moves by at most ``outer_tol`` (or after
    ``outer_iters``).
    """
    n = params.num_devices
    f0 = 0.5 * (params.f_min + params.f_max)
    p0 = 0.5 * (params.p_min + params.p_max)
    q0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=h.device)

    def pack(d: ControlDecision) -> torch.Tensor:
        return torch.cat([d.f / params.f_max, d.p / params.p_max, d.q])

    dec = ControlDecision(f0, p0, q0)
    prev = ControlDecision(f0 + params.f_max, p0, q0)
    it = 0
    while it < cfg.outer_iters and _above(
            torch.linalg.vector_norm(pack(dec) - pack(prev)),
            cfg.outer_tol):
        f_new = solve_f(params, dec.q, queues, V, k=k)
        p_new = solve_p(params, dec.q, queues, h, V, cfg.bisect_iters, k=k)
        t = sm.round_time(params, h, p_new, f_new, k=k)
        e = sm.round_energy(params, h, p_new, f_new, k=k)
        q_new = solve_q(params, t, e, queues, V, lam, dec.q, cfg, k=k)
        dec, prev = ControlDecision(f_new, p_new, q_new), dec
        it += 1
    return dec
