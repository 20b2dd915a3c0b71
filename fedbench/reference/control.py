"""The control plane of one round, written anew in plain PyTorch: the
paper's system model (eqs. (5)-(20)), its four controllers of Sec. VII
(LROA's Algorithm 2, Uni-D, Uni-S, DivFL) and their slot rules.

Everything runs on the CPU in the dtype the caller asks for: float64 for
the reference, a lower one for the control.  Nothing here comes from the
program; the constants come from the configuration file's ``system``
block and the per-client data sizes the benchmark made.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class System:
    """Table I of the paper, per client ``[N]`` where it varies."""
    sizes: torch.Tensor          # D_n
    k: float                     # K
    epochs: float                # E
    bandwidth: float             # B (Hz)
    noise: float                 # N0 (W)
    model_bits: float            # M (bits)
    cycles: float                # c_n (cycles per sample)
    capacitance: float           # alpha_n
    budget: float                # E-bar_n (J per round)
    f_min: float
    f_max: float
    p_min: float
    p_max: float

    @classmethod
    def from_config(cls, system: dict, sizes, k: int, epochs: int,
                    dtype=torch.float64) -> "System":
        return cls(sizes=torch.as_tensor(np.asarray(sizes, np.float64),
                                         dtype=dtype),
                   k=float(k), epochs=float(epochs),
                   bandwidth=float(system["bandwidth_hz"]),
                   noise=float(system["noise_power_w"]),
                   model_bits=float(system["model_bits"]),
                   cycles=float(system["cycles_per_sample"]),
                   capacitance=float(system["capacitance"]),
                   budget=float(system["energy_budget_j"]),
                   f_min=float(system["f_min_hz"]),
                   f_max=float(system["f_max_hz"]),
                   p_min=float(system["p_min_w"]),
                   p_max=float(system["p_max_w"]))

    @property
    def dtype(self):
        return self.sizes.dtype

    @property
    def n(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def weights(self) -> torch.Tensor:
        return self.sizes / torch.sum(self.sizes)

    def full(self, v: float) -> torch.Tensor:
        return torch.full((self.n,), v, dtype=self.dtype)


# -- the system model --------------------------------------------------------

def upload_time(sys: System, h, p):
    """M / (B/K log2(1 + h p / N0)) — eqs. (5), (6)."""
    rate = (sys.bandwidth / sys.k) * torch.log2(1.0 + h * p / sys.noise)
    return sys.model_bits / rate


def round_time(sys: System, h, p, f):
    """E c D / f + upload — eqs. (8), (9) (no download term)."""
    return sys.epochs * sys.cycles * sys.sizes / f + upload_time(sys, h, p)


def round_energy(sys: System, h, p, f):
    """E alpha c D f^2 / 2 + p T_up — eqs. (12), (14), (15)."""
    comp = 0.5 * sys.capacitance * sys.epochs * sys.cycles * sys.sizes * f * f
    return comp + p * upload_time(sys, h, p)


def selection_probability(q, k: float):
    """1 - (1 - q)^K (Sec. III-F)."""
    return 1.0 - torch.pow(1.0 - q, k)


def next_queues(sys: System, queues, h, f, p, q):
    """Q' = max(Q + (1-(1-q)^K) E - E-bar, 0) — eqs. (19), (20)."""
    inc = selection_probability(q, sys.k) * round_energy(sys, h, p, f) \
        - sys.budget
    return torch.clamp(queues + inc, min=0.0)


# -- Algorithm 2 -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Solver:
    outer_iters: int = 24
    outer_tol: float = 1e-6
    sum_iters: int = 32
    sum_tol: float = 1e-7
    bisect_iters: int = 64
    q_floor: float = 1e-6


def solve_f(sys: System, q, queues, V):
    """Theorem 2: cbrt(V q / (Q (1-(1-q)^K) alpha)), f_max where the
    energy pressure is zero, clipped to [f_min, f_max]."""
    denom = queues * selection_probability(q, sys.k) * sys.capacitance
    f = (V * q / torch.clamp(denom, min=_EPS)).pow(1.0 / 3.0)
    f = torch.where(denom <= _EPS, torch.full_like(f, sys.f_max), f)
    return torch.clamp(f, sys.f_min, sys.f_max)


def _phi(x):
    return (1.0 + x) * torch.log1p(x) - x


def solve_p(sys: System, q, queues, h, V, iters: int):
    """Theorem 3: the root x of (1+x) ln(1+x) - x = V q h / (Q (1-(1-q)^K)
    N0) by bisection, p = x N0 / h, p_max where the pressure is zero."""
    denom = queues * selection_probability(q, sys.k) * sys.noise
    a1 = V * (q * h / torch.clamp(denom, min=_EPS))
    hi = torch.clamp(h * sys.p_max / sys.noise, min=1.0)
    for _ in range(40):
        hi = torch.where(_phi(hi) < a1, hi * 2.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = _phi(mid) < a1
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    p = 0.5 * (lo + hi) * sys.noise / torch.clamp(h, min=_EPS)
    p = torch.where(denom <= _EPS, torch.full_like(p, sys.p_max), p)
    return torch.clamp(p, sys.p_min, sys.p_max)


def _waterfill(b, a3, q_floor: float, iters: int):
    """argmin sum b q + a3 / q over the simplex: q(nu) = sqrt(a3 / (b +
    nu)) clipped, nu by bisection on sum q = 1, then renormalised."""
    a3 = torch.clamp(a3, min=_EPS)

    def q_of(nu):
        return torch.clamp(torch.sqrt(a3 / torch.clamp(b + nu, min=_EPS)),
                           q_floor, 1.0)

    n = b.shape[0]
    lo = -torch.min(b) + _EPS
    hi = torch.maximum(torch.max(a3 * (n ** 2) - b) + 1.0, lo + 1.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        big = torch.sum(q_of(mid)) > 1.0
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    q = q_of(0.5 * (lo + hi))
    return q / torch.sum(q)


def solve_q(sys: System, t_round, energy, queues, V, lam, q_init,
            cfg: Solver):
    """P2.2 by successive upper-bound minimisation: linearise
    -sum Q E (1-q)^K at the iterate and water-fill the convex surrogate,
    until an iterate moves by at most ``sum_tol``."""
    a2 = V * t_round
    a3 = V * lam * torch.square(sys.weights)
    q = q_init / torch.sum(q_init)
    prev = q + 1.0
    it = 0
    while it < cfg.sum_iters and float(torch.linalg.vector_norm(
            q - prev)) > cfg.sum_tol:
        grad = queues * energy * sys.k * torch.pow(1.0 - q, sys.k - 1.0)
        q, prev = _waterfill(a2 + grad, a3, cfg.q_floor,
                             cfg.bisect_iters), q
        it += 1
    return q


def decide_lroa(sys: System, h, queues, V, lam, cfg: Solver = Solver()):
    """Algorithm 2: alternate (f, p) closed forms with P2.2 from mid-range
    f, p and uniform q, until the normalised decision moves by at most
    ``outer_tol``."""
    f = sys.full(0.5 * (sys.f_min + sys.f_max))
    p = sys.full(0.5 * (sys.p_min + sys.p_max))
    q = sys.full(1.0 / sys.n)

    def pack(f_, p_, q_):
        return torch.cat([f_ / sys.f_max, p_ / sys.p_max, q_])

    prev = (f + sys.f_max, p, q)
    it = 0
    while it < cfg.outer_iters and float(torch.linalg.vector_norm(
            pack(f, p, q) - pack(*prev))) > cfg.outer_tol:
        f_new = solve_f(sys, q, queues, V)
        p_new = solve_p(sys, q, queues, h, V, cfg.bisect_iters)
        t = round_time(sys, h, p_new, f_new)
        e = round_energy(sys, h, p_new, f_new)
        q_new = solve_q(sys, t, e, queues, V, lam, q, cfg)
        prev, (f, p, q) = (f, p, q), (f_new, p_new, q_new)
        it += 1
    return f, p, q


def decide_uni_d(sys: System, h, queues, V, lam, cfg: Solver = Solver()):
    """Uni-D: q = 1/N with LROA's closed forms for (f, p)."""
    q = sys.full(1.0 / sys.n)
    return (solve_f(sys, q, queues, V),
            solve_p(sys, q, queues, h, V, cfg.bisect_iters), q)


def decide_uni_s(sys: System, h, queues, V, lam, cfg: Solver = Solver()):
    """Uni-S: q = 1/N, p mid-range, f from the energy balance
    (E alpha c D f^2 / 2 + p T_up) (1-(1-1/N)^K) = E-bar, clipped."""
    q = sys.full(1.0 / sys.n)
    p = sys.full(0.5 * (sys.p_min + sys.p_max))
    sel = 1.0 - (1.0 - 1.0 / sys.n) ** sys.k
    e_com = p * upload_time(sys, h, p)
    cyc = sys.epochs * sys.capacitance * sys.cycles * sys.sizes
    f_sq = 2.0 * (sys.budget / sel - e_com) / torch.clamp(cyc, min=1e-30)
    f = torch.clamp(torch.sqrt(torch.clamp(f_sq, min=0.0)), sys.f_min,
                    sys.f_max)
    return f, p, q


#: DivFL plans its resources as Uni-S does; its slot rule is the greedy
DECIDE = {"lroa": decide_lroa, "uni_d": decide_uni_d,
          "uni_s": decide_uni_s, "divfl": decide_uni_s}
SAMPLED = ("lroa", "uni_d", "uni_s")


def decide(name: str, sys: System, h, queues, V, lam):
    return DECIDE[name](sys, h, queues, V, lam)


# -- slot rules, as judges of a given selection ------------------------------

def sampled_bracket_gap(q, u, selected) -> float:
    """How far each slot's draw ``u * sum(q)`` lies outside its client's
    cumulative-q interval (0 where the selection is what q and the
    draws give): the largest such distance, in probability units."""
    cdf = torch.cumsum(q.to(torch.float64), 0).numpy()
    total = cdf[-1]
    lo = np.concatenate([[0.0], cdf[:-1]])
    x = np.asarray(u, np.float64) * total
    sel = np.asarray(selected, np.int64)
    gap = np.maximum(np.maximum(lo[sel] - x, x - cdf[sel]), 0.0)
    return float(np.max(gap) / total) if gap.size else 0.0


def divfl_gram(weights, h):
    """Row-normalised gram of the ``(w_n, h_n)`` client sketch."""
    feats = torch.stack([weights, h], dim=1)
    unit = feats / torch.clamp(torch.linalg.vector_norm(feats, dim=1),
                               min=1e-12)[:, None]
    return unit @ unit.T


def greedy_picks(sim, k: int):
    """The facility-location greedy: k picks, each the argmax of
    sum_n max(best_n, sim[n, j]) over the clients not yet picked."""
    n = sim.shape[0]
    best = torch.full((n,), float("-inf"), dtype=sim.dtype)
    chosen = torch.zeros(n, dtype=torch.bool)
    out = []
    for _ in range(k):
        gains = torch.maximum(best[:, None], sim).sum(0)
        gains = torch.where(chosen, float("-inf"), gains)
        j = int(torch.argmax(gains))
        best = torch.maximum(best, sim[:, j])
        chosen[j] = True
        out.append(j)
    return np.asarray(out, np.int64)


def greedy_gap(sim, selected) -> float:
    """Judge a greedy selection step by step: at each step the gain of
    the given pick against the best gain over the clients not yet
    picked, relative to the best (0 where each pick is a maximiser);
    a repeated pick reads 1."""
    n = sim.shape[0]
    best = torch.full((n,), float("-inf"), dtype=sim.dtype)
    chosen = torch.zeros(n, dtype=torch.bool)
    worst = 0.0
    for j in np.asarray(selected, np.int64).tolist():
        if chosen[j]:
            return 1.0
        gains = torch.maximum(best[:, None], sim).sum(0)
        gains = torch.where(chosen, float("-inf"), gains)
        top = float(torch.max(gains))
        worst = max(worst, (top - float(gains[j])) / max(abs(top), 1e-30))
        best = torch.maximum(best, sim[:, j])
        chosen[j] = True
    return worst


def select(name: str, sys: System, q, h, u) -> np.ndarray:
    """The reference's own selection: the inverse-CDF draw of ``u`` from
    q, or DivFL's greedy."""
    if name in SAMPLED:
        cdf = torch.cumsum(q.to(torch.float64), 0).numpy()
        idx = np.searchsorted(cdf, np.asarray(u) * cdf[-1], side="right")
        last = int(np.max(np.flatnonzero(q.numpy() > 0)))
        return np.minimum(idx, last).astype(np.int64)
    return greedy_picks(divfl_gram(sys.weights, h.to(sys.dtype)),
                        int(sys.k))


def selection_gap(name: str, sys: System, q, h, u, selected) -> float:
    if name in SAMPLED:
        return sampled_bracket_gap(q, u, selected)
    return greedy_gap(divfl_gram(sys.weights, h), selected)


def round_outputs(sys: System, h, f, p, q, queues, selected
                  ) -> Tuple[torch.Tensor, dict]:
    """The next queues and the round's modelled metrics for a selection:
    the slowest selected client's round time, the mean energy over the
    distinct selected clients, q's extremes, the queues' mean."""
    nq = next_queues(sys, queues, h, f, p, q)
    t = round_time(sys, h, p, f)
    e = round_energy(sys, h, p, f)
    sel = np.asarray(selected, np.int64)
    distinct = np.unique(sel)
    return nq, {"wall_time": float(torch.max(t[sel])),
                "energy_mean": float(torch.mean(e[distinct])),
                "q_min": float(torch.min(q)), "q_max": float(torch.max(q)),
                "queue_mean": float(torch.mean(nq))}
