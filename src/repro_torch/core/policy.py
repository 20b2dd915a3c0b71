"""Controllers as data: the per-round decision rules of the paper's
comparison as pure functions of ``(params, h, queues, V, lam)``, and the
slot-filling rules behind them — the port of ``repro.core.policy``.

The controller zoo (ids in :data:`POLICIES` order; ids 0-2 are frozen):

* :func:`decide_lroa`          — Algorithm 2 (``solver.solve_p2``);
* :func:`decide_uni_d`         — uniform q, LROA's dynamic (f, p) forms;
* :func:`decide_uni_s`         — uniform q, mid-range p, f from the Uni-S
  energy-balance equation (:func:`static_frequency`);
* :func:`decide_channel_aware` — best-channel scheduling (Shi et al.,
  arXiv:1911.00856): all selection mass on the K strongest channels,
  dynamic (f, p) under that q;
* :func:`decide_cost_effective`— adaptive sampling (Luo et al.,
  arXiv:2109.05411): q proportional to data weight per square root of
  round cost, static resources;
* :func:`decide_round_robin`   — uniform q and LROA's dynamic (f, p); the
  cyclic schedule is its selection rule;
* :func:`decide_divfl`         — DivFL's resource plan (uniform q, static
  resources); the facility-location greedy is its selection rule.

Every rule takes ``k``, K as data (``system_model.effective_k``), and
:func:`decide_by_id` indexes :data:`DECIDE_FNS` by controller id (the JAX
package's traced ``lax.switch`` matters only under its arena's vmap).

Selection layer: a rule emits the distribution (f, p, q); how the K slots
are filled from it is a second, per-controller choice
(:data:`SELECTION_MODES`, dispatched by :func:`select_by_id`):

* ``sampled`` (:func:`sampled_selection`) — the paper's i.i.d.
  with-replacement draw, an inverse-CDF draw from q per slot keyed by
  ``draws.fold(key, slot)``;
* ``round_robin`` (:func:`round_robin_selection`) — client
  ``(t * K + slot) mod N``;
* ``greedy`` (:func:`divfl_selection`) — DivFL's K-step facility-location
  greedy over the client-feature gram (:func:`divfl_similarity`).

All three are prefix-stable in the slot index: slot i never depends on
the slot count K_max, so a padded rollout fills its first K slots as the
unpadded one does.  Every function runs on the device of its inputs and
reads nothing back to the host.
"""

from __future__ import annotations

import torch

from repro_torch.core import draws
from repro_torch.core import solver as slv
from repro_torch.core import system_model as sm
from repro_torch.kernels import ref

#: the controller zoo in id order; ``run_scan``'s ``policy=`` strings
#: resolve through :data:`POLICY_IDS`
POLICIES = ("lroa", "uni_d", "uni_s", "channel_aware", "cost_effective",
            "round_robin", "divfl")
POLICY_IDS = {name: i for i, name in enumerate(POLICIES)}


def _uniform_q(params: sm.SystemParams) -> torch.Tensor:
    n = params.num_devices
    return torch.full((n,), 1.0 / n, dtype=torch.float32,
                      device=params.device)


def _mid_power(params: sm.SystemParams) -> torch.Tensor:
    return 0.5 * (params.p_min + params.p_max)


def decide_lroa(params: sm.SystemParams, h: torch.Tensor,
                queues: torch.Tensor, V, lam,
                cfg: slv.SolverConfig = slv.SolverConfig(),
                k=None) -> slv.ControlDecision:
    """LROA: the full Algorithm-2 drift-plus-penalty solve."""
    return slv.solve_p2(params, h, queues, V, lam, cfg, k=k)


def decide_uni_d(params: sm.SystemParams, h: torch.Tensor,
                 queues: torch.Tensor, V, lam,
                 cfg: slv.SolverConfig = slv.SolverConfig(),
                 k=None) -> slv.ControlDecision:
    """Uni-D: q = 1/N; (f, p) from the Theorem-2/3 closed forms."""
    q = _uniform_q(params)
    f = slv.solve_f(params, q, queues, V, k=k)
    p = slv.solve_p(params, q, queues, h, V, cfg.bisect_iters, k=k)
    return slv.ControlDecision(f=f, p=p, q=q)


def static_frequency(params: sm.SystemParams, h: torch.Tensor,
                     p: torch.Tensor, k=None) -> torch.Tensor:
    """Solve the Uni-S energy balance for f (projected to [f_min, f_max]).

    [E alpha c D f^2 / 2 + p M K / (B log2(1 + h p / N0))] * sel = Ebar
    with sel = 1 - (1 - 1/N)^K  =>  f^2 = 2 (Ebar/sel - E_com) / (E alpha c D).
    """
    n = params.num_devices
    sel = 1.0 - (1.0 - 1.0 / n) ** sm.effective_k(params, k)
    e_com = sm.comm_energy(params, h, p, k=k)
    cycles = params.local_epochs * params.capacitance * \
        params.cycles_per_sample * params.data_sizes
    f_sq = 2.0 * (params.energy_budget / sel - e_com) / torch.clamp(
        cycles, min=1e-30)
    f = torch.sqrt(torch.clamp(f_sq, min=0.0))
    return torch.clamp(f, params.f_min, params.f_max)


def decide_uni_s(params: sm.SystemParams, h: torch.Tensor,
                 queues: torch.Tensor, V, lam,
                 cfg: slv.SolverConfig = slv.SolverConfig(),
                 k=None) -> slv.ControlDecision:
    """Uni-S: q = 1/N, p mid-range, f from the energy-balance equation
    (``queues``, ``V`` and ``lam`` are ignored: every rule shares one
    signature)."""
    q = _uniform_q(params)
    p = _mid_power(params)
    f = static_frequency(params, h, p, k=k)
    return slv.ControlDecision(f=f, p=p, q=q)


def decide_channel_aware(params: sm.SystemParams, h: torch.Tensor,
                         queues: torch.Tensor, V, lam,
                         cfg: slv.SolverConfig = slv.SolverConfig(),
                         k=None) -> slv.ControlDecision:
    """Best-channel scheduling: q uniform over the K strongest channels
    (``rank(h) < K``), 0 elsewhere, so ``min(q)`` is 0; (f, p) from
    LROA's closed forms under that q.

    The rank is a double stable argsort, as the JAX package's (its
    ``argsort`` is stable): equal gains rank in index order.
    """
    k_eff = sm.effective_k(params, k)
    ranks = torch.argsort(torch.argsort(-h, stable=True), stable=True)
    mask = (ranks < k_eff).to(torch.float32)
    q = mask / torch.sum(mask)
    f = slv.solve_f(params, q, queues, V, k=k)
    p = slv.solve_p(params, q, queues, h, V, cfg.bisect_iters, k=k)
    return slv.ControlDecision(f=f, p=p, q=q)


def decide_cost_effective(params: sm.SystemParams, h: torch.Tensor,
                          queues: torch.Tensor, V, lam,
                          cfg: slv.SolverConfig = slv.SolverConfig(),
                          k=None) -> slv.ControlDecision:
    """Adaptive cost-effective sampling: ``q_n ∝ w_n / sqrt(T_n)`` with
    ``T_n`` the round time under static resources, floored at
    ``cfg.q_floor`` so every q stays positive (the eq.-(4) coefficient
    divides by it)."""
    p = _mid_power(params)
    f = static_frequency(params, h, p, k=k)
    cost = sm.round_time(params, h, p, f, k=k)
    score = params.data_weights / torch.sqrt(torch.clamp(cost, min=1e-12))
    q = score / torch.sum(score)
    q = torch.clamp(q, min=cfg.q_floor)
    q = q / torch.sum(q)
    return slv.ControlDecision(f=f, p=p, q=q)


def decide_round_robin(params: sm.SystemParams, h: torch.Tensor,
                       queues: torch.Tensor, V, lam,
                       cfg: slv.SolverConfig = slv.SolverConfig(),
                       k=None) -> slv.ControlDecision:
    """Round-robin: q = 1/N (the long-run visit frequency, which the
    eq.-(4) coefficients and the queue drift read) and Uni-D's (f, p);
    the slots are filled by :func:`round_robin_selection`."""
    return decide_uni_d(params, h, queues, V, lam, cfg, k=k)


def decide_divfl(params: sm.SystemParams, h: torch.Tensor,
                 queues: torch.Tensor, V, lam,
                 cfg: slv.SolverConfig = slv.SolverConfig(),
                 k=None) -> slv.ControlDecision:
    """DivFL's resource plan: Uni-S's (uniform q, mid-range p,
    energy-balance f); the slots are filled by :func:`divfl_selection`."""
    return decide_uni_s(params, h, queues, V, lam, cfg, k=k)


#: the rules in :data:`POLICIES` order
DECIDE_FNS = (decide_lroa, decide_uni_d, decide_uni_s,
              decide_channel_aware, decide_cost_effective,
              decide_round_robin, decide_divfl)


def _clamp_id(controller_id, count: int) -> int:
    """An id clamped into ``[0, count)``, as ``lax.switch`` clamps."""
    return min(max(int(controller_id), 0), count - 1)


def decide_by_id(controller_id, params: sm.SystemParams, h: torch.Tensor,
                 queues: torch.Tensor, V, lam,
                 cfg: slv.SolverConfig = slv.SolverConfig(),
                 k=None) -> slv.ControlDecision:
    """The rule of controller ``controller_id`` (an index into
    :data:`POLICIES`; out-of-range ids clamp, as in the JAX package)."""
    fn = DECIDE_FNS[_clamp_id(controller_id, len(DECIDE_FNS))]
    return fn(params, h, queues, V, lam, cfg, k=k)


# --------------------------------------------------------------------------
# Selection layer — how the K slots are filled from a ControlDecision
# --------------------------------------------------------------------------

SELECT_SAMPLED, SELECT_ROUND_ROBIN, SELECT_GREEDY = 0, 1, 2

#: per-policy selection mode
SELECTION_MODES = {
    "lroa": SELECT_SAMPLED,
    "uni_d": SELECT_SAMPLED,
    "uni_s": SELECT_SAMPLED,
    "channel_aware": SELECT_SAMPLED,
    "cost_effective": SELECT_SAMPLED,
    "round_robin": SELECT_ROUND_ROBIN,
    "divfl": SELECT_GREEDY,
}
_MODE_TABLE = tuple(SELECTION_MODES[name] for name in POLICIES)


def sampled_selection(params: sm.SystemParams, t, h: torch.Tensor,
                      queues: torch.Tensor, q: torch.Tensor,
                      key: torch.Tensor, slots: torch.Tensor,
                      kvec) -> torch.Tensor:
    """The paper's i.i.d. with-replacement draw from q, per slot.

    Slot i takes ``u = uniform(fold(key, i))`` (``core.draws``) and the
    client whose cumulative-q interval holds ``u * sum(q)`` (float64
    inverse CDF): a client with q = 0 is never drawn, and slot i's pick
    does not depend on ``len(slots)``.
    """
    u = draws.uniform_f64(draws.fold(key, slots))
    cdf = torch.cumsum(q.to(torch.float64), 0)
    idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
    # u * sum(q) may round up to sum(q): keep the last client with q > 0
    pos = torch.arange(q.shape[0], device=q.device)
    last = torch.max(torch.where(q > 0, pos, 0))
    return torch.minimum(idx, last)


def round_robin_selection(params: sm.SystemParams, t, h: torch.Tensor,
                          queues: torch.Tensor, q: torch.Tensor,
                          key: torch.Tensor, slots: torch.Tensor,
                          kvec) -> torch.Tensor:
    """The cyclic schedule: round ``t`` (the global round index) fills
    slot i with client ``(t * K + i) mod N``, K read from ``kvec[0]``."""
    n = params.num_devices
    k_i = torch.as_tensor(kvec, device=slots.device).reshape(-1)[0].to(
        slots.dtype)
    return (t * k_i + slots) % n


def divfl_features(params: sm.SystemParams, h: torch.Tensor
                   ) -> torch.Tensor:
    """Per-client ``(data weight, channel gain)`` sketch ``[N, 2]``: the
    observable state every other rule conditions on."""
    return torch.stack([params.data_weights, h], dim=1)


def _ordered_sum(m: torch.Tensor) -> torch.Tensor:
    """``m.sum(0)`` accumulated slice by slice in index order.

    Each step is one elementwise add, rounded once, so the CPU and the
    card give the same bits (a reduction kernel sums in another order on
    each, and a near-tie of DivFL's gains then picks other clients); it
    is also numpy's order for an axis-0 sum, so the device greedy and
    the host greedy (``baselines.facility_location_greedy``) agree.
    """
    acc = m[0]
    for row in m[1:]:
        acc = acc + row
    return acc


def _fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_d a[..., d] * b[..., d]`` as a fused multiply-add chain in d
    order (``a_0 b_0`` rounded, then ``fmaf(a_d, b_d, acc)``), computed
    exactly by ``kernels.ref.fma_f32``: the rounding XLA gives the JAX
    package's gram and norms, and the same bits on the CPU and the
    card."""
    acc = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        acc = ref.fma_f32(a[..., d], b[..., d], acc)
    return acc


def divfl_similarity(feats: torch.Tensor) -> torch.Tensor:
    """Row-normalised gram matrix ``[N, N]`` of a ``[N, D]`` sketch,
    each entry and each norm a multiply-add chain over D
    (:func:`_fma_dot`, no matmul): bitwise the JAX package's gram, on the
    CPU and on the card.  The square root is taken in float64 and rounded
    to float32, which is the correctly rounded float32 root (torch's
    vectorised float32 ``sqrt`` on the CPU is not, in about 0.6% of
    inputs)."""
    norms = torch.sqrt(_fma_dot(feats, feats).double()).float()
    unit = feats / torch.clamp(norms, min=1e-12)[:, None]
    return _fma_dot(unit[:, None, :], unit[None, :, :])


def facility_location_select(similarity: torch.Tensor, k: int
                             ) -> torch.Tensor:
    """K-step greedy facility-location maximisation on the device.

    Step i scores every client by ``sum_n max(best_n, sim[n, j])``
    (summed over n in order, :func:`_ordered_sum`) with chosen clients
    masked to -inf, takes the argmax (ties to the lowest index:
    ``torch.argmax`` returns the first maximum) and folds its column
    into ``best`` — the loop of ``baselines.facility_location_greedy``,
    with the same sums.  Step i reads only steps < i, so the first picks
    do not depend on k.  N launches per step: the order is what makes
    the CPU's and the card's picks the same.
    """
    n = similarity.shape[0]
    best = torch.full((n,), float("-inf"), dtype=similarity.dtype,
                      device=similarity.device)
    chosen = torch.zeros((n,), dtype=torch.bool, device=similarity.device)
    out = []
    for _ in range(k):
        gains = _ordered_sum(torch.maximum(best[:, None], similarity))
        gains = torch.where(chosen, float("-inf"), gains)
        j = torch.argmax(gains).reshape(1)
        best = torch.maximum(best, similarity.index_select(1, j)[:, 0])
        chosen = chosen.index_fill(0, j, True)
        out.append(j)
    if not out:
        return torch.zeros((0,), dtype=torch.int64,
                           device=similarity.device)
    return torch.cat(out)


def divfl_selection(params: sm.SystemParams, t, h: torch.Tensor,
                    queues: torch.Tensor, q: torch.Tensor,
                    key: torch.Tensor, slots: torch.Tensor,
                    kvec) -> torch.Tensor:
    """DivFL: greedy facility-location picks over the feature gram."""
    sim = divfl_similarity(divfl_features(params, h))
    return facility_location_select(sim, slots.shape[0])


#: the selection rules in SELECT_* order
SELECT_FNS = (sampled_selection, round_robin_selection, divfl_selection)


def select_by_id(controller_id, params: sm.SystemParams, t,
                 h: torch.Tensor, queues: torch.Tensor, q: torch.Tensor,
                 key: torch.Tensor, slots: torch.Tensor,
                 kvec) -> torch.Tensor:
    """The selection rule of controller ``controller_id`` (ids clamp)."""
    mode = _MODE_TABLE[_clamp_id(controller_id, len(_MODE_TABLE))]
    return SELECT_FNS[mode](params, t, h, queues, q, key, slots, kvec)
