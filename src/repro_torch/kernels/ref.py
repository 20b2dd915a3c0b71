"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function is the specification its CUDA kernel is held against on
the card (``chip_smoke.py``, the ``cuda``-marked tests) and the path the
CPU tests take; the CPU tests in turn hold it against the JAX package's
Pallas kernel run in interpret mode.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def aggregate_reference(theta: torch.Tensor, deltas: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """theta: [N]; deltas: [K, N]; coeffs: [K] — eq. (4) fused update,
    summed in f32 and returned in theta's dtype."""
    upd = torch.tensordot(coeffs.to(torch.float32),
                          deltas.to(torch.float32), dims=1)
    return (theta.to(torch.float32) + upd).to(theta.dtype)


def delta_reduce_reference(deltas: torch.Tensor, coeffs: torch.Tensor
                           ) -> torch.Tensor:
    """deltas: [K, N]; coeffs: [K] -> f32 [N], ``sum_k coeffs_k delta_k``."""
    return torch.tensordot(coeffs.to(torch.float32),
                           deltas.to(torch.float32), dims=1)


def delta_reduce_leaves_reference(deltas: Sequence[torch.Tensor],
                                  coeffs: torch.Tensor) -> List[torch.Tensor]:
    """Per leaf f32 ``sum_k coeffs_k deltas[i][k]`` as a broadcast-multiply
    and a sum over the client axis: the partial term of
    :func:`aggregate_leaves_reference` (the JAX package's off-TPU
    ``aggregate_fused_psum``), so ``theta + partial`` is its result bit
    for bit."""
    c32 = coeffs.to(torch.float32)
    outs = []
    for d in deltas:
        d = d.to(torch.float32)
        c = c32.reshape((d.shape[0],) + (1,) * (d.dim() - 1))
        outs.append(torch.sum(c * d, dim=0))
    return outs


def aggregate_leaves_reference(thetas: Sequence[torch.Tensor],
                               deltas: Sequence[torch.Tensor],
                               coeffs: torch.Tensor) -> List[torch.Tensor]:
    """Per leaf, ``thetas[i] + sum_k coeffs_k deltas[i][k]`` (deltas[i] of
    shape ``(K,) + thetas[i].shape``) as a broadcast-multiply and a sum
    over the client axis, in f32, returned in theta's dtype: the
    arithmetic of ``fl.server.aggregate_stacked``."""
    c32 = coeffs.to(torch.float32)
    outs = []
    for p, d in zip(thetas, deltas):
        d = d.to(torch.float32)
        c = c32.reshape((d.shape[0],) + (1,) * (d.dim() - 1))
        outs.append((p.to(torch.float32) + torch.sum(c * d, dim=0)).to(
            p.dtype))
    return outs


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` on f32 tensors rounded once to f32, as the card's
    fused multiply-add (``fmaf``) rounds it.  ``a * b`` is exact in f64;
    TwoSum splits ``a * b + c`` into its f64 rounding ``hi`` and the exact
    rest ``lo``; rounding ``hi`` to f32 is then right unless ``hi`` lies
    exactly half-way between two f32 values with ``lo != 0``, where the
    rest's sign picks the side."""
    p = a.double() * b.double()
    c64 = c.double()
    hi = p + c64
    bb = hi - p
    lo = (p - (hi - bb)) + (c64 - bb)
    r = hi.float()
    toward = torch.where(hi > r.double(), torch.inf, -torch.inf).float()
    r2 = torch.nextafter(r, toward)
    midpoint = (r.double() + r2.double()) * 0.5 == hi
    rest_toward_r2 = torch.where(r2 > r, lo > 0, lo < 0)
    return torch.where(midpoint & rest_toward_r2, r2, r)


def aggregate_leaves_fma_reference(thetas: Sequence[torch.Tensor] | None,
                                   deltas: Sequence[torch.Tensor],
                                   coeffs: torch.Tensor
                                   ) -> List[torch.Tensor]:
    """The CUDA kernel's per-element arithmetic, bit for bit: the sum
    starts at 0, takes ``fmaf(coeffs[k], delta[k], acc)`` for k = 0..K-1
    in order (:func:`fma_f32`), adds theta in f32 and rounds once to
    theta's dtype; with ``thetas=None`` (the reduce) it returns the f32
    sum."""
    c32 = coeffs.to(torch.float32)
    outs = []
    for i, d in enumerate(deltas):
        d = d.to(torch.float32)
        acc = torch.zeros(d.shape[1:], dtype=torch.float32, device=d.device)
        for k in range(d.shape[0]):
            acc = fma_f32(c32[k], d[k], acc)
        if thetas is None:
            outs.append(acc)
        else:
            outs.append((thetas[i].to(torch.float32) + acc).to(
                thetas[i].dtype))
    return outs


def _per_lane(fn, thetas: Sequence[torch.Tensor],
              deltas: Sequence[torch.Tensor], coeffs: torch.Tensor
              ) -> List[torch.Tensor]:
    """``fn`` (a one-model leaf function) on each lane s of ``[S, ...]``
    thetas, ``[S, K, ...]`` deltas and ``[S, K]`` coeffs, stacked back
    to ``[S, ...]`` per leaf."""
    lanes = [fn([t[s] for t in thetas], [d[s] for d in deltas], coeffs[s])
             for s in range(coeffs.shape[0])]
    return [torch.stack([lane[i] for lane in lanes])
            for i in range(len(thetas))]


def aggregate_lanes_reference(thetas: Sequence[torch.Tensor],
                              deltas: Sequence[torch.Tensor],
                              coeffs: torch.Tensor) -> List[torch.Tensor]:
    """The scenario arena's eq.-(4) step over S lanes: per lane s,
    :func:`aggregate_leaves_reference` of ``[t[s] for t in thetas]``,
    ``[d[s] for d in deltas]`` and ``coeffs[s]``, stacked per leaf."""
    return _per_lane(aggregate_leaves_reference, thetas, deltas, coeffs)


def aggregate_lanes_fma_reference(thetas: Sequence[torch.Tensor],
                                  deltas: Sequence[torch.Tensor],
                                  coeffs: torch.Tensor
                                  ) -> List[torch.Tensor]:
    """The lane kernel's arithmetic, bit for bit: per lane
    :func:`aggregate_leaves_fma_reference`, stacked per leaf."""
    return _per_lane(aggregate_leaves_fma_reference, thetas, deltas, coeffs)


NEG_INF = -2.0e38


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None, return_lse: bool = False):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Sk, D] (GQA when Hkv < H) ->
    [B, H, Sq, D] in q's dtype.  Scale, then soft-cap, then mask, in f32;
    the plain version of the flash-attention kernel.  With
    ``return_lse``, ``(out, lse)``: lse f32 ``[B, H, Sq]``, each row's
    log-sum-exp of its masked logits (natural log), the kernel's
    optional second output."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, group, sq, d).to(torch.float32)
    logits = torch.einsum("bngsd,bntd->bngst", qg,
                          k.to(torch.float32)) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngst,bntd->bngsd", p, v.to(torch.float32))
    out = out.reshape(b, h, sq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, h, sq)


def _masked_exp(seg: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``where(keep, exp(seg), 0)`` with the same values, and a gradient
    that is 0, not NaN, where ``exp(seg)`` would overflow outside ``keep``
    (the JAX package's ``where(tri, exp(seg), 0)`` gives NaN there:
    ROADMAP section C)."""
    return torch.where(keep, torch.exp(torch.where(keep, seg, 0.0)), 0.0)


def ssd_chunk_reference(x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b_in: torch.Tensor,
                        c_in: torch.Tensor):
    """Intra-chunk SSD, one chunk, zero initial state.

    x: [L, nh, hd]; dt: [L, nh]; a_log: [nh]; b_in/c_in: [L, N].
    Returns (y_diag [L, nh, hd] in x's dtype, state [nh, hd, N] f32), the
    state being the end-of-chunk summary
    ``sum_j exp(cum_L - cum_j) dt_j (x_j ⊗ B_j)``.
    """
    length = x.shape[0]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    da = dt.to(f32) * a                                      # [L, nh]
    cum = torch.cumsum(da, dim=0)                            # [L, nh]
    seg = cum[:, None, :] - cum[None, :, :]                  # [i, j, nh]
    tri = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                device=x.device))
    # select, never multiply by a 0/1 mask: exp(seg) overflows above the
    # diagonal, where seg > 0; and exponentiate 0 there, so that the
    # backward's 0 * exp(seg) is 0 and not NaN (the values are the same)
    decay = _masked_exp(seg, tri[:, :, None])
    scores = torch.einsum("in,jn->ij", c_in.to(f32), b_in.to(f32))
    w = scores[:, :, None] * decay * dt[None].to(f32)
    y = torch.einsum("ijh,jhd->ihd", w, x.to(f32))
    decay_to_end = torch.exp(cum[-1:, :] - cum)              # [L, nh]
    wx = x.to(f32) * (dt.to(f32) * decay_to_end)[..., None]
    state = torch.einsum("lhd,ln->hdn", wx, b_in.to(f32))
    return y.to(x.dtype), state


def ssd_chunk_batched_reference(x: torch.Tensor, dt: torch.Tensor,
                                a_log: torch.Tensor, b_in: torch.Tensor,
                                c_in: torch.Tensor, chunk: int):
    """:func:`ssd_chunk_reference` over every (batch, chunk), with the
    signature of the SSD-chunk kernel: x [B, S, nh, hd], dt [B, S, nh],
    a_log [nh], b_in/c_in [B, S, N], S a multiple of ``chunk`` ->
    (y_diag [B, S, nh, hd], states [B, nc, nh, hd, N] f32)."""
    bsz, s, nh, hd = x.shape
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(bsz, nc, chunk, nh, hd).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, nh).to(f32)
    bc = b_in.reshape(bsz, nc, chunk, -1).to(f32)
    cc = c_in.reshape(bsz, nc, chunk, -1).to(f32)
    a = -torch.exp(a_log.to(f32))
    cum = torch.cumsum(dtc * a, dim=2)                       # [B,nc,L,nh]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [B,nc,i,j,nh]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = _masked_exp(seg, tri[:, :, None])
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    w = scores[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhd->bcihd", w, xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    wx = xc * (dtc * decay_to_end)[..., None]
    states = torch.einsum("bclhd,bcln->bchdn", wx, bc)
    return y.reshape(bsz, s, nh, hd).to(x.dtype), states
