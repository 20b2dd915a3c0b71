"""Roofline terms of a counted step on the H100: the port of
``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds, from
``launch.op_cost``'s counts and the card's constants in
``launch.mesh``::

    compute    = flops            / PEAK_FLOPS_BF16
    memory     = bytes            / HBM_BW
    collective = collective_bytes / LINK_BW

The counts are per device (one rank's step), as the reference's
per-device ``cost_analysis`` numbers are, so ``chips`` only scales the
useful-flops ratio.  The reference reconstructs its collectives from
HLO text (``parse_collectives``); here ``launch.mesh``'s collectives
record a :class:`CollectiveOp` each, with the same ring formulas
(:func:`collective_op`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    operand_bytes: int
    ici_traffic_bytes: int       # ring-algorithm per-chip traffic estimate


def collective_op(kind: str, result_bytes: int, g: int) -> CollectiveOp:
    """One collective of ``kind`` whose result is ``result_bytes`` over a
    group of ``g``: its operand bytes and per-chip ring traffic, by the
    reference's formulas (``repro.launch.roofline.parse_collectives``)."""
    if kind == "all-gather":
        operand = result_bytes // max(g, 1)
        traffic = result_bytes * (g - 1) // max(g, 1)
    elif kind == "reduce-scatter":
        operand = result_bytes * g
        traffic = result_bytes * (g - 1)
    elif kind == "all-reduce":
        operand = result_bytes
        traffic = 2 * result_bytes * (g - 1) // max(g, 1)
    elif kind == "all-to-all":
        operand = result_bytes
        traffic = result_bytes * (g - 1) // max(g, 1)
    else:                      # collective-permute
        operand = result_bytes
        traffic = result_bytes
    return CollectiveOp(kind, result_bytes, g, operand, traffic)


def roofline_terms(analysis: Dict, *, chips: int,
                   model_flops: float = 0.0) -> Dict:
    """``analysis``: :meth:`repro_torch.launch.op_cost.OpCounter.analyze`
    of one device's step.  The reference's keys, but its two
    ``xla_raw_*`` ones: the port has no XLA ``cost_analysis`` to
    cross-check against."""
    flops = float(analysis["flops"])
    bytes_accessed = float(analysis["bytes"])
    coll_operand = float(analysis["collective_operand_bytes"])
    coll_traffic = float(analysis["collective_traffic_bytes"])

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_operand / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s,
             "collective_traffic_s": coll_traffic / LINK_BW,
             "hlo_flops_per_device": flops,
             "hlo_bytes_per_device": bytes_accessed,
             "collective_operand_bytes": coll_operand,
             "collective_traffic_bytes": coll_traffic,
             "collective_counts": analysis.get("collective_counts", {}),
             "collective_bytes_by_kind":
                 analysis.get("collective_bytes_by_kind", {})}
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    terms["dominant"] = dominant
    if model_flops:
        terms["model_flops"] = model_flops
        global_flops = flops * chips
        terms["model_flops_ratio"] = (model_flops / global_flops
                                      if global_flops else 0.0)
    return terms


def train_model_flops(param_count: int, active_param_count: int,
                      tokens: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE)."""
    return 6.0 * active_param_count * tokens


def decode_model_flops(active_param_count: int, batch: int) -> float:
    """One decode step: 2 N_active per token."""
    return 2.0 * active_param_count * batch


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':10s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'coll_s':>10s} {'dominant':>12s} "
           f"{'useful%':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        t = r["terms"]
        useful = t.get("model_flops_ratio", 0.0) * 100
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:10s} "
            f"{t['compute_s']:10.4f} {t['memory_s']:10.4f} "
            f"{t['collective_s']:10.4f} {t['dominant']:>12s} {useful:8.1f}")
    return "\n".join(lines)
