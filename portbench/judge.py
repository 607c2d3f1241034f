"""The numbers that decide ``correct`` for a training cell.

Both sides start from the benchmark's weights and take the same first
steps on the same batches:

* ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the steps;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer took it (the program's read from its Adam
  state after one step: exp_avg / (1 - beta1));
* ``change_gap``: the worst leaf's gap between the norms of the
  parameters' change over the steps, read before the next step;
* ``loss1_gap``, ``loss2_gap``, ``grad_median_gap``,
  ``change_median_gap``: the first or the second step's loss alone, and
  the median leaf's gaps, for a cell whose later steps or single leaves
  are noise by nature (a cell's ``limits`` name the numbers it compares;
  PERF.md gives the look behind each choice);
* ``code_mismatch``: where both sides give the first step's chosen codes
  (``codes1``), the share of rows whose code differs (1 where the counts
  differ);
* ``weight_gap``: where both sides give the first step's aggregator
  weights (``alpha1``), the largest gap over the largest reference
  weight.

A leaf's gap is |norm(program) - norm(reference)| over the larger of the
reference's norm of that leaf and of the median leaf. The change leaves
out the leaves whose reference gradient is under a thousandth of the
median leaf's (they move under Adam by round-off alone, as a key bias
under softmax does).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch

NOUGHT_FRACTION = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in
            d.items()}


def worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep: Optional[List[str]] = None) -> Tuple[float, str]:
    names = keep if keep is not None else list(ref)
    pn, rn = _norms({n: prog[n] for n in names}), _norms(
        {n: ref[n] for n in names})
    med = statistics.median(rn.values())
    gaps = {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def readings(prog: Dict, ref: Dict, start: Dict[str, torch.Tensor]
             ) -> Dict[str, Dict]:
    """``prog`` and ``ref``: {"losses": [...], "grad1": {...},
    "params": {...}} (the program's ``params`` after the steps);
    ``start``: the weights both began from. Returns {name: {"value",
    "leaf"?}}."""
    loss_gap = float("inf")
    if len(prog["losses"]) == len(ref["losses"]):
        loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                       for p, r in zip(prog["losses"], ref["losses"]))
    g_gap, g_leaf = worst_leaf(prog["grad1"], ref["grad1"])
    gn = _norms(ref["grad1"])
    med = statistics.median(gn.values())
    moving = [n for n in ref["grad1"] if gn[n] >= NOUGHT_FRACTION * med]
    dprog = {n: prog["params"][n].double() - start[n].double()
             for n in moving}
    dref = {n: ref["params"][n].double() - start[n].double()
            for n in moving}
    c_gap, c_leaf = worst_leaf(dprog, dref)
    by_step = [abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"])]
    out = {"loss_gap": {"value": loss_gap,
                         "losses": [list(prog["losses"]),
                                    list(ref["losses"])]},
            "loss1_gap": {"value": by_step[0] if by_step else float("inf")},
            "loss2_gap": {"value": by_step[1] if len(by_step) > 1
                          else float("inf")},
            "grad_gap": {"value": g_gap, "leaf": g_leaf},
            "grad_median_gap": {"value": median_gap(prog["grad1"],
                                                    ref["grad1"])},
            "change_gap": {"value": c_gap, "leaf": c_leaf},
            "change_median_gap": {"value": median_gap(dprog, dref)}}
    if prog.get("codes1") is not None and ref.get("codes1") is not None:
        out["code_mismatch"] = {"value": code_mismatch(prog["codes1"],
                                                       ref["codes1"])}
    if "alpha1" in prog and "alpha1" in ref:
        a = torch.as_tensor(prog["alpha1"]).double().cpu().reshape(-1)
        r = torch.as_tensor(ref["alpha1"]).double().cpu().reshape(-1)
        out["weight_gap"] = {
            "value": float((a - r).abs().max() / r.abs().max())
            if a.shape == r.shape else float("inf"),
            "weights": [a.tolist(), r.tolist()]}
    return out


def code_mismatch(prog: List[torch.Tensor], ref: List[torch.Tensor]
                  ) -> float:
    """The share of rows whose chosen code differs, over all quantizers;
    1 where the quantizers or their row counts differ."""
    if len(prog) != len(ref) or any(p.numel() != r.numel()
                                    for p, r in zip(prog, ref)):
        return 1.0
    differ = sum(int((p.reshape(-1).long().cpu() != r.reshape(-1).long()
                      .cpu()).sum()) for p, r in zip(prog, ref))
    return differ / sum(r.numel() for r in ref)


def median_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> float:
    """The median leaf's gap, by the measure of :func:`worst_leaf`."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    return statistics.median(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
                             for n in rn)


def verdict(read: Dict[str, Dict], limits: Dict[str, float]) -> bool:
    """True when every number is finite and at or under its limit."""
    return all(k in read and read[k]["value"] == read[k]["value"]
               and read[k]["value"] <= lim for k, lim in limits.items())
