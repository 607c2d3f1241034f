"""Hypervolume indicator — the port's copy of ``movae_tpu/metrics/hv.py``
(numpy only; the port keeps its own copy rather than import the JAX
package).

The reference uses ``pymoo.indicators.hv.HV`` over the vector of mean
component losses against a reference point (default 1.1 per objective)
(the reference's main.py:33, 659-692, 1283, 1302-1306). In practice it always
evaluates the HV of a *single* point per epoch. This module implements an
exact hypervolume (WFG-style recursion) for small point sets (m <= 8,
n small), which covers both the single-point use and general fronts.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np


def hypervolume(points: np.ndarray, ref_point: np.ndarray) -> float:
    """Exact hypervolume dominated by `points` w.r.t. `ref_point`
    (minimization: only points <= ref contribute)."""
    pts = np.asarray(points, np.float64).reshape(-1, len(ref_point))
    ref = np.asarray(ref_point, np.float64)
    # clip points to the ref box; drop points that don't dominate any volume
    pts = pts[np.all(pts < ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    # remove dominated points
    keep = []
    for i, p in enumerate(pts):
        dominated = any(
            np.all(q <= p) and np.any(q < p)
            for j, q in enumerate(pts) if j != i)
        if not dominated:
            keep.append(p)
    pts = np.unique(np.asarray(keep), axis=0)
    return _wfg(pts, ref)


def _wfg(pts: np.ndarray, ref: np.ndarray) -> float:
    if len(pts) == 0:
        return 0.0
    if len(pts) == 1:
        return float(np.prod(ref - pts[0]))
    # inclusion-exclusion via exclusive-hypervolume recursion
    order = np.argsort(pts[:, 0])
    pts = pts[order]
    total = 0.0
    for i in range(len(pts)):
        p = pts[i]
        box = float(np.prod(ref - p))
        # subtract overlap with the union of the remaining points, limited
        # to p's box
        rest = np.maximum(pts[i + 1:], p)
        total += box - _wfg(rest, ref)
    return total


class HVIndicator:
    """pymoo-HV-shaped callable (reference build_hv_indicator,
    main.py:659-692)."""

    def __init__(self, ref_point: np.ndarray):
        self.ref_point = np.asarray(ref_point, np.float64)

    def __call__(self, points) -> float:
        return hypervolume(np.asarray(points), self.ref_point)


def build_hv_indicator(
    objective_keys: Sequence[str],
    hv_ref: Union[None, Sequence[float], Dict[str, float]] = None,
    default_ref: float = 1.1,
) -> Optional[HVIndicator]:
    """Reference-point resolution as in main.py:659-692: needs >= 2
    objectives (else None); a dict fills missing keys with 1.1; a
    wrong-length list falls back to all-1.1 (never disables HV)."""
    keys = list(objective_keys)
    m = len(keys)
    if m < 2:
        return None
    if hv_ref is None:
        ref = np.full((m,), default_ref)
    elif isinstance(hv_ref, dict):
        ref = np.asarray([float(hv_ref.get(k, default_ref)) for k in keys])
    else:
        vals = list(hv_ref)
        if len(vals) != m:
            ref = np.full((m,), default_ref)
        else:
            ref = np.asarray([float(v) for v in vals])
    return HVIndicator(ref)
