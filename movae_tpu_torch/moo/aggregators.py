"""Gramian-level multi-objective aggregators — port of
``movae_tpu/moo/aggregators.py`` for ``sum``, ``jd_sum``, ``mean``,
``upgrad`` and ``dualproj``.

Each aggregator maps the per-objective Gramian ``G = J J^T`` to a weight
vector ``alpha``; the update direction is ``alpha^T J``. Everything stays on
G's device. The other aggregator names of the JAX package raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from movae_tpu_torch.moo import solvers

Tensor = torch.Tensor

_NOT_PORTED = (
    "nupgrad", "pnupgrad", "pcgrad", "mgda", "mgda_ln", "mgda_gn", "mgda_lgn",
    "aligned_mtl", "aligned_mtl_min", "amtl", "amtl_min",
    "aligned_mtl_median", "aligned_mtl_rmse", "cagrad", "imtlg", "nashmtl",
    "comfort",
)


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Static aggregator configuration (field names as in the JAX package)."""

    name: str = "sum"
    num_objectives: int = 2
    reg_eps: float = 1e-4
    pref_vector: Optional[Tuple[float, ...]] = None
    # COMFORT beta schedule
    comfort_beta_k: float = 1.0
    comfort_beta_a: float = 1.0
    comfort_beta_l: float = 0.01
    comfort_beta_u: float = 1.0

    @property
    def is_sum(self) -> bool:
        return self.name in ("sum", None)

    def pref(self, device=None) -> Tensor:
        m = self.num_objectives
        if self.pref_vector is None:
            return torch.full((m,), 1.0 / m, dtype=torch.float32,
                              device=device)
        v = torch.as_tensor(self.pref_vector, dtype=torch.float32,
                            device=device)
        if v.shape != (m,):
            raise ValueError(
                f"pref_vector must have length {m}, got {tuple(v.shape)}")
        return v


def init_state(cfg: AggregatorConfig) -> Dict[str, Tensor]:
    """Per-aggregator carried state (none of the ported aggregators keeps
    any)."""
    return {}


def comfort_beta(cfg: AggregatorConfig, epoch: Union[int, Tensor],
                 total_epochs: int) -> Tensor:
    """Beta-VAE style epoch schedule l->u; ``epoch`` is 1-based."""
    k, a = cfg.comfort_beta_k, cfg.comfort_beta_a
    l, u = cfg.comfort_beta_l, cfg.comfort_beta_u
    if total_epochs <= 1:
        return torch.tensor(u, dtype=torch.float32)
    epoch = torch.as_tensor(epoch, dtype=torch.float32)
    progress = torch.clamp((epoch - 1.0) / float(total_epochs - 1),
                           0.0, 1.0) ** a
    if k <= 0:
        f = progress
    else:
        f = (1.0 - torch.exp(-k * progress)) / (1.0 - math.exp(-k))
    return torch.clamp(l + (u - l) * f, l, u)


def _upgrad_alpha(G: Tensor, w: Tensor, reg_eps: float) -> Tensor:
    """UPGrad: project each weighted row onto the dual cone; sum."""
    Gr = solvers.regularize_gramian_diag(G, reg_eps)
    return solvers.project_weight_rows(torch.diag(w), Gr).sum(0)


def _dualproj_alpha(G: Tensor, w: Tensor, reg_eps: float) -> Tensor:
    """DualProj: project the preference-weighted gradient onto the dual
    cone."""
    Gr = solvers.regularize_gramian_diag(G, reg_eps)
    return solvers.dual_cone_project_weights(w, Gr)


def compute_weights(
    cfg: AggregatorConfig,
    G: Tensor,
    losses: Tensor,
    state: Dict[str, Tensor],
    beta: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Map the (m, m) Gramian to alpha. Returns (alpha, new_state).
    ``losses`` and ``beta`` are read by aggregators not ported yet."""
    name = cfg.name.lower()
    m = cfg.num_objectives
    G = G.float()
    if name in ("sum", "jd_sum"):
        return torch.ones(m, dtype=torch.float32, device=G.device), state
    if name == "mean":
        # fixed 1/m, ignoring pref weights (torchjd Mean() in the reference)
        return torch.full((m,), 1.0 / m, dtype=torch.float32,
                          device=G.device), state
    if name == "upgrad":
        return _upgrad_alpha(G, cfg.pref(G.device), cfg.reg_eps), state
    if name == "dualproj":
        return _dualproj_alpha(G, cfg.pref(G.device), cfg.reg_eps), state
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"aggregator {cfg.name!r} is not ported to movae_tpu_torch yet: "
            f"ROADMAP.md Queue 1 item 5 (multi-objective engine)")
    raise ValueError(f"Aggregator {cfg.name} not supported")


def gradient_similarity(G: Tensor, alpha: Tensor) -> Tensor:
    """Cosine similarity between the aggregated and the mean gradient,
    computed Gramian-side."""
    m = G.shape[0]
    w0 = torch.full((m,), 1.0 / m, dtype=G.dtype, device=G.device)
    num = alpha @ G @ w0
    den = (torch.sqrt(torch.clamp(alpha @ G @ alpha, min=1e-20))
           * torch.sqrt(torch.clamp(w0 @ G @ w0, min=1e-20)))
    return num / den
