"""Gramian-level multi-objective aggregators — port of
``movae_tpu/moo/aggregators.py``: every name of its ``AGGREGATOR_NAMES``.

Each aggregator maps the per-objective Gramian ``G = J J^T`` (plus, for
some, the losses, random draws or carried state) to a weight vector
``alpha``; the update direction is ``alpha^T J``.

Where each solve runs:

  * on G's device, with no host synchronisation: the UPGrad family and
    DualProj (batched ``cholesky_ex``), PCGrad, CAGrad (batched
    ``cholesky_ex``), IMTL-G and NashMTL (``solve_ex``);
  * on the host: the MGDA family (Frank–Wolfe stops on a data-dependent
    step size) and the Aligned-MTL family and StableMGDA (an m x m
    ``eigh``). G and the losses are copied to the CPU once, the m <= 5
    problem is solved there in float32 and alpha is copied back
    (:func:`_on_host`). On one H100 80GB HBM3 at 700 W this won the A/B
    of ``chip_smoke.py`` phase 12 (PERF.md): mgda_ln's stage-1 step took
    18.4-24.0 ms with the solve on the host, 87.2-154.9 ms with the
    masked loop on the card (all 250 iterations, ~12 launches each) and
    28.3-33.3 ms as one CUDA graph; aligned_mtl's ``eigh`` took
    0.22-0.46 ms on the host and 0.43-0.79 ms on the card.

Randomness: PNUPGrad's Bernoulli draw and PCGrad's m task orders come from
the ``generator`` argument of :func:`compute_weights`, or are given as
tensors (``use_pairwise``, ``perms``), the way the samplers take ``gumbel``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from movae_tpu_torch.moo import solvers

Tensor = torch.Tensor

AGGREGATOR_NAMES = (
    "sum", "jd_sum", "mean", "upgrad", "nupgrad", "pnupgrad", "dualproj",
    "pcgrad", "mgda", "mgda_ln", "mgda_gn", "mgda_lgn", "aligned_mtl",
    "aligned_mtl_min", "amtl", "amtl_min", "aligned_mtl_median",
    "aligned_mtl_rmse", "cagrad", "imtlg", "nashmtl", "comfort",
)

# the Aligned-MTL names and their balance-transform scale
_ALIGNED_MTL = {"aligned_mtl": "min", "aligned_mtl_min": "min",
                "amtl": "min", "amtl_min": "min",
                "aligned_mtl_median": "median", "aligned_mtl_rmse": "rmse"}
# the MGDA names and their Gramian normalization (None: cfg.mgda_norm_type)
_MGDA = {"mgda": None, "mgda_ln": "l2", "mgda_gn": "loss",
         "mgda_lgn": "loss+"}


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Static aggregator configuration (the JAX package's fields and
    defaults)."""

    name: str = "sum"
    num_objectives: int = 2
    norm_eps: float = 1e-4
    reg_eps: float = 1e-4
    # MGDA
    mgda_norm_type: str = "none"  # none | l2 | loss | loss+
    mgda_epsilon: float = 1e-5
    mgda_max_iters: int = 250
    mgda_stable: bool = False
    mgda_min_eigenvalue_eps: float = 1e-10
    # AlignedMTL
    scale_mode: str = "min"
    pref_vector: Optional[Tuple[float, ...]] = None
    # CAGrad (``cagrad_iters`` is kept for the JAX config's sake; the exact
    # solve does not iterate)
    cagrad_c: float = 1.0
    cagrad_iters: int = 60
    # NashMTL
    nashmtl_update_every: int = 1
    nashmtl_optim_niter: int = 20
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
    """Per-aggregator carried state: NashMTL's last weights and its step
    count (a CPU counter, so the refresh decision reads no device value)."""
    if cfg.name == "nashmtl":
        return {"nash_alpha": torch.ones(cfg.num_objectives),
                "nash_step": torch.zeros((), dtype=torch.int32)}
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


def _on_host(fn: Callable[..., Tensor], G: Tensor, *rest: Tensor) -> Tensor:
    """``fn(G, *rest)`` on CPU copies, made by one device-to-host copy (one
    synchronisation on a card), with the result copied back to G's device
    from pinned memory without a second one."""
    if G.device.type == "cpu":
        return fn(G, *rest)
    m = G.shape[0]
    host = torch.cat([G, *(r.to(G.dtype).reshape(1, m) for r in rest)]
                     ).cpu()
    return fn(host[:m], *host[m:]).pin_memory().to(G.device,
                                                    non_blocking=True)


# ---------------------------------------------------------------------------
# Individual weightings (G -> alpha)
# ---------------------------------------------------------------------------

def _project_sum(G: Tensor, w: Tensor) -> Tensor:
    """Project each weighted row diag(w) onto the dual cone of a
    (regularized) Gramian; sum the rows."""
    return solvers.project_weight_rows(torch.diag(w), G).sum(0)


def _upgrad_alpha(G: Tensor, w: Tensor, reg_eps: float) -> Tensor:
    """UPGrad: project each weighted row onto the dual cone; sum."""
    return _project_sum(solvers.regularize_gramian_diag(G, reg_eps), w)


def _nupgrad_alpha(G: Tensor, w: Tensor, norm_eps: float,
                   reg_eps: float) -> Tensor:
    """NUPGrad: the min-L2-normalized Gramian, then UPGrad's projection."""
    return _project_sum(solvers.regularize_gramian_diag(
        solvers.normalize_gramian_min_l2(G, norm_eps), reg_eps), w)


def _pnupgrad_alpha(G: Tensor, w: Tensor, use_pairwise: Tensor,
                    norm_eps: float, reg_eps: float) -> Tensor:
    """PNUPGrad: the pairwise-L2-normalized Gramian where ``use_pairwise``
    (a 0-dim bool, drawn with probability 0.5), else the min-norm one."""
    Gn = torch.where(use_pairwise, solvers.normalize_gramian_l2(G, norm_eps),
                     solvers.normalize_gramian_min_l2(G, norm_eps))
    return _project_sum(solvers.regularize_gramian_diag(Gn, reg_eps), w)


def _dualproj_alpha(G: Tensor, w: Tensor, reg_eps: float) -> Tensor:
    """DualProj: project the preference-weighted gradient onto the dual
    cone."""
    Gr = solvers.regularize_gramian_diag(G, reg_eps)
    return solvers.dual_cone_project_weights(w, Gr)


def _mgda_alpha(G: Tensor, losses: Tensor, cfg: AggregatorConfig,
                norm_type: str) -> Tensor:
    """MGDA: the (normalized, optionally eigen-regularized) Gramian's
    Frank–Wolfe min-norm point."""
    if norm_type == "l2":
        G = solvers.normalize_gramian_l2(G)
    elif norm_type == "loss":
        G = solvers.normalize_gramian_loss(G, losses)
    elif norm_type == "loss+":
        G = solvers.normalize_gramian_loss_plus(G, losses)
    if cfg.mgda_stable:
        G = solvers.regularize_gramian_eigen(G, cfg.mgda_min_eigenvalue_eps)
    alpha, _, _ = solvers.frank_wolfe_minnorm(G, cfg.mgda_epsilon,
                                              cfg.mgda_max_iters)
    return alpha


def _aligned_mtl_alpha(G: Tensor, w: Tensor, scale_mode: str) -> Tensor:
    return solvers.balance_transformation(G, scale_mode) @ w


def _pcgrad_alpha(G: Tensor, perms: Tensor) -> Tensor:
    """PCGrad in weight space: task i's weights start at e_i and, for each j
    in ``perms[i]`` (a permutation of the tasks) but i itself, lose their
    conflicting projection on g_j. The m tasks run side by side."""
    m = G.shape[0]
    diag = torch.diagonal(G).clamp_min(1e-20)
    W = torch.eye(m, dtype=G.dtype, device=G.device)
    rows = torch.arange(m, device=G.device)
    perms = perms.to(G.device).long()
    for k in range(m):
        j = perms[:, k]
        d = (W @ G)[rows, j]                   # g_i' . g_j, per task
        coef = torch.where((j == rows) | (d >= 0), 0.0, d / diag[j])
        W = W - coef[:, None] * torch.eye(m, dtype=G.dtype,
                                          device=G.device)[j]
    return W.sum(0)


def _imtlg_alpha(G: Tensor) -> Tensor:
    """IMTL-G: the weights whose combined gradient has equal projections on
    every task's unit direction, in closed form from the Gramian."""
    m = G.shape[0]
    norms = torch.sqrt(torch.diagonal(G).clamp_min(1e-20))
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    e1 = eye[0]
    D = e1[None, :] - eye[1:]                                  # (m-1, m)
    Uw = (e1 / norms[0])[None, :] - eye[1:] / norms[1:, None]  # (m-1, m)
    g1U = (e1 @ G) @ Uw.T
    A = ((D @ G) @ Uw.T).T + 1e-12 * torch.eye(m - 1, dtype=G.dtype,
                                               device=G.device)
    rest = torch.linalg.solve_ex(A, g1U)[0]
    # one step of iterative refinement: float32 solves of ill-conditioned
    # small systems otherwise leave ~1% residual in the equal projections
    rest = rest + torch.linalg.solve_ex(A, g1U - A @ rest)[0]
    return torch.cat([(1.0 - rest.sum())[None], rest])


def _nashmtl_solve(G: Tensor, niter: int) -> Tensor:
    """NashMTL: ``alpha > 0`` with ``(G alpha)_i = 1 / alpha_i`` by a damped
    Newton iteration on ``min 0.5 a^T G a - sum_i log a_i`` (Hessian
    ``G + diag(1/a^2)``, positive definite even for singular G), a
    fraction-to-boundary step cap keeping ``a`` positive. G is scaled to
    max|G| = 1 with a 1e-8 ridge (a zero Gramian row would otherwise send
    its weight to infinity), starting from the decoupled solution
    ``1/sqrt(G_ii)``."""
    m = G.shape[0]
    s = G.abs().max().clamp_min(1e-12)
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    Gn = G / s + 1e-8 * eye
    a = 1.0 / torch.sqrt(torch.diagonal(Gn).clamp_min(1e-12))
    for _ in range(niter):
        grad = Gn @ a - 1.0 / a
        step = torch.linalg.solve_ex(Gn + torch.diag(1.0 / (a * a)),
                                     grad)[0]
        ratio = torch.where(step > 0, step / a, 0.0)
        t = torch.clamp(0.99 / ratio.max().clamp_min(1e-12), max=1.0)
        a = (a - t * step).clamp_min(1e-8)
    return a / torch.sqrt(s)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def compute_weights(
    cfg: AggregatorConfig,
    G: Tensor,
    losses: Tensor,
    state: Dict[str, Tensor],
    beta: Optional[Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    use_pairwise: Optional[Tensor] = None,
    perms: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Map the (m, m) Gramian to alpha. Returns (alpha, new_state).

    ``losses`` are the weighted component losses (the MGDA loss
    normalizations read them); ``beta`` is COMFORT's schedule value for the
    step. ``generator`` (on G's device) draws PNUPGrad's Bernoulli and
    PCGrad's task orders unless they are given: ``use_pairwise`` (0-dim
    bool) and ``perms`` ((m, m) ints, row i the order of task i's
    projections).
    """
    name = cfg.name.lower()
    m = cfg.num_objectives
    G = G.float()
    dev = G.device
    if name in ("sum", "jd_sum"):
        return torch.ones(m, dtype=torch.float32, device=dev), state
    if name == "mean":
        # fixed 1/m, ignoring pref weights (torchjd Mean() in the reference)
        return torch.full((m,), 1.0 / m, dtype=torch.float32,
                          device=dev), state
    w = cfg.pref(dev)
    if name == "upgrad":
        return _upgrad_alpha(G, w, cfg.reg_eps), state
    if name == "nupgrad":
        return _nupgrad_alpha(G, w, cfg.norm_eps, cfg.reg_eps), state
    if name == "pnupgrad":
        if use_pairwise is None:
            use_pairwise = torch.rand((), generator=generator,
                                      device=dev) < 0.5
        return _pnupgrad_alpha(G, w, torch.as_tensor(use_pairwise,
                                                     device=dev),
                               cfg.norm_eps, cfg.reg_eps), state
    if name == "dualproj":
        return _dualproj_alpha(G, w, cfg.reg_eps), state
    if name == "pcgrad":
        if perms is None:
            perms = torch.rand((m, m), generator=generator,
                               device=dev).argsort(-1)
        return _pcgrad_alpha(G, perms), state
    if name in _MGDA:
        norm = _MGDA[name] or cfg.mgda_norm_type
        return _on_host(lambda g, l: _mgda_alpha(g, l, cfg, norm), G,
                        losses), state
    if name in _ALIGNED_MTL:
        return _on_host(lambda g, p: _aligned_mtl_alpha(
            g, p, _ALIGNED_MTL[name]), G, w), state
    if name == "cagrad":
        return solvers.cagrad_exact(G, cfg.cagrad_c), state
    if name == "imtlg":
        return _imtlg_alpha(G), state
    if name == "nashmtl":
        step = int(state["nash_step"])
        if step % max(cfg.nashmtl_update_every, 1) == 0:
            alpha = _nashmtl_solve(G, cfg.nashmtl_optim_niter)
        else:
            alpha = state["nash_alpha"].to(dev)
        return alpha, {"nash_alpha": alpha,
                       "nash_step": torch.tensor(step + 1,
                                                 dtype=torch.int32)}
    if name == "comfort":
        if beta is None:
            beta = torch.tensor(cfg.comfort_beta_u, dtype=torch.float32)
        a_mgda = _on_host(lambda g, l: _mgda_alpha(
            g, l, cfg, cfg.mgda_norm_type), G, losses)
        a_up = _upgrad_alpha(G, w, cfg.reg_eps)
        # a 0-dim CPU beta scales card tensors as a scalar, with no copy
        beta = torch.as_tensor(beta, dtype=torch.float32)
        return (1.0 - beta) * a_mgda + beta * a_up, state
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
