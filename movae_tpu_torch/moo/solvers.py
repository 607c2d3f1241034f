"""Small solvers for multi-objective aggregation — port of the parts of
``movae_tpu/moo/solvers.py`` that ``sum``/``mean``/``upgrad``/``dualproj``
need.

All solvers work on the m x m Gramian ``G = J J^T`` (m = 2..5 objectives)
and stay on G's device: the 2^m masked solves of the dual-cone projection
run as one batched Cholesky, with no host synchronisation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Gramian normalizations / regularizations
# ---------------------------------------------------------------------------

def normalize_gramian_l2(G: Tensor, eps: float = 1e-20) -> Tensor:
    """G[i,j] / (||g_i||*||g_j||) — as if each gradient were unit-norm."""
    norms = torch.sqrt(torch.clamp(torch.diagonal(G), min=eps))
    return G / (norms[:, None] * norms[None, :])


def normalize_gramian_loss(G: Tensor, losses: Tensor,
                           eps: float = 1e-20) -> Tensor:
    """G[i,j] / (loss_i * loss_j)."""
    l = torch.clamp(losses.to(G.dtype), min=eps)
    return G / (l[:, None] * l[None, :])


def normalize_gramian_loss_plus(G: Tensor, losses: Tensor,
                                eps: float = 1e-20) -> Tensor:
    """G[i,j] / (loss_i*||g_i|| * loss_j*||g_j||)."""
    l = torch.clamp(losses.to(G.dtype), min=eps)
    c = l * torch.sqrt(torch.clamp(torch.diagonal(G), min=eps))
    return G / (c[:, None] * c[None, :])


def normalize_gramian_min_l2(G: Tensor, eps: float) -> Tensor:
    """Scale every gradient down to the minimum L2 norm: G <- D G D with
    D = diag(a_min / a_k)."""
    norms = torch.sqrt(torch.clamp(torch.diagonal(G), min=eps))
    nonzero = norms > eps
    min_norm = torch.where(nonzero, norms, torch.inf).min()
    scale = torch.where(nonzero, min_norm / norms, 0.0)
    out = G * (scale[:, None] * scale[None, :])
    return torch.where(nonzero.any(), out, torch.zeros_like(G))


def regularize_gramian_diag(G: Tensor, eps: float) -> Tensor:
    """Add eps to the diagonal for strict positive definiteness."""
    return G + eps * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)


# ---------------------------------------------------------------------------
# Exact dual-cone projection QP by active-set enumeration
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _all_masks(m: int) -> np.ndarray:
    """(2^m, m) binary matrix of all support sets."""
    s = np.arange(2 ** m)[:, None]
    return ((s >> np.arange(m)[None, :]) & 1).astype(np.float32)


def project_weight_rows(U: Tensor, G: Tensor) -> Tensor:
    """Project each row u of U (R, m) onto the dual cone of the gradient
    rows: the exact solution ``w = u + mu`` of
    ``min_{mu >= 0} (u+mu)^T G (u+mu)``, one row per objective (torchjd
    ``project_weights``).

    KKT: on a support S (mu_S > 0), ``G_SS mu_S = -(G u)_S``; a candidate is
    feasible when mu_S >= 0 and the reduced gradient off the support
    ``(G(u+mu))_{S^c} >= 0``. All 2^m masked systems are solved at once;
    the feasible candidate with the lowest objective wins. A masked system
    that is not positive definite (``cholesky_ex`` reports ``info != 0``) is
    infeasible, as the NaN of JAX's ``solve(assume_a="pos")`` is in the
    reference.
    """
    m = G.shape[0]
    masks = torch.as_tensor(_all_masks(m), dtype=G.dtype, device=G.device)
    S = masks.shape[0]
    R = U.shape[0]
    A = (G[None] * (masks[:, :, None] * masks[:, None, :])
         + torch.diag_embed(1.0 - masks))                        # (S, m, m)
    L, info = torch.linalg.cholesky_ex(A)
    Gu = U @ G                                  # (R, m); G is symmetric
    b = -masks[None] * Gu[:, None, :]                            # (R, S, m)
    mu = torch.cholesky_solve(b.reshape(R * S, m, 1),
                              L.repeat(R, 1, 1)).reshape(R, S, m)
    mu = mu * masks[None]
    w = U[:, None, :] + mu                                       # (R, S, m)
    Gw = w @ G
    # feasibility tolerances follow each constraint's scale: mu lives in
    # weight space (O(1)), the reduced gradient in squared-gradient space
    # (O(trace G)); one trace-scaled tolerance would accept w = 0 on
    # large-norm Gramians
    tol_mu = 1e-6 * (1.0 + U.abs().sum(1, keepdim=True))         # (R, 1)
    tol_g = 1e-6 * (torch.trace(G) + 1.0)
    viol_mu = torch.clamp(-mu, min=0.0).sum(-1)
    viol_g = ((1.0 - masks)[None] * torch.clamp(-Gw, min=0.0)).sum(-1)
    obj = (w * Gw).sum(-1)
    bad = ((info != 0)[None] | torch.isnan(mu).any(-1)
           | (viol_mu > tol_mu) | (viol_g > tol_g))
    scores = torch.where(bad, torch.inf, obj)                    # (R, S)
    best = scores.argmin(1)
    w_best = torch.gather(w, 1, best[:, None, None].expand(R, 1, m))[:, 0]
    best_score = torch.gather(scores, 1, best[:, None])
    # numerical fallback: if every candidate failed, keep u (no projection)
    return torch.where(torch.isfinite(best_score), w_best, U)


def dual_cone_project_weights(u: Tensor, G: Tensor) -> Tensor:
    """Exact solution of ``min_{mu >= 0} (u+mu)^T G (u+mu)``; returns
    ``w = u + mu`` (see :func:`project_weight_rows`)."""
    return project_weight_rows(u[None], G)[0]
