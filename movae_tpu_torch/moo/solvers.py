"""Small solvers for multi-objective aggregation — port of
``movae_tpu/moo/solvers.py``.

All solvers work on the m x m Gramian ``G = J J^T`` (m = 2..5 objectives)
on G's own device. The support enumerations (the dual-cone projection's
2^m masked solves, CAGrad's 2^m - 1) run as one batched ``cholesky_ex``
with no host synchronisation: a masked system that is not positive definite
comes out infeasible, as the NaN of JAX's ``solve(assume_a="pos")`` does.
Frank–Wolfe's data-dependent stop is a masked loop (each iteration after
the stop leaves every value as it is); on a CPU tensor the loop ends there,
on a card tensor it runs all ``max_iters`` without a synchronisation.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

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


def regularize_gramian_eigen(G: Tensor, min_eigenvalue_eps: float) -> Tensor:
    """Clamp eigenvalues below ``min_eigenvalue_eps`` (StableMGDA)."""
    evals, V = torch.linalg.eigh(G)
    return (V * evals.clamp_min(min_eigenvalue_eps)[None, :]) @ V.T


# ---------------------------------------------------------------------------
# Frank–Wolfe min-norm point (MGDA, Sener & Koltun Alg. 2)
# ---------------------------------------------------------------------------

def frank_wolfe_minnorm(G: Tensor, epsilon: float = 1e-5,
                        max_iters: int = 250
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Min-norm point in the convex hull of the gradients, from the Gramian.

    Returns ``(alpha, iters, gamma)``. The stop is the JAX ``while_loop``'s:
    after the update whose step gamma falls below ``epsilon``, or after
    ``max_iters`` updates. Every iteration is masked by that condition, so
    the loop can run on any device without reading it; on a CPU tensor it
    ends as soon as the condition fails (the same numbers). The vertex is
    the lowest index of ``argmin(G alpha)``.
    """
    m = G.shape[0]
    alpha = torch.full((m,), 1.0 / m, dtype=G.dtype, device=G.device)
    iters = torch.zeros((), dtype=torch.int32, device=G.device)
    gamma = torch.full((), math.inf, dtype=G.dtype, device=G.device)
    tasks = torch.arange(m, device=G.device)
    host = G.device.type == "cpu"
    for _ in range(max_iters):
        live = gamma >= epsilon
        if host and not bool(live):
            break
        Ga = G @ alpha
        # the vertex as a one-hot built on the device (indexing with a
        # device scalar would read it on the host)
        e_t = (tasks == torch.argmin(Ga)).to(G.dtype)
        Gt = G @ e_t
        a, b, c = alpha @ Gt, alpha @ Ga, e_t @ Gt
        step = torch.where(c <= a, 1.0, torch.where(
            b <= a, 0.0, (b - a) / (b + c - 2.0 * a)))
        alpha = torch.where(live, (1.0 - step) * alpha + step * e_t, alpha)
        gamma = torch.where(live, step, gamma)
        iters = iters + live.to(torch.int32)
    return alpha, iters, gamma


# ---------------------------------------------------------------------------
# Exact dual-cone projection QP by active-set enumeration
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _all_masks(m: int, dtype: torch.dtype, device: torch.device) -> Tensor:
    """(2^m, m) binary matrix of all support sets, made once per device (a
    copy from the host each call would synchronise with the card)."""
    s = np.arange(2 ** m)[:, None]
    masks = ((s >> np.arange(m)[None, :]) & 1).astype(np.float32)
    return torch.from_numpy(masks).to(dtype=dtype, device=device)


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
    masks = _all_masks(m, G.dtype, G.device)
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


def cagrad_exact(G: Tensor, c: float) -> Tensor:
    """Exact CAGrad weights (Liu et al. 2021; torchjd CAGrad).

    Solves ``min_{w in simplex} F(w) = w^T G g0 + sqrt(phi) ||g_w||``,
    ``phi = c^2 g0^T G g0``, by enumerating the 2^m - 1 supports: on a
    support S the KKT conditions reduce to a scalar quadratic in the
    multiplier nu, ``nu^2 (1^T A^-1 1) - 2 nu (1^T A^-1 b_S) + b_S^T A^-1
    b_S = s^2``, and both roots of every support are ranked by the true
    objective F at their (feasibility-masked) w. Returns
    ``alpha = g0 + (sqrt(phi)/||g_w||) w`` (torchjd's convention, no
    1/(1+c^2) rescale). G is scaled to max|G| = 1 first, which leaves the
    argmin unchanged. A support whose masked system is not positive
    definite is infeasible.
    """
    m = G.shape[0]
    kappa = G.abs().max().clamp_min(1e-30)
    Gn = (G / kappa).float()
    g0 = torch.full((m,), 1.0 / m, dtype=Gn.dtype, device=Gn.device)
    b = Gn @ g0
    phi = (g0 @ b).clamp_min(1e-30)
    s = c * torch.sqrt(phi)
    masks = _all_masks(m, Gn.dtype, Gn.device)[1:]                 # (S, m)
    tol = 1e-6
    # a tiny on-support ridge keeps the solve finite where a task's Gramian
    # row is exactly zero (the embedding loss under the feature Jacobian),
    # whose singleton support is the optimum (F = 0 there)
    A = (Gn[None] * (masks[:, :, None] * masks[:, None, :])
         + torch.diag_embed(1.0 - masks) + 1e-12 * torch.diag_embed(masks))
    L, info = torch.linalg.cholesky_ex(A)
    bS = masks * b[None]
    x1 = torch.cholesky_solve(masks[..., None], L)[..., 0]          # (S, m)
    xb = torch.cholesky_solve(bS[..., None], L)[..., 0]
    A11 = (masks * x1).sum(-1)
    A1b = (masks * xb).sum(-1)
    Abb = (bS * xb).sum(-1)
    disc = A1b * A1b - A11 * (Abb - s * s)
    sq = torch.sqrt(disc.clamp_min(0.0))
    denom = torch.where(A11 > 0, A11, 1.0)
    nus = torch.stack([(A1b + sq) / denom, (A1b - sq) / denom])     # (2, S)
    # y_S = (1/s) G_SS^-1 (nu 1 - b_S), from x1 and xb
    y = masks * (nus[..., None] * x1 - xb) / s.clamp_min(1e-30)    # (2,S,m)
    sy = y.sum(-1)
    w = y / torch.where(sy.abs() > 1e-12, sy, 1.0)[..., None]
    gww = ((w @ Gn) * w).sum(-1).clamp_min(1e-30)
    F = w @ b + s * torch.sqrt(gww)
    bad = ((disc < -tol) | (A11 <= 0) | (info != 0))[None] | (sy <= 1e-12) \
        | (y < -tol).any(-1) | torch.isnan(w).any(-1)
    F = torch.where(bad, torch.inf, F)
    # root a wins a support unless root b is strictly better
    take_a = F[0] <= F[1]
    ws = torch.where(take_a[:, None], w[0], w[1])
    Fs = torch.where(take_a, F[0], F[1])
    best = torch.argmin(Fs).view(1)
    # numerical fallback (all-zero G etc.): w = g0
    w = torch.where(torch.isfinite(Fs.min()), ws.index_select(0, best)[0],
                    g0)
    gw_norm = torch.sqrt((w @ Gn @ w).clamp_min(0.0))
    # ||g_w|| ~ 0 (w on zero-gradient tasks): the update lam*g_w is 0
    # whatever lam is, so lam = 0 keeps the logged alpha finite
    lam = torch.where(gw_norm > 1e-9 * s, s / gw_norm.clamp_min(1e-30), 0.0)
    return g0 + lam * w


# ---------------------------------------------------------------------------
# Eigen balance transform (AlignedMTL)
# ---------------------------------------------------------------------------

def balance_transformation(G: Tensor, scale_mode: str = "min") -> Tensor:
    """B = sqrt(scale) * V Sigma^{-1/2} V^T over the significant rank of G.

    Eigenvalues above ``max * m * eps`` (float32 eps) are kept; the scale is
    the smallest kept eigenvalue ("min"), the lower median of the kept block
    ("median") or their mean ("rmse"). Returns the identity when no
    eigenvalue is kept.
    """
    if scale_mode not in ("min", "median", "rmse"):
        raise ValueError(f"Invalid scale_mode={scale_mode!r}")
    m = G.shape[0]
    evals, V = torch.linalg.eigh(G)  # ascending
    keep = evals > evals.max() * m * torch.finfo(G.dtype).eps
    rank = keep.sum()
    inv_sqrt = torch.where(
        keep, 1.0 / torch.sqrt(torch.where(keep, evals, 1.0)), 0.0)
    if scale_mode == "min":
        scale = torch.where(keep, evals, torch.inf).min()
    elif scale_mode == "median":
        # the kept eigenvalues are the top `rank` of the ascending ones
        idx = (m - rank + torch.div(rank - 1, 2, rounding_mode="floor")
               ).clamp(0, m - 1)
        scale = evals.index_select(0, idx.view(1))[0]
    else:
        scale = torch.where(keep, evals, 0.0).sum() / rank.clamp_min(1)
    B = torch.sqrt(scale) * (V * inv_sqrt[None, :]) @ V.T
    return torch.where(rank > 0, B, torch.eye(m, dtype=G.dtype,
                                              device=G.device))
