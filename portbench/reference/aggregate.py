"""Multi-objective aggregation as MO-VAE runs it through torchjd.

``sum``: one backward of the summed objectives. ``upgrad`` (Quinton and
Rey, arXiv:2406.16232) with torchjd's ``mtl_backward`` semantics: the
Jacobian of the objectives with respect to the trunk's output features
gives the Gramian G (regularized by 1e-4 on its diagonal); each row of
diag(w), with w the uniform preference 1/m, is projected onto the dual
cone of G, ``min_{mu >= 0} (u + mu)^T G (u + mu)``, solved here as a
non-negative least-squares problem on G's Cholesky factor in float64; the
weights alpha are the projected rows' sum. The trunk receives the pullback
of alpha^T J through the features; every head parameter receives the
plain sum of its per-objective gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import nnls

REG_EPS = 1e-4


def upgrad_weights(G: np.ndarray, reg_eps: float = REG_EPS) -> np.ndarray:
    """alpha from an (m, m) Gramian (float64)."""
    m = G.shape[0]
    A = G + reg_eps * np.eye(m)
    L = np.linalg.cholesky(A)
    alpha = np.zeros(m)
    for i in range(m):
        u = np.zeros(m)
        u[i] = 1.0 / m
        # (u + mu)^T A (u + mu) = || L^T mu + L^T u ||^2
        mu, _ = nnls(L.T, -L.T @ u)
        alpha += u + mu
    return alpha


def sum_grads(losses: Sequence[torch.Tensor], params: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    total = torch.stack(list(losses)).sum()
    return _grads(total, params, retain=False)


def upgrad_grads(trunk: Callable[[], Tuple[torch.Tensor, ...]],
                 heads: Callable[..., Sequence[torch.Tensor]],
                 trunk_params: List[torch.Tensor],
                 head_params: List[torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """Returns ({"trunk": [...], "heads": [...]}, alpha). ``trunk()`` gives
    the feature tensors; ``heads(*features)`` the m objectives."""
    feats = trunk()
    seam = [f.detach().requires_grad_(True) for f in feats]
    losses = heads(*seam)
    m = len(losses)
    f_rows, head_sum = [], None
    for i, loss in enumerate(losses):
        g = _grads(loss, seam + head_params, retain=i < m - 1)
        f_rows.append([t.double() for t in g[:len(seam)]])
        hg = g[len(seam):]
        head_sum = hg if head_sum is None else [a + b for a, b in
                                                zip(head_sum, hg)]
    G = np.zeros((m, m))
    for i in range(m):
        for j in range(i, m):
            G[i, j] = G[j, i] = float(sum((a * b).sum() for a, b in
                                          zip(f_rows[i], f_rows[j])))
    alpha = upgrad_weights(G)
    cot = [sum(float(alpha[i]) * f_rows[i][k] for i in range(m)).to(
        seam[k].dtype) for k in range(len(seam))]
    trunk_g = torch.autograd.grad(feats, trunk_params, grad_outputs=cot,
                                  allow_unused=True)
    trunk_g = [torch.zeros_like(p) if g is None else g
               for g, p in zip(trunk_g, trunk_params)]
    return {"trunk": trunk_g, "heads": head_sum,
            "losses": [l.detach() for l in losses]}, alpha


def _grads(loss: torch.Tensor, inputs: List[torch.Tensor], retain: bool
           ) -> List[torch.Tensor]:
    gs = torch.autograd.grad(loss, inputs, retain_graph=retain,
                             allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(gs, inputs)]
