"""Per-objective gradient engine — port of ``movae_tpu/moo/engine.py``.

Replaces torchjd's ``backward`` / ``mtl_backward``: one forward, then one
``torch.autograd.grad`` sweep per objective over the retained graph. Each
sweep walks only that objective's own graph, the counterpart of the JAX
package's per-objective traces.

  * full mode   — Jacobian w.r.t. every trainable parameter.
  * feature mode — Jacobian w.r.t. the shared-trunk feature tensors only;
    the aggregated cotangent is pulled back through the trunk once, while
    head parameters receive the unweighted sum of their per-objective
    gradients (torchjd ``mtl_backward`` semantics).

Jacobians are lists of tensors with a leading objective axis m. Gramians are
accumulated in float32.

Under an active data-parallel config (``parallel/mesh.py``) each rank holds
its rows of the global batch and the engine computes what the single
device computes on the whole batch: full mode all-reduces each objective's
gradient row (the mean over ranks) before the Gramian; feature mode's
Gramian is a sum of per-rank inner products over the batch-sharded seam,
all-reduced and scaled as the global mean's (1 / dp^2).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from movae_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


def _data_parallel() -> bool:
    return (mesh_lib.active_data_parallel() is not None
            and mesh_lib.process_count() > 1)


def all_reduce_mean(tensors: Sequence[Tensor]) -> List[Tensor]:
    """Each tensor's mean over the ranks, in one all-reduce of one flat
    buffer (identities on one rank)."""
    tensors = list(tensors)
    if mesh_lib.process_count() == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    mesh_lib.all_reduce_(flat, "mean")
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def gramian(J: Sequence[Tensor]) -> Tensor:
    """G[i,j] = <J_i, J_j> summed over every stacked Jacobian leaf."""
    m = J[0].shape[0]
    G = torch.zeros((m, m), dtype=torch.float32, device=J[0].device)
    for leaf in J:
        flat = leaf.reshape(m, -1).float()
        G = G + flat @ flat.T
    return G


def combine(J: Sequence[Tensor], alpha: Tensor) -> List[Tensor]:
    """g = alpha^T J per leaf (contraction over the leading objective axis)."""
    return [torch.tensordot(alpha.to(leaf.dtype), leaf, dims=1) for leaf in J]


def grads_or_zeros(loss: Tensor, inputs: Sequence[Tensor],
                   retain_graph: bool = False) -> List[Tensor]:
    """d loss / d inputs with exact zeros (not ``None``) for inputs the loss
    does not reach."""
    if not loss.requires_grad:
        return [torch.zeros_like(t) for t in inputs]
    gs = torch.autograd.grad(loss, list(inputs), retain_graph=retain_graph,
                             allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(gs, inputs)]


def full_jacobian(
    loss_tuple_fn: Callable[[], Tuple[Tuple[Tensor, ...], Any]],
    params: Sequence[Tensor],
    num_objectives: int,
) -> Tuple[Tensor, Any, List[Tensor], Tensor]:
    """torchjd ``backward`` equivalent.

    ``loss_tuple_fn() -> (loss_tuple, aux)`` runs the forward with autograd
    on; ``loss_tuple`` holds m scalar losses. Returns ``(loss_vec, aux, J,
    G)`` with J the full-parameter Jacobian (one (m, ...) tensor per
    parameter)."""
    lt, aux = loss_tuple_fn()
    rows = [grads_or_zeros(lt[i], params, retain_graph=i < num_objectives - 1)
            for i in range(num_objectives)]
    J = [torch.stack(leaf_rows) for leaf_rows in zip(*rows)]
    losses = torch.stack([l.detach() for l in lt])
    if _data_parallel():
        *J, losses = all_reduce_mean([*J, losses])
    return losses, aux, J, gramian(J)


class FeatureJacobian:
    """torchjd ``mtl_backward`` equivalent, staged so the aggregator weights
    can be computed between the feature Jacobian and the trunk pullback.

    ``trunk_fn() -> (features tuple, trunk_aux)`` runs the trunk with
    autograd on; ``heads_fn(features, trunk_aux) -> (loss_tuple,
    heads_aux)``. ``params`` are all trainable parameters: the trunk's get
    the pullback of the alpha-weighted feature cotangent, the heads' the
    plain sum of their per-objective gradients.
    """

    def __init__(self, trunk_fn, heads_fn, params: Sequence[Tensor],
                 num_objectives: int):
        features, trunk_aux = trunk_fn()
        self._features = tuple(features)
        # the heads see detached copies: their graph ends at the seam
        seam = tuple(f.detach().requires_grad_(True) for f in self._features)
        lt, heads_aux = heads_fn(seam, trunk_aux)
        self._params = list(params)
        nf = len(seam)
        f_rows = []
        direct: Optional[List[Tensor]] = None
        for i in range(num_objectives):
            gs = grads_or_zeros(lt[i], list(seam) + self._params,
                                retain_graph=i < num_objectives - 1)
            f_rows.append(gs[:nf])
            gp = gs[nf:]
            direct = gp if direct is None else [
                a + b for a, b in zip(direct, gp)]
        self.losses = torch.stack([l.detach() for l in lt])
        self.trunk_aux = trunk_aux
        self.heads_aux = heads_aux
        self._direct = direct
        self._J_feats = [torch.stack(r) for r in zip(*f_rows)]
        # Gramian from the feature Jacobian only, as in torchjd mtl_backward
        self.G = gramian(self._J_feats)
        if _data_parallel():
            # each rank's seam rows carry dp x the global mean's cotangent
            n = mesh_lib.process_count()
            self.G = mesh_lib.all_reduce_(self.G, "sum") / (n * n)
            self.losses = all_reduce_mean([self.losses])[0]

    def grads(self, alpha: Tensor) -> List[Tensor]:
        """Trunk grads from the aggregated feature cotangent plus the summed
        per-objective head grads. Frees the trunk graph."""
        feat_cot = combine(self._J_feats, alpha)
        shared = torch.autograd.grad(self._features, self._params,
                                     grad_outputs=feat_cot,
                                     allow_unused=True)
        return [d if s is None else s + d
                for s, d in zip(shared, self._direct)]
