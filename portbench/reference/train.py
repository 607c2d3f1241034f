"""The first training steps, worked out by the reference from the
benchmark's weights and batches: each step's loss, the first gradient as
the optimizer takes it, and the parameters after the last step.

``half_batch`` plants a fault for the control runs: every step sees only
the first half of its batch and takes the mean over it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference import aggregate
from portbench.reference.adam import Adam
from portbench.reference.layers import set_precision
from portbench.reference.pixelsnail import PixelSNAIL
from portbench.reference.precision import Precision
from portbench.reference.vqvae2 import OBJECTIVES, VQVAE2, images_to_input


def _result(model, losses, grad1, **more) -> Dict:
    names = [n for n, _ in model.named_parameters()]
    return {**more, "losses": losses,
            "grad1": dict(zip(names, grad1)),
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


def _objectives(terms: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    return [terms[n] for n in OBJECTIVES]


def stage1_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                 batches: Sequence[torch.Tensor], aggregator: str,
                 prec: Precision, half_batch: bool = False) -> Dict:
    """``batches``: the steps' uint8 NHWC images, flips applied. Besides
    the losses, first gradient and parameters: ``codes1``, the first
    step's chosen codes (top, bottom), and under upgrad ``alpha1``, its
    weights."""
    dev = batches[0].device
    model = VQVAE2(cfg).to(dev, prec.dtype)
    model.load_state_dict(weights)
    set_precision(model, prec)
    params = [p for _, p in model.named_parameters()]
    trunk_ids = {id(p) for p in [*model.enc_b.parameters(),
                                 *model.enc_t.parameters()]}
    opt = Adam(params, lr=float(cfg["lr"]))
    losses: List[float] = []
    grad1, alpha1 = None, None
    codes1 = model.chosen = []
    with prec.region(dev.type):
        for imgs in batches:
            if half_batch:
                imgs = imgs[: len(imgs) // 2]
            x = images_to_input(imgs).to(prec.dtype)
            if aggregator == "sum":
                terms = model.heads(*model.trunk(x), x)
                parts = [terms[n] for n in OBJECTIVES]
                grads = aggregate.sum_grads(parts, params)
            elif aggregator == "upgrad":
                trunk_p = [p for p in params if id(p) in trunk_ids]
                head_p = [p for p in params if id(p) not in trunk_ids]
                got, alpha = aggregate.upgrad_grads(
                    lambda: model.trunk(x),
                    lambda et, eb: _objectives(model.heads(et, eb, x)),
                    trunk_p, head_p)
                by_id = dict(zip(map(id, trunk_p), got["trunk"]))
                by_id.update(zip(map(id, head_p), got["heads"]))
                grads = [by_id[id(p)] for p in params]
                parts = got["losses"]
                if alpha1 is None:
                    alpha1 = torch.as_tensor(alpha)
            else:
                raise ValueError(f"aggregator {aggregator!r}")
            losses.append(float(sum(float(t.detach()) for t in parts)))
            model.chosen = None  # the first step's codes only
            applied = opt.step(grads)
            if grad1 is None:
                grad1 = [g.detach().clone() for g in applied]
            del grads, applied
    more = {"codes1": codes1}
    if alpha1 is not None:
        more["alpha1"] = alpha1
    return _result(model, losses, grad1, **more)


def prior_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                batches: Sequence[torch.Tensor], dropout_seed: int,
                prec: Precision, half_batch: bool = False,
                chunk: int = 32) -> Dict:
    """``batches``: the steps' (B, H, W) integer codes. The batch runs
    ``chunk`` rows at a time, each chunk's cross-entropy summed over the
    whole batch's count, so the gradients are the whole batch's."""
    dev = batches[0].device
    model = PixelSNAIL(cfg).to(dev, prec.dtype)
    model.load_state_dict(weights)
    set_precision(model, prec)
    params = [p for _, p in model.named_parameters()]
    opt = Adam(params, lr=float(cfg["lr"]), eps=float(cfg["adam_eps"]),
               max_grad_norm=float(cfg["max_grad_norm"]))
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    losses: List[float] = []
    grad1 = None
    with prec.region(dev.type):
        for codes in batches:
            b, hh, ww = codes.shape
            masks = model.draw_masks(gen, b, hh * ww)
            if half_batch:
                b = b // 2
            grads = [torch.zeros_like(p) for p in params]
            total = 0.0
            for s in range(0, b, chunk):
                rows = slice(s, min(s + chunk, b))
                logits = model.logits(codes[rows], [m[rows] for m in masks])
                ce = torch.nn.functional.cross_entropy(
                    logits, codes[rows].long(), reduction="sum") / (
                        b * hh * ww)
                for acc, g in zip(grads, torch.autograd.grad(
                        ce, params, allow_unused=True)):
                    if g is not None:
                        acc.add_(g)
                total += float(ce.detach())
                del logits, ce
            del masks
            losses.append(total)
            applied = opt.step(grads)
            if grad1 is None:
                grad1 = [g.detach().clone() for g in applied]
            del grads, applied
    return _result(model, losses, grad1)
