"""Checkpoints — port of ``movae_tpu/train/checkpoint.py`` in the
reference's own format.

``torch.save`` payloads with the reference's keys at the reference's
paths: ``<save_root>/checkpoints/final_checkpoint.pth`` holds ``{epoch,
model_state_dict, args, train_losses, eval_losses, best_eval_loss}``, and
``<save_root>/<pixelcnn|pixelsnail>_prior/checkpoints/{best,final}_prior.pth``
hold ``{epoch, model_state_dict, loss}``. ``model_state_dict`` has exactly
the reference's keys (the layout of ``utils/weights.py``), so the JAX
package reads these files unchanged (``movae_tpu/train/checkpoint.py:
load_checkpoint`` and ``movae_tpu/train/prior.py:find_prior``). Keys the
reference lacks ride beside it: the EMA codebook statistics under
``ema_state``, and in the resumable ``last_checkpoint.pth`` /
``last_prior.pth`` the optimizer, aggregator and generator states.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import torch

# state_dict entries of the port's modules that the reference's layout
# lacks: the EMA codebook's running statistics
EMA_SUFFIXES = (".cluster_size", ".ema_embed")
_PLAIN = (int, float, str, bool, list, dict, type(None), tuple)


def split_state_dict(module: torch.nn.Module
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """``(reference, extra)``: the module's state on the CPU, split into the
    reference's keys and the EMA statistics."""
    ref, extra = {}, {}
    for k, v in module.state_dict().items():
        (extra if k.endswith(EMA_SUFFIXES) else ref)[k] = (
            v.detach().cpu().clone())
    return ref, extra


def load_module_state(module: torch.nn.Module,
                      payload: Mapping[str, Any]) -> None:
    """Load ``model_state_dict`` plus any ``ema_state`` strictly."""
    state = dict(payload["model_state_dict"])
    state.update(payload.get("ema_state") or {})
    module.load_state_dict(state, strict=True)


def args_echo(args) -> Dict[str, Any]:
    """The plain-typed entries of an args namespace (the payload's
    ``args``)."""
    items = vars(args).items() if hasattr(args, "__dict__") else args.items()
    return {k: v for k, v in items if isinstance(v, _PLAIN)}


def save_checkpoint(path: str, payload: Mapping[str, Any]) -> str:
    """Write ``payload`` to ``path`` through a temporary file and
    ``os.replace``, so a reader never sees a torn file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(dict(payload), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a payload written by :func:`save_checkpoint` or by the
    reference (its files may hold numpy scalars, hence the full
    unpickler: load only files that these programs wrote)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def final_checkpoint_path(save_root: str) -> str:
    return os.path.join(save_root, "checkpoints", "final_checkpoint.pth")


def last_checkpoint_path(save_root: str) -> str:
    return os.path.join(save_root, "checkpoints", "last_checkpoint.pth")


def prior_dir(save_root: str, prior_type: str) -> str:
    """``<save_root>/<pixelcnn|pixelsnail>_prior/checkpoints``; the
    hierarchical priors use their base type's folder."""
    name = ("pixelsnail_prior" if "pixelsnail" in (prior_type or "").lower()
            else "pixelcnn_prior")
    return os.path.join(save_root, name, "checkpoints")


def best_prior_path(save_root: str, prior_type: str = "pixelcnn") -> str:
    return os.path.join(prior_dir(save_root, prior_type), "best_prior.pth")


def final_prior_path(save_root: str, prior_type: str = "pixelcnn") -> str:
    return os.path.join(prior_dir(save_root, prior_type), "final_prior.pth")


def last_prior_path(save_root: str, prior_type: str = "pixelcnn") -> str:
    return os.path.join(prior_dir(save_root, prior_type), "last_prior.pth")
