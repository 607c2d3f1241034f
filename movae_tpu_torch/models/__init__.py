"""Model registry — port of ``movae_tpu/models/__init__.py`` for ``vq_vae``,
``vq_vae2``, ``gg_vq_vae`` / ``gg_vq_vae_v1..v8`` and ``gg_vq_vae2``.

The priors (flat and hierarchical) are not in this registry:
``movae_tpu_torch/train/prior.py:build_prior`` builds them, as in the JAX
package.

Other architectures raise ``NotImplementedError`` naming the ``ROADMAP.md``
item that ports them.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.models.base import MOVAEModel, resolve_lambda_weights
from movae_tpu_torch.models.gg_vq_vae import GGVQVAE
from movae_tpu_torch.models.gg_vq_vae2 import GGVQVAE2
from movae_tpu_torch.models.vq_vae import VQVAE
from movae_tpu_torch.models.vq_vae2 import VQVAE2

__all__ = ["GGVQVAE", "GGVQVAE2", "VQVAE", "VQVAE2", "MOVAEModel",
           "get_network", "init_model"]

_NOT_PORTED = {
    "pixelcnn": "Queue 1 item 8 (the flat priors are built by "
                "movae_tpu_torch/train/prior.py:build_prior)",
    "pixelsnail": "Queue 1 item 8 (the flat priors are built by "
                  "movae_tpu_torch/train/prior.py:build_prior)",
}


def _get(args, name, default=None):
    if args is None:
        return default
    if isinstance(args, Mapping):
        return args.get(name, default)
    return getattr(args, name, default)


def _weights(lambda_weights, names, defaults):
    """Normalize user weights (dict or positional list, validated strictly)."""
    if lambda_weights is None or isinstance(lambda_weights, Mapping):
        return resolve_lambda_weights(names, lambda_weights, defaults)
    lw = list(lambda_weights)
    if len(lw) != len(names):
        raise ValueError(
            f"requires {len(names)} lambda_weights {tuple(names)}, "
            f"got {len(lw)}")
    return resolve_lambda_weights(names, dict(zip(names, lw)), defaults)


def get_network(input_size: int, num_channels: int = 3, args: Any = None
                ) -> MOVAEModel:
    """Build a model from an args namespace/dict. The module's weights are
    not initialized yet: call :func:`init_model`."""
    arch = (_get(args, "arch", "vae") or "vae").lower()
    if arch not in ("vq_vae", "vq_vae2") and not arch.startswith("gg_vq_vae"):
        item = _NOT_PORTED.get(arch, "Queue 1 item 11 (rest of the model zoo)")
        raise NotImplementedError(
            f"arch {arch!r} is not ported to movae_tpu_torch yet: "
            f"ROADMAP.md {item}")
    dtype = _get(args, "compute_dtype", "float32")
    if dtype not in ("float32", torch.float32):
        raise NotImplementedError(
            f"compute_dtype {dtype!r}: the port computes in float32 only; "
            f"bf16 compute is ROADMAP.md Queue 1 item 6 (deferred)")
    recons_objective = (_get(args, "recons_objective", None)
                        or _get(args, "recons_obj", None))
    if recons_objective is None:
        recons_objective = {"bernoulli": "bce", "gaussian": "mse",
                            "laplacian": "l1"}.get(
            _get(args, "recons_dist", "gaussian"), "mse")
    recons_objective = recons_objective.lower()
    perceptual_fn = None
    if recons_objective == "perceptual":
        # the VGG16 conv3_3 feature MSE, the tower frozen and kept out of
        # the model's parameters (MOVAE_VGG16_WEIGHTS or the random init)
        from movae_tpu_torch.metrics.vgg import make_perceptual_fn
        perceptual_fn = make_perceptual_fn()
    recons_activation = _get(args, "recons_activation", None)
    if recons_activation is None:
        recons_activation = "sigmoid" if recons_objective == "bce" else "tanh"
    lambda_weights = (_get(args, "loss_weights", None)
                      or _get(args, "lambda_weights", None))
    vq_ema = bool(_get(args, "vq_ema", False))
    # EMA maintains the codebooks; the gradient-free embedding loss leaves
    # the objective vector
    emb = () if vq_ema else ("embedding_loss",)

    kw = {}
    if arch == "vq_vae":
        cls = VQVAE
        names = ("reconstruction_loss", *emb, "commitment_loss")
        defaults = {"reconstruction_loss": 1.0, "commitment_loss": 0.25,
                    "embedding_loss": 1.0}
    elif arch == "vq_vae2":
        # vq_vae2 keeps the embedding loss last, and the registry's defaults
        # (commitment 1.0, embedding 0.25) win over the class's all-ones
        cls = VQVAE2
        names = ("reconstruction_loss", "commitment_loss", *emb)
        defaults = {"reconstruction_loss": 1.0, "commitment_loss": 1.0,
                    "embedding_loss": 0.25}
    elif arch.startswith("gg_vq_vae2"):
        cls = GGVQVAE2
        names = ("reconstruction_loss", "commitment_loss", *emb,
                 "gradient_guided_loss", "edge_matching_loss")
        defaults = {"reconstruction_loss": 1.0, "commitment_loss": 1.0,
                    "gradient_guided_loss": 1.0, "edge_matching_loss": 1.0,
                    "embedding_loss": 0.25}
    else:
        # the reference's objective-dict order: recon, embedding,
        # commitment, gradient-guided[, edge matching from v2 on]
        cls = GGVQVAE
        version = ("v1" if arch in ("gg_vq_vae", "gg_vq_vae_v1")
                   else arch.replace("gg_vq_vae_", ""))
        kw["version"] = version
        names = ("reconstruction_loss", *emb, "commitment_loss",
                 "gradient_guided_loss")
        defaults = {"reconstruction_loss": 1.0, "gradient_guided_loss": 1.0,
                    "commitment_loss": 0.25, "embedding_loss": 1.0}
        if version != "v1":
            names = names + ("edge_matching_loss",)
            defaults["edge_matching_loss"] = 1.0
    return cls(
        in_channels=num_channels,
        embedding_dim=_get(args, "embedding_dim", 64) or 64,
        num_embeddings=_get(args, "num_embeddings", 512) or 512,
        hidden_dims=tuple(_get(args, "hidden_dims", (32, 64, 128, 256, 512))),
        num_residual_layers=_get(args, "num_residual_layers", 2),
        input_size=input_size, recons_activation=recons_activation,
        recons_objective=recons_objective, perceptual_fn=perceptual_fn,
        lambda_weights=_weights(lambda_weights, names, defaults),
        vq_ema=vq_ema, vq_ema_decay=float(_get(args, "vq_ema_decay", 0.99)),
        **kw)


def init_model(model: MOVAEModel, seed: int = 0,
               device: DeviceLike = None) -> MOVAEModel:
    """Initialize the weights from ``seed`` (on the CPU, so a seed gives the
    same weights on every device) and move the model to ``device``
    (default ``cuda``; raises if no card is present). Returns the model."""
    dev = resolve_device(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)

