"""Model registry — port of ``movae_tpu/models/__init__.py``: the VAE
family (``vae``, ``gg_vae`` / ``gg_vae_v2``, ``_v3``, ``_v5``, ``_v6``,
``betatc_vae`` / ``btc_vae``, ``cycle_vae``, ``recursive_kl_vae``,
``recursive_cyclic_vae`` / ``rc_vae``) and the VQ family (``vq_vae``,
``vq_vae2``, ``gg_vq_vae`` / ``gg_vq_vae_v1..v8``, ``gg_vq_vae2``) and the
sphere encoders (``sphere_encoder``, ``sphere_encoder_vit``), with the JAX
registry's lambda-weight rules, including its KL weight of
``batch_size / dataset_size``.

The priors (flat and hierarchical) are not in this registry:
``movae_tpu_torch/train/prior.py:build_prior`` builds them, as in the JAX
package, and their names raise ``NotImplementedError`` pointing there; any
other name raises the JAX registry's ``ValueError`` (``gg_vae_v4`` among
them: the JAX package builds no such model).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.models.base import (MOVAEModel, resolve_compute_dtype,
                                         resolve_lambda_weights)
from movae_tpu_torch.models.betatc_vae import BetaTCVAE
from movae_tpu_torch.models.cycle_vae import CycleVAE
from movae_tpu_torch.models.gg_vae import GGVAE
from movae_tpu_torch.models.gg_vq_vae import GGVQVAE
from movae_tpu_torch.models.gg_vq_vae2 import GGVQVAE2
from movae_tpu_torch.models.recursive_cyclic_vae import RecursiveCyclicVAE
from movae_tpu_torch.models.recursive_kl_vae import RecursiveKLVAE
from movae_tpu_torch.models.sphere_encoder import SphereEncoder
from movae_tpu_torch.models.sphere_encoder_vit import SphereEncoderViT
from movae_tpu_torch.models.vae import VAE
from movae_tpu_torch.models.vq_vae import VQVAE
from movae_tpu_torch.models.vq_vae2 import VQVAE2

__all__ = ["BetaTCVAE", "CycleVAE", "GGVAE", "GGVQVAE", "GGVQVAE2",
           "RecursiveCyclicVAE", "RecursiveKLVAE", "SphereEncoder",
           "SphereEncoderViT", "VAE", "VQVAE", "VQVAE2",
           "MOVAEModel", "get_network", "init_model",
           "resolve_compute_dtype"]

_NOT_PORTED = {
    "pixelcnn": "Queue 1 item 8 (the flat priors are built by "
                "movae_tpu_torch/train/prior.py:build_prior)",
    "pixelsnail": "Queue 1 item 8 (the flat priors are built by "
                  "movae_tpu_torch/train/prior.py:build_prior)",
}
GG_VAE_ARCHS = ("gg_vae", "gg_vae_v2", "gg_vae_v3", "gg_vae_v5", "gg_vae_v6")


def _get(args, name, default=None):
    if args is None:
        return default
    if isinstance(args, Mapping):
        return args.get(name, default)
    return getattr(args, name, default)


def _weights(lambda_weights, names, defaults, kld_key=None, kld_value=None,
             kld_force=True, kld_list_override=None):
    """Normalize user weights (dict or positional list, validated
    strictly). ``kld_key`` names the KL-type weight, which becomes
    ``kld_value`` (batch_size / dataset_size): always in a dict with
    ``kld_force``, only when missing from it without (the reference's
    setdefault for recursive_cyclic_vae); in a positional list only with
    ``kld_list_override`` (default ``kld_force``: vae and betatc override
    the list's KL slot, gg_vae and recursive_kl_vae pass lists through)."""
    if kld_list_override is None:
        kld_list_override = kld_force
    if isinstance(lambda_weights, Mapping):
        lw = dict(lambda_weights)
        if kld_key is not None:
            if kld_force:
                lw[kld_key] = kld_value
            else:
                lw.setdefault(kld_key, kld_value)
        return resolve_lambda_weights(names, lw, defaults)
    if lambda_weights is None:
        d = dict(defaults)
        if kld_key is not None:
            d[kld_key] = kld_value
        return resolve_lambda_weights(names, None, d)
    lw = list(lambda_weights)
    if len(lw) != len(names):
        raise ValueError(
            f"requires {len(names)} lambda_weights {tuple(names)}, "
            f"got {len(lw)}")
    items = dict(zip(names, lw))
    if kld_key is not None and kld_list_override:
        items[kld_key] = kld_value
    return resolve_lambda_weights(names, items, defaults)


def _vae_family(arch: str, input_size: int, num_channels: int, args,
                lambda_weights, common: dict) -> MOVAEModel:
    """The VAE-family branches of the JAX registry."""
    kld_w = _get(args, "batch_size", 128) / _get(args, "dataset_size", 50000)
    kw = dict(latent_dim=_get(args, "latent_dim", 128),
              hidden_dims=tuple(_get(args, "hidden_dims",
                                     (32, 64, 128, 256, 512))),
              input_size=input_size, in_channels=num_channels, **common)
    perceptual_fn = kw.pop("perceptual_fn")
    recursive_steps = _get(args, "recursive_kld_anneal_steps", 25000)
    if arch == "betatc_vae" or arch == "btc_vae":
        names = ("reconstruction_loss", "mi_loss", "tc_loss", "kld")
        lw = _weights(lambda_weights, names,
                      {"reconstruction_loss": 1.0, "mi_loss": 1.0,
                       "tc_loss": 1.0, "kld": kld_w}, "kld", kld_w)
        return BetaTCVAE(anneal_steps=_get(args, "anneal_steps", 200) or 200,
                         dataset_size=_get(args, "dataset_size", 50000),
                         lambda_weights=lw, perceptual_fn=perceptual_fn,
                         **kw)
    kw["layer_norm"] = _get(args, "layer_norm", "batch")
    if arch == "vae":
        names = ("reconstruction_loss", "kld_loss")
        lw = _weights(lambda_weights, names,
                      {"reconstruction_loss": 1.0, "kld_loss": kld_w},
                      "kld_loss", kld_w)
        return VAE(lambda_weights=lw, perceptual_fn=perceptual_fn, **kw)
    if arch == "recursive_kl_vae":
        names = ("reconstruction_loss", "recursive_kld_loss")
        lw = _weights(lambda_weights, names,
                      {"reconstruction_loss": 1.0,
                       "recursive_kld_loss": kld_w},
                      "recursive_kld_loss", kld_w, kld_list_override=False)
        return RecursiveKLVAE(lambda_weights=lw,
                              recursive_kld_anneal_steps=recursive_steps,
                              **kw)
    if arch == "cycle_vae":
        names = ("reconstruction_loss", "cycle_loss")
        lw = _weights(lambda_weights, names,
                      {"reconstruction_loss": 1.0, "cycle_loss": kld_w})
        return CycleVAE(lambda_weights=lw, **kw)
    if arch in ("recursive_cyclic_vae", "rc_vae"):
        names = ("reconstruction_loss", "recursive_kld_loss", "cycle_loss")
        lw = _weights(lambda_weights, names,
                      {"reconstruction_loss": 1.0,
                       "recursive_kld_loss": kld_w, "cycle_loss": kld_w},
                      "recursive_kld_loss", kld_w, kld_force=False)
        return RecursiveCyclicVAE(lambda_weights=lw,
                                  recursive_kld_anneal_steps=recursive_steps,
                                  **kw)
    # gg_vae, gg_vae_v2/3/5/6
    names = ("reconstruction_loss", "kld_loss", "gradient_guided_loss",
             "edge_matching_loss")
    lw = _weights(lambda_weights, names,
                  {"reconstruction_loss": 1.0, "kld_loss": kld_w,
                   "gradient_guided_loss": 1.0, "edge_matching_loss": 1.0},
                  "kld_loss", kld_w, kld_list_override=False)
    version = 1 if arch == "gg_vae" else int(arch.rsplit("v", 1)[-1])
    return GGVAE(lambda_weights=lw, edge_matching_version=version, **kw)


def _sphere(arch: str, input_size: int, num_channels: int, args,
            common: dict) -> MOVAEModel:
    """The two sphere-encoder branches of the JAX registry: the lambda_*
    args (1.0 / 0.5 / 0.1) as the lambda weights, and the VGG perceptual
    term unless ``use_perceptual`` is False."""
    l_pr = _get(args, "lambda_pix_recon", 1.0)
    l_pc = _get(args, "lambda_pix_con", 0.5)
    l_lc = _get(args, "lambda_lat_con", 0.1)
    use_perceptual = _get(args, "use_perceptual", True)
    perceptual_fn = None
    if use_perceptual:
        from movae_tpu_torch.metrics.vgg import make_perceptual_fn
        perceptual_fn = make_perceptual_fn()
    kw = dict(sigma_max_angle_deg=_get(args, "sigma_max_angle_deg", 80.0),
              sigma_mix_prob=_get(args, "sigma_mix_prob", 0.0),
              sigma_mix_angle_min_deg=_get(args, "sigma_mix_angle_min_deg"),
              sigma_mix_angle_max_deg=_get(args, "sigma_mix_angle_max_deg"),
              lambda_pix_recon=l_pr, lambda_pix_con=l_pc, lambda_lat_con=l_lc,
              lambda_weights=(("pix_recon", l_pr), ("pix_con", l_pc),
                              ("lat_con", l_lc)),
              use_perceptual=use_perceptual, perceptual_fn=perceptual_fn,
              dtype=common["dtype"])
    latent_dim = _get(args, "latent_dim", 128)
    if arch == "sphere_encoder":
        return SphereEncoder(
            latent_dim=latent_dim,
            hidden_dims=tuple(_get(args, "hidden_dims",
                                   (32, 64, 128, 256, 512))),
            input_size=input_size, in_channels=num_channels,
            recons_objective=common["recons_objective"],
            recons_activation=common["recons_activation"], **kw)
    patch_size = _get(args, "patch_size", None) or (
        2 if input_size <= 32 else 8)
    num_patches = (input_size // patch_size) ** 2
    if latent_dim % num_patches:
        raise ValueError(
            f"sphere_encoder_vit: latent_dim {latent_dim} must be "
            f"divisible by num_patches {num_patches}")
    return SphereEncoderViT(
        img_size=input_size, patch_size=patch_size, in_channels=num_channels,
        embed_dim=_get(args, "vit_embed_dim", 1024),
        depth=_get(args, "vit_depth", 24),
        num_heads=_get(args, "vit_num_heads", 16),
        mixer_depth=_get(args, "vit_mixer_depth", 2),
        latent_channels=latent_dim // num_patches,
        num_classes=_get(args, "num_classes", 0), **kw)


def get_network(input_size: int, num_channels: int = 3, args: Any = None
                ) -> MOVAEModel:
    """Build a model from an args namespace/dict. The module's weights are
    not initialized yet: call :func:`init_model`."""
    arch = (_get(args, "arch", "vae") or "vae").lower()
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to movae_tpu_torch yet: "
            f"ROADMAP.md {_NOT_PORTED[arch]}")
    vae_family = arch in (*GG_VAE_ARCHS, "vae", "betatc_vae", "btc_vae",
                          "cycle_vae", "recursive_kl_vae",
                          "recursive_cyclic_vae", "rc_vae")
    sphere = arch in ("sphere_encoder", "sphere_encoder_vit")
    if not (vae_family or sphere or arch in ("vq_vae", "vq_vae2")
            or arch.startswith("gg_vq_vae")):
        raise ValueError(f"Network architecture {arch} not supported")
    # the conv and dense layers' dtype; parameters stay float32
    dtype = resolve_compute_dtype(_get(args, "compute_dtype", "float32")
                                  or "float32")
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
    if sphere:
        return _sphere(arch, input_size, num_channels, args, dict(
            recons_objective=recons_objective,
            recons_activation=recons_activation, dtype=dtype))
    lambda_weights = (_get(args, "loss_weights", None)
                      or _get(args, "lambda_weights", None))
    if vae_family:
        return _vae_family(arch, input_size, num_channels, args,
                           lambda_weights, dict(
                               recons_objective=recons_objective,
                               recons_activation=recons_activation,
                               perceptual_fn=perceptual_fn, dtype=dtype))
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
        dtype=dtype, **kw)


def init_model(model: MOVAEModel, seed: int = 0,
               device: DeviceLike = None) -> MOVAEModel:
    """Initialize the weights from ``seed`` (on the CPU, so a seed gives the
    same weights on every device) and move the model to ``device``
    (default ``cuda``; raises if no card is present). Returns the model."""
    dev = resolve_device(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)

