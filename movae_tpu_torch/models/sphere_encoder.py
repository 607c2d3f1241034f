"""Sphere Encoder: image generation with a spherical latent space — port of
``movae_tpu/models/sphere_encoder.py``.

The VAE conv backbone (``models/vae.py``) with the mu / log-var heads
replaced by one linear projection ``encoder_proj`` and ``spherify`` (RMS
normalization to radius sqrt(L)). Training draws a noise angle alpha ~
U[0, alpha_max] (sigma = tan(alpha)), optionally mixed with a second angle
range, a sub-noise scale s ~ U[0, 0.5] and one direction e ~ N(0, I) shared
by both noise levels, and returns three objectives:

  pix_recon — smooth-L1 (+ VGG perceptual) reconstruction of the small-noise
              decode against x;
  pix_con   — the big-noise decode against the detached small-noise decode;
  lat_con   — 1 - cosine(v, spherify(enc(dec(v_noisy)))).

``feature_names = None``: the train step takes the full-parameter Jacobian.
Sampling decodes a random sphere point in one step, or iterates
encode / decode with shared noise.

Draws: ``angle_deg`` (after the sigma mix, (B, 1)), ``s`` ((B, 1), already
scaled by 0.5) and ``e`` ((B, L)) come from ``generator``, or from
``noise`` by name (``sample`` reads ``e``, and ``e_<i>`` for the i-th
unshared step), so that a test can replay the JAX package's draws, which
its forward returns.

The state_dict keys are those of ``movae_tpu/utils/torch_export.py:
_export_sphere``: the VAE's without ``mu`` / ``log_var``, plus
``encoder_proj`` (reading the NCHW flattening, as the VAE's heads do).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from movae_tpu_torch import objectives as obj_lib
from movae_tpu_torch.models.base import (LambdaWeights, Noise, RestartRows,
                                         compute_region)
from movae_tpu_torch.models.vae import VAE, Stats, _nchw, draw_normal

Tensor = torch.Tensor


def rms_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    return x / torch.sqrt(x.square().mean(-1, keepdim=True) + eps)


def spherify(x: Tensor, radius: Optional[float] = None) -> Tensor:
    if radius is None:
        radius = math.sqrt(x.shape[-1])
    return rms_norm(x) * radius


def given_draw(name: str, shape: Sequence[int], noise: Noise,
               device: torch.device) -> Optional[Tensor]:
    """``noise[name]`` as a float32 tensor of ``shape``, or None."""
    if noise is None or name not in noise:
        return None
    return draw_normal(name, shape, None, noise, device)


class SphereMixin:
    """The noise schedule, objectives and sampling shared by the conv and
    the ViT sphere encoders. The host class provides ``encode_to_vector``,
    ``decode_from_sphere``, ``latent_dim`` and the settings below."""

    sigma_max_angle_deg: float
    sigma_mix_prob: float
    sigma_mix_angle_min_deg: Optional[float]
    sigma_mix_angle_max_deg: Optional[float]
    lambda_pix_recon: float
    lambda_pix_con: float
    lambda_lat_con: float
    pix_recon_smooth_l1_weight = 1.0
    pix_recon_perceptual_weight = 1.0
    pix_con_smooth_l1_weight = 0.5
    pix_con_perceptual_weight = 0.5
    use_perceptual: bool
    perceptual_fn: Optional[Any]

    feature_names = None

    def _init_sphere(self, sigma_max_angle_deg, sigma_mix_prob,
                     sigma_mix_angle_min_deg, sigma_mix_angle_max_deg,
                     lambda_pix_recon, lambda_pix_con, lambda_lat_con,
                     use_perceptual, perceptual_fn) -> None:
        self.sigma_max_angle_deg = sigma_max_angle_deg
        self.sigma_mix_prob = sigma_mix_prob
        self.sigma_mix_angle_min_deg = sigma_mix_angle_min_deg
        self.sigma_mix_angle_max_deg = sigma_mix_angle_max_deg
        self.lambda_pix_recon = lambda_pix_recon
        self.lambda_pix_con = lambda_pix_con
        self.lambda_lat_con = lambda_lat_con
        self.use_perceptual = use_perceptual
        self.perceptual_fn = perceptual_fn

    @property
    def objective_names(self) -> Tuple[str, ...]:
        return ("pix_recon", "pix_con", "lat_con")

    @property
    def radius(self) -> float:
        return math.sqrt(self.latent_dim)

    @property
    def sigma_max(self) -> float:
        return math.tan(math.radians(self.sigma_max_angle_deg))

    def _spherify_noisy(self, z: Tensor, sigma: Any = None,
                        e: Optional[Tensor] = None) -> Tensor:
        """spherify(spherify(z) + sigma e): the noise is added to the
        already spherified v."""
        v = spherify(z, self.radius)
        if sigma is not None and e is not None:
            v = spherify(v + sigma * e, self.radius)
        return v

    def _angles(self, b: int, generator: Optional[torch.Generator],
                noise: Noise, device: torch.device) -> Tuple[Tensor, Tensor]:
        """(angle_deg, s), each (B, 1): given, or drawn as the JAX package
        draws them."""
        angle = given_draw("angle_deg", (b, 1), noise, device)
        if angle is None:
            angle = torch.rand((b, 1), generator=generator, device=device) \
                * self.sigma_max_angle_deg
            lo, hi = self.sigma_mix_angle_min_deg, self.sigma_mix_angle_max_deg
            if (self.sigma_mix_prob > 0 and lo is not None and hi is not None
                    and hi > lo):
                mask = torch.rand((b, 1), generator=generator,
                                  device=device) < self.sigma_mix_prob
                mix = lo + torch.rand((b, 1), generator=generator,
                                      device=device) * (hi - lo)
                angle = torch.where(mask, mix, angle)
        s = given_draw("s", (b, 1), noise, device)
        if s is None:
            s = torch.rand((b, 1), generator=generator, device=device) * 0.5
        return angle, s

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                restart_rows: RestartRows = None,
                noise: Noise = None) -> Dict[str, Any]:
        stats: Dict[str, Tensor] = {}
        b = x.shape[0]
        z = self.encode_to_vector(x, train=train, stats=stats)
        v = self._spherify_noisy(z)
        angle_deg, s = self._angles(b, generator, noise, z.device)
        sigma = torch.tan(angle_deg * (math.pi / 180.0))
        sigma_sub = s * sigma
        e = draw_normal("e", (b, self.latent_dim), generator, noise,
                        z.device)
        v_noisy = self._spherify_noisy(z, sigma, e)
        v_noisy_small = self._spherify_noisy(z, sigma_sub, e)
        x_small = self.decode_from_sphere(v_noisy_small, train=train,
                                          stats=stats)
        x_noisy = self.decode_from_sphere(v_noisy, train=train, stats=stats)
        z_ed = self.encode_to_vector(x_noisy, train=train, stats=stats)
        out = {"recons": x_small, "v": v, "v_noisy": v_noisy,
               "v_noisy_small": v_noisy_small, "x_recon_NOISY": x_noisy,
               "x_recon_noisy_small_sg": x_small.detach(),
               "v_enc_dec": self._spherify_noisy(z_ed), "sigma": sigma,
               "sigma_sub": sigma_sub, "angle_deg": angle_deg, "s": s,
               "e": e}
        if train and stats:
            out["batch_stats"] = stats
        return out

    def trunk(self, x: Tensor, train: bool = False):
        raise NotImplementedError(
            "the sphere encoders have no trunk/heads split "
            "(feature_names=None); use forward_with_losses")

    def heads(self, *args, **kwargs):
        raise NotImplementedError(
            "the sphere encoders have no trunk/heads split "
            "(feature_names=None)")

    # --- losses ------------------------------------------------------------
    def _pixel_loss(self, pred: Tensor, target: Tensor, sl1_w: float,
                    perc_w: float) -> Tensor:
        loss = sl1_w * obj_lib.smooth_l1_per_pixel_mean(target, pred)
        if self.use_perceptual and self.perceptual_fn is not None \
                and perc_w > 0:
            loss = loss + perc_w * self.perceptual_fn(target, pred)
        return loss

    def loss_terms(self, x: Tensor, outputs: Dict[str, Any]
                   ) -> Dict[str, Tensor]:
        pix_recon = self._pixel_loss(outputs["recons"], x,
                                     self.pix_recon_smooth_l1_weight,
                                     self.pix_recon_perceptual_weight)
        pix_con = self._pixel_loss(outputs["x_recon_NOISY"],
                                   outputs["x_recon_noisy_small_sg"],
                                   self.pix_con_smooth_l1_weight,
                                   self.pix_con_perceptual_weight)
        v, v_ed = outputs["v"], outputs["v_enc_dec"]
        cos = (v * v_ed).sum(-1) / (
            torch.linalg.vector_norm(v, dim=-1)
            * torch.linalg.vector_norm(v_ed, dim=-1) + 1e-12)
        return {"pix_recon": self.lambda_pix_recon * pix_recon,
                "pix_con": self.lambda_pix_con * pix_con,
                "lat_con": self.lambda_lat_con * (1.0 - cos).mean()}

    # --- generation --------------------------------------------------------
    @torch.no_grad()
    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None, steps: int = 1,
               share_noise: bool = True, noise: Noise = None) -> Tensor:
        """Decode a random sphere point; each further step encodes the
        image, re-noises it at sigma_max (with the first direction when
        ``share_noise``) and decodes again."""
        device = next(self.parameters()).device
        shape = (num_samples, self.latent_dim)
        e = draw_normal("e", shape, generator, noise, device)
        x = self.decode_from_sphere(spherify(e, self.radius), train=False)
        for i in range(steps - 1):
            z = self.encode_to_vector(x, train=False)
            e_step = e if share_noise else draw_normal(
                f"e_{i + 1}", shape, generator, noise, device)
            v = self._spherify_noisy(z, self.sigma_max, e_step)
            x = self.decode_from_sphere(v, train=False)
        return x


class SphereEncoder(SphereMixin, VAE):

    default_weights: LambdaWeights = (("pix_recon", 1.0), ("pix_con", 0.5),
                                      ("lat_con", 0.1))

    def __init__(self, latent_dim: int = 128, input_size: int = 32,
                 in_channels: int = 3,
                 hidden_dims: Tuple[int, ...] = (32, 64, 128, 256, 512),
                 recons_activation: str = "tanh",
                 recons_objective: str = "mse",
                 sigma_max_angle_deg: float = 80.0,
                 sigma_mix_prob: float = 0.0,
                 sigma_mix_angle_min_deg: Optional[float] = None,
                 sigma_mix_angle_max_deg: Optional[float] = None,
                 lambda_pix_recon: float = 1.0, lambda_pix_con: float = 0.5,
                 lambda_lat_con: float = 0.1,
                 lambda_weights: Optional[LambdaWeights] = None,
                 use_perceptual: bool = True,
                 perceptual_fn: Optional[Any] = None,
                 dtype: Any = torch.float32):
        super().__init__(latent_dim=latent_dim, input_size=input_size,
                         in_channels=in_channels, hidden_dims=hidden_dims,
                         layer_norm="batch",
                         recons_activation=recons_activation,
                         recons_objective=recons_objective,
                         lambda_weights=lambda_weights, dtype=dtype)
        self._init_sphere(sigma_max_angle_deg, sigma_mix_prob,
                          sigma_mix_angle_min_deg, sigma_mix_angle_max_deg,
                          lambda_pix_recon, lambda_pix_con, lambda_lat_con,
                          use_perceptual, perceptual_fn)
        c, s = self.hidden_dims[-1], self.spatial_dim
        del self.mu, self.log_var
        self.encoder_proj = nn.Linear(c * s * s, latent_dim)

    def encode_to_vector(self, x: Tensor, train: bool = False,
                         stats: Stats = None) -> Tensor:
        """NHWC images -> float32 (B, latent_dim) before spherify."""
        with compute_region(self.compute_dtype, x.device):
            h = _nchw(x, self.compute_dtype)
            for block in self.encoder:
                h = self._block(block, h, train, stats)
            z = self.encoder_proj(h.flatten(1))
        return z.float()

    def decode_from_sphere(self, v: Tensor, train: bool = False,
                           stats: Stats = None) -> Tensor:
        return VAE.decode(self, v, train=train, stats=stats)

    def encode(self, x: Tensor, train: bool = False, stats: Stats = None):
        return (self._spherify_noisy(self.encode_to_vector(x, train, stats)),)

    def decode(self, z: Tensor, train: bool = False, stats: Stats = None
               ) -> Tensor:
        return self.decode_from_sphere(self._spherify_noisy(z), train, stats)
