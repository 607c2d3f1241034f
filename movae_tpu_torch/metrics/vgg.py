"""VGG16 feature tower: LPIPS and the perceptual reconstruction loss — port
of ``movae_tpu/metrics/vgg.py``.

torchvision's ``vgg16().features`` through conv4_3's ReLU (indices 0-22),
tapped after the ReLUs of conv1_2 / conv2_2 / conv3_3 / conv4_3 (indices 3,
8, 15, 22). LPIPS = the squared distance between channel-unit-normalized
features, summed over channels, averaged over space, then over the layers
and the batch; the perceptual loss is the feature MSE at conv3_3.
``state_dict()`` keys are torchvision's (``features.N.{weight,bias}``);
the JAX package's converted ``.npz`` loads through
:func:`movae_tpu_torch.utils.weights.load_tower_npz`.

Weights: :func:`build_vgg16` loads the ``.npz`` named by its argument or
``MOVAE_VGG16_WEIGHTS`` (a path that is set but missing raises), or falls
back to a fixed-seed random init (``metrics/pretrained.py``). The tower's
weights never require gradients: the perceptual loss's gradient goes back
through the frozen tower into the reconstruction only.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch.device import DeviceLike, resolve_device
from movae_tpu_torch.ops.resize import as_float

Tensor = torch.Tensor

# VGG16 cfg "D" through conv4_3: (name, out_channels); "M" = 2x2 max pool
VGG_PLAN = (
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
)

LPIPS_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")
PERCEPTUAL_TAP = "conv3_3"

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def conv_names() -> Dict[int, str]:
    """{index in ``features``: conv name} (a ReLU follows every conv)."""
    out, idx = {}, 0
    for item in VGG_PLAN:
        if item == "M":
            idx += 1
        else:
            out[idx] = item[0]
            idx += 2
    return out


class VGG16Features(nn.Module):
    """``forward(x, taps)``: preprocessed NHWC images -> {tap name: NHWC
    activation}, running only as far as the last tap asked for."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in VGG_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item[1], 3, padding=1), nn.ReLU()]
                cin = item[1]
        self.features = nn.Sequential(*layers)
        # the ReLU after each tapped conv
        self._tap_at = {i + 1: name for i, name in conv_names().items()
                        if name in LPIPS_TAPS}

    def forward(self, x: Tensor, taps: Sequence[str] = LPIPS_TAPS
                ) -> Dict[str, Tensor]:
        h = x.permute(0, 3, 1, 2)
        out: Dict[str, Tensor] = {}
        for i, layer in enumerate(self.features):
            h = layer(h)
            name = self._tap_at.get(i)
            if name in taps:
                out[name] = h.permute(0, 2, 3, 1)
                if len(out) == len(taps):
                    break
        return out


def preprocess(x: Tensor) -> Tensor:
    """[-1, 1] or [0, 1] NHWC images (auto-ranged on the batch minimum) ->
    ImageNet-normalized float32 (float64 stays float64)."""
    x = as_float(x)
    x = torch.where(x.min() < 0, (x + 1.0) / 2.0, x).clamp(0.0, 1.0)
    mean = x.new_tensor(_IMAGENET_MEAN)
    std = x.new_tensor(_IMAGENET_STD)
    return (x - mean) / std


def lpips_from_taps(t1: Dict[str, Tensor], t2: Dict[str, Tensor]) -> Tensor:
    """Unit-normalize channels, squared distance summed over channels,
    averaged over space, then over layers and batch."""
    scores = []
    for name in LPIPS_TAPS:
        f1, f2 = t1[name], t2[name]
        n1 = f1 / torch.linalg.vector_norm(f1, dim=-1,
                                           keepdim=True).clamp(min=1e-10)
        n2 = f2 / torch.linalg.vector_norm(f2, dim=-1,
                                           keepdim=True).clamp(min=1e-10)
        d = (n1 - n2).square().sum(dim=-1)            # (B, H, W)
        scores.append(d.mean(dim=(1, 2)))             # (B,)
    return torch.stack(scores).mean()


def build_vgg16(weights_path: Optional[str] = None,
                device: DeviceLike = None) -> VGG16Features:
    """A :class:`VGG16Features` on ``device`` (default ``cuda``), its weights
    from ``weights_path`` or ``MOVAE_VGG16_WEIGHTS``, else the port's
    fixed-seed random init with a one-time warning. Its weights do not
    require gradients."""
    from movae_tpu_torch.metrics.pretrained import load_tower

    dev = resolve_device(device)
    model = load_tower(VGG16Features(), weights_path, "MOVAE_VGG16_WEIGHTS",
                       "VGG16", "LPIPS/perceptual")
    return model.to(dev).eval().requires_grad_(False)


def make_lpips_fn(model: Optional[VGG16Features] = None,
                  device: DeviceLike = None
                  ) -> Callable[[Tensor, Tensor], Tensor]:
    """(img1, img2) NHWC -> 0-dim LPIPS tensor, without gradients; the
    images move to the tower's device (default ``cuda``)."""
    model = model if model is not None else build_vgg16(device=device)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def fn(img1: Tensor, img2: Tensor) -> Tensor:
        t1 = model(preprocess(torch.as_tensor(img1).to(dev)))
        t2 = model(preprocess(torch.as_tensor(img2).to(dev)))
        return lpips_from_taps(t1, t2)

    return fn


def make_perceptual_fn(model: Optional[VGG16Features] = None
                       ) -> Callable[[Tensor, Tensor], Tensor]:
    """(inputs, recons) NHWC -> the conv3_3 feature MSE, differentiable
    w.r.t. both images. The tower is built on the CPU and follows the
    images to their device on first use (a model is built before
    ``init_model`` moves it)."""
    tower = model if model is not None else build_vgg16(device="cpu")

    def fn(inputs: Tensor, recons: Tensor) -> Tensor:
        if next(tower.parameters()).device != recons.device:
            tower.to(recons.device)  # in place
        taps = (PERCEPTUAL_TAP,)
        t_in = tower(preprocess(inputs), taps)[PERCEPTUAL_TAP]
        t_re = tower(preprocess(recons), taps)[PERCEPTUAL_TAP]
        return F.mse_loss(t_re, t_in)

    return fn
