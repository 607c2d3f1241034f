"""InceptionV3 (pool-2048 features and 1000-way logits) — port of
``movae_tpu/metrics/inception.py``.

torchvision's ``inception_v3`` with ``transform_input=False`` in eval mode
and without the auxiliary head: BasicConv2d = bias-free conv + BatchNorm
(eps 1e-3, running statistics) + ReLU; Mixed_5b..7c; global average pool to
2048 features; the ``fc`` head. Submodules carry torchvision's names, so
``state_dict()`` keys are torchvision's (a torchvision state dict loads
with ``strict=False`` for its ``AuxLogits``); the converted ``.npz`` of the
JAX package loads through :func:`movae_tpu_torch.utils.weights.load_tower_npz`.
The 3x3 average pools count their padding (``count_include_pad``, the
default, as flax's ``avg_pool`` does); the max pools are 3x3 stride 2 with
no padding.

Weights: :func:`build_inception` loads the ``.npz`` named by its argument or
``MOVAE_INCEPTION_WEIGHTS`` (a path that is set but missing raises), or
falls back to a fixed-seed random init (``metrics/pretrained.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from movae_tpu_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: Tensor) -> Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _max_pool3s2(x: Tensor) -> Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                       padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1),
                                       padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                          padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                          padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                          padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7),
                                          padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7),
                                         padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1),
                                         padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
            self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                        padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                        padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                           padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                           padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b3, bd, bp], 1)


_MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
          "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
          "Mixed_7c")


class InceptionV3(nn.Module):
    """``forward(x)``: preprocessed NHWC images -> (features (B, 2048),
    logits (B, 1000)). Built in eval mode: BatchNorm reads its running
    statistics."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)
        self.eval()

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool3s2(x)
        for name in _MIXED:
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))
        return feats, self.fc(feats)


def build_inception(weights_path: Optional[str] = None,
                    device: DeviceLike = None) -> InceptionV3:
    """An :class:`InceptionV3` on ``device`` (default ``cuda``), its weights
    from ``weights_path`` or ``MOVAE_INCEPTION_WEIGHTS``, else the port's
    fixed-seed random init with a one-time warning."""
    from movae_tpu_torch.metrics.pretrained import load_tower

    dev = resolve_device(device)
    model = load_tower(InceptionV3(), weights_path, "MOVAE_INCEPTION_WEIGHTS",
                       "InceptionV3", "FID/IS/KID")
    return model.to(dev).requires_grad_(False)
