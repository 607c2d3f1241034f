"""VQ-VAE-2 (Razavi et al., arXiv:1906.00446) as MO-VAE trains it: a
stride-4 bottom encoder, a stride-2 top encoder, two nearest-code
quantizers with the straight-through estimator, a top decoder whose output
conditions the bottom quantizer, and a stride-4 image decoder over the
upsampled top and the bottom codes.

Parameter names follow MO-VAE's torch layout (``enc_b.blocks.N``,
``quantize_t.embedding.weight``, ...). Everything runs NCHW in the
arithmetic of ``prec``. The objectives, in MO-VAE's order for this model:
reconstruction (mean squared error over every element), commitment
(mean of (sg(q) - z)^2, top plus bottom) and embedding (mean of
(q - sg(z))^2, top plus bottom), each times its configured weight. The
trunk is the two encoders; the rest is the heads.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from portbench.reference.layers import Conv, ConvT
from portbench.reference.precision import Precision

OBJECTIVES = ("reconstruction_loss", "commitment_loss", "embedding_loss")
RES_CHANNELS = 32


class ResBlock(nn.Module):
    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv = nn.Sequential(nn.ReLU(), Conv(cin, ch, 3, padding=1),
                                  nn.ReLU(), Conv(ch, cin, 1))

    def forward(self, x):
        return x + self.conv(x)


def _encoder(cin: int, ch: int, n_res: int, stride: int) -> nn.Sequential:
    if stride == 4:
        layers = [Conv(cin, ch // 2, 4, 2, 1), nn.ReLU(),
                  Conv(ch // 2, ch, 4, 2, 1), nn.ReLU(),
                  Conv(ch, ch, 3, padding=1)]
    else:
        layers = [Conv(cin, ch // 2, 4, 2, 1), nn.ReLU(),
                  Conv(ch // 2, ch, 3, padding=1)]
    layers += [ResBlock(ch, RES_CHANNELS) for _ in range(n_res)]
    return nn.Sequential(*layers, nn.ReLU())


def _decoder(cin: int, cout: int, ch: int, n_res: int, stride: int
             ) -> nn.Sequential:
    layers = [Conv(cin, ch, 3, padding=1)]
    layers += [ResBlock(ch, RES_CHANNELS) for _ in range(n_res)]
    layers.append(nn.ReLU())
    if stride == 4:
        layers += [ConvT(ch, ch // 2, 4, 2, 1), nn.ReLU(),
                   ConvT(ch // 2, cout, 4, 2, 1)]
    else:
        layers.append(ConvT(ch, cout, 4, 2, 1))
    return nn.Sequential(*layers)


class _Blocks(nn.Module):
    def __init__(self, seq: nn.Sequential):
        super().__init__()
        self.blocks = seq

    def forward(self, x):
        return self.blocks(x)


class Codebook(nn.Module):
    def __init__(self, k: int, d: int):
        super().__init__()
        self.embedding = nn.Embedding(k, d)


class VQVAE2(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch = int(cfg["hidden_dims"][0])
        nr = int(cfg["num_residual_layers"])
        d = int(cfg["embedding_dim"])
        k = int(cfg["num_embeddings"])
        self.weights = {n: float(cfg["loss_weights"][n]) for n in OBJECTIVES}
        self.prec = Precision()
        self.enc_b = _Blocks(_encoder(3, ch, nr, 4))
        self.enc_t = _Blocks(_encoder(ch, ch, nr, 2))
        self.quantize_conv_t = Conv(ch, d, 1)
        self.quantize_t = Codebook(k, d)
        self.dec_t = _Blocks(_decoder(d, d, ch, nr, 2))
        self.quantize_conv_b = Conv(d + ch, d, 1)
        self.quantize_b = Codebook(k, d)
        self.upsample_t = ConvT(d, d, 4, 2, 1)
        self.dec = _Blocks(_decoder(2 * d, 3, ch, nr, 4))

    # where a list, every quantizer call appends its chosen codes (rows in
    # NHWC order)
    chosen = None

    def trunk(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc_b = self.enc_b(x)
        return self.enc_t(enc_b), enc_b

    def quantize(self, z: torch.Tensor, book: Codebook):
        """Nearest code of every latent row (NCHW in and out): the
        straight-through quantized latents, commitment and embedding."""
        b, d, h, w = z.shape
        rows = z.permute(0, 2, 3, 1).reshape(-1, d)
        cb = book.embedding.weight
        p = self.prec.operand
        with torch.no_grad():
            dist = ((rows * rows).sum(1, keepdim=True)
                    - 2.0 * p(rows) @ p(cb).T + (cb * cb).sum(1)[None])
            inds = dist.argmin(1)
        if self.chosen is not None:
            self.chosen.append(inds.detach().clone())
        q = cb[inds]
        commitment = (q.detach() - rows).square().mean()
        embedding = (q - rows.detach()).square().mean()
        quantized = rows + (q - rows).detach()
        return (quantized.reshape(b, h, w, d).permute(0, 3, 1, 2),
                commitment, embedding)

    def heads(self, enc_t, enc_b, x) -> Dict[str, torch.Tensor]:
        q_t, c_t, e_t = self.quantize(self.quantize_conv_t(enc_t),
                                      self.quantize_t)
        qb_in = self.quantize_conv_b(torch.cat([self.dec_t(q_t), enc_b], 1))
        q_b, c_b, e_b = self.quantize(qb_in, self.quantize_b)
        recons = self.dec(torch.cat([self.upsample_t(q_t), q_b], 1))
        raw = {"reconstruction_loss": (recons - x).square().mean(),
               "commitment_loss": c_t + c_b, "embedding_loss": e_t + e_b}
        return {n: self.weights[n] * raw[n] for n in OBJECTIVES}


def images_to_input(u8_nhwc: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC images -> float32 NCHW in [-1, 1] (normalized inputs)."""
    return (u8_nhwc.float() / 127.5 - 1.0).permute(0, 3, 1, 2)
