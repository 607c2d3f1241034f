"""Work counted from the shapes of a call, the yardstick of ``mfu`` and of
every roofline share.

Model FLOPs are the frozen reference's: every convolution counted whole
(2 x outputs x input channels x kernel area; a transposed convolution
over its inputs), the nearest-code distances as one (N, D) x (D, K)
product, and causal attention over its L(L + 1)/2 pairs (q k^T and p v:
4 x pairs x head size). A training step counts one forward and one
backward, the backward twice the forward, whatever the aggregator: the
Jacobian's extra passes under a multi-objective aggregator are overhead,
not model work. The nearest-code search has no backward.

A kernel's work (``nearest_code_work``, ``flash_work``) is copied from
``chip_smoke.py``'s ``time_nearest`` and ``flash_bounds``: the products of
the call, and each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.peaks import HBM_BYTES_PER_S

Work = Tuple[float, float]  # (operations, bytes)


def conv(b: int, cin: int, cout: int, k: int, out_hw: int) -> float:
    return 2.0 * b * out_hw * out_hw * cout * cin * k * k


def conv_t(b: int, cin: int, cout: int, k: int, in_hw: int) -> float:
    return 2.0 * b * in_hw * in_hw * cin * cout * k * k


def _res(b: int, ch: int, rc: int, hw: int, n: int) -> float:
    return n * (conv(b, ch, rc, 3, hw) + conv(b, rc, ch, 1, hw))


def vqvae2_forward(cfg: dict, b: int) -> Dict[str, float]:
    """{"model": conv FLOPs, "vq": distance FLOPs} of one forward."""
    s = int(cfg["image_size"])
    ch, d = int(cfg["hidden_dims"][0]), int(cfg["embedding_dim"])
    k, nr, rc = int(cfg["num_embeddings"]), int(cfg["num_residual_layers"]), 32
    s2, s4, s8 = s // 2, s // 4, s // 8
    model = (conv(b, 3, ch // 2, 4, s2) + conv(b, ch // 2, ch, 4, s4)
             + conv(b, ch, ch, 3, s4) + _res(b, ch, rc, s4, nr)      # enc_b
             + conv(b, ch, ch // 2, 4, s8) + conv(b, ch // 2, ch, 3, s8)
             + _res(b, ch, rc, s8, nr)                               # enc_t
             + conv(b, ch, d, 1, s8)                                 # q_conv_t
             + conv(b, d, ch, 3, s8) + _res(b, ch, rc, s8, nr)
             + conv_t(b, ch, d, 4, s8)                               # dec_t
             + conv(b, d + ch, d, 1, s4)                             # q_conv_b
             + conv_t(b, d, d, 4, s8)                                # upsample
             + conv(b, 2 * d, ch, 3, s4) + _res(b, ch, rc, s4, nr)
             + conv_t(b, ch, ch // 2, 4, s4) + conv_t(b, ch // 2, 3, 4, s2))
    vq = 2.0 * (b * s8 * s8 + b * s4 * s4) * k * d
    return {"model": model, "vq": vq}


def vqvae2_step_flops(cfg: dict, b: int) -> float:
    f = vqvae2_forward(cfg, b)
    return 3.0 * f["model"] + f["vq"]


def nearest_code_launches(cfg: dict, b: int) -> List[Tuple[int, int, int]]:
    """(N, K, D) of each nearest-code launch of one stage-1 step."""
    s, k, d = (int(cfg["image_size"]), int(cfg["num_embeddings"]),
               int(cfg["embedding_dim"]))
    return [(b * (s // 8) ** 2, k, d), (b * (s // 4) ** 2, k, d)]


def nearest_code_work(n: int, k: int, d: int) -> Work:
    return (2.0 * n * k * d + 2.0 * k * d,
            4.0 * (n * d + k * d) + 4.0 * n)


def pixelsnail_forward(cfg: dict, b: int, h: int, w: int) -> Dict[str, float]:
    """{"model": conv and projection FLOPs, "attention": causal attention
    FLOPs} of one forward."""
    c, d = int(cfg["hidden_channels"]), int(cfg["embedding_dim"])
    kk, k = int(cfg["kernel_size"]), int(cfg["num_embeddings"])
    heads, hd = int(cfg["num_heads"]), int(cfg["hidden_channels"]) // int(
        cfg["num_heads"])
    nres, nb = int(cfg["num_res_blocks"]), int(cfg["num_blocks"])
    L = h * w

    def c1(cin, cout, kern=1):
        return 2.0 * b * L * cin * cout * kern * kern

    gated = c1(c, c // 2) + c1(c // 2, c // 2, 3) + 2 * c1(c // 2, c)
    block = nres * gated + 4 * c1(c, c) + c1(2 * c, c)
    model = c1(d + 2, c, kk) + nb * block + c1(c, c) + c1(c, k)
    attention = nb * 4.0 * b * heads * (L * (L + 1) / 2) * hd
    return {"model": model, "attention": attention}


def pixelsnail_step_flops(cfg: dict, b: int, h: int, w: int) -> float:
    f = pixelsnail_forward(cfg, b, h, w)
    return 3.0 * (f["model"] + f["attention"])


def flash_work(b: int, h: int, L: int, d: int, elem_bytes: int = 2
               ) -> Dict[str, Work]:
    """Each flash kernel's (operations, bytes) at (B, H, L, D), causal."""
    pairs = b * h * L * (L + 1) / 2
    mat, row = float(elem_bytes) * b * h * L * d, 4.0 * b * h * L
    return {"fwd": (4 * pairs * d, 4 * mat + row),
            "dkv": (8 * pairs * d, 6 * mat + 2 * row),
            "dq": (6 * pairs * d, 5 * mat + 2 * row)}


def bound_seconds(work: Work, tensor_peak: float) -> float:
    """The least time the card could take: operations over the tensor-core
    peak or bytes over HBM, whichever is larger."""
    ops, nbytes = work
    return max(ops / tensor_peak, nbytes / HBM_BYTES_PER_S)
