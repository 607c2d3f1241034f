"""Load the JAX package's flax parameters into the port's modules.

The JAX package's flax trees come in as nested dicts of numpy arrays; they
are mapped onto the reference-torch ``state_dict`` layout — the layout of
``movae_tpu/utils/torch_export.py:export_torch_state_dict``, of which this is
a self-contained copy for ``vq_vae``, ``vq_vae2``, ``pixelcnn``,
``pixelsnail`` and the hierarchical priors — and loaded strictly. No JAX
needed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from movae_tpu_torch.models.base import MOVAEModel


def _conv_w(k: np.ndarray) -> np.ndarray:
    """flax HWIO -> torch Conv2d OIHW."""
    return np.transpose(k, (3, 2, 0, 1))


def _conv_t_w(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (kh, kw, I, O), flipped -> torch (I, O, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))


def _flatten(tree: Optional[Mapping], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in (tree or {}).items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _count(flat: Mapping[str, np.ndarray], pattern: str) -> int:
    n = 0
    while pattern.format(n) in flat:
        n += 1
    return n


class _Mapper:
    """Consumes flax leaves and emits torch ``state_dict`` entries."""

    def __init__(self, params: Mapping, batch_stats: Optional[Mapping]):
        self.params = _flatten(params)
        self.stats = _flatten(batch_stats)
        self.state: Dict[str, np.ndarray] = {}

    def take(self, fpath: str) -> np.ndarray:
        if fpath in self.params:
            return self.params.pop(fpath)
        if fpath in self.stats:
            return self.stats.pop(fpath)
        raise KeyError(f"missing flax leaf: {fpath}")

    def conv(self, tprefix: str, fpath: str, bias: bool = True,
             transpose: bool = False) -> None:
        k = self.take(fpath + "/kernel")
        self.state[tprefix + ".weight"] = _conv_t_w(k) if transpose else _conv_w(k)
        if bias:
            self.state[tprefix + ".bias"] = self.take(fpath + "/bias")

    def dense_as_1x1(self, tprefix: str, fpath: str) -> None:
        """flax Dense (in, out) -> torch 1x1 Conv2d (out, in, 1, 1)."""
        self.state[tprefix + ".weight"] = np.transpose(
            self.take(fpath + "/kernel"))[:, :, None, None]
        self.state[tprefix + ".bias"] = self.take(fpath + "/bias")

    def finish(self) -> Dict[str, np.ndarray]:
        left = sorted(self.params) + sorted(self.stats)
        if left:
            raise KeyError(f"unmapped flax leaves: {left[:10]}")
        return self.state


def vqvae_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, np.ndarray]:
    """flax ``vq_vae`` (params, batch_stats) -> reference-torch state_dict
    (numpy values). With an EMA codebook the codebook and its statistics
    come from ``batch_stats``."""
    mp = _Mapper(params, batch_stats)
    H = _count(mp.params, "enc_conv_{}/kernel")
    R = _count(mp.params, "enc_res_{}/conv3/kernel")
    for i in range(H):
        mp.conv(f"encoder.{i}.0", f"enc_conv_{i}")
    mp.conv(f"encoder.{H}.0", "enc_mid")
    for r in range(R):
        mp.conv(f"encoder.{H + 1 + r}.resblock.0", f"enc_res_{r}/conv3",
                bias=False)
        mp.conv(f"encoder.{H + 1 + r}.resblock.2", f"enc_res_{r}/conv1",
                bias=False)
    mp.conv(f"encoder.{H + 2 + R}.0", "enc_proj")
    mp.state["vq_layer.embedding.weight"] = mp.take("vq/embedding")
    for name in ("cluster_size", "ema_embed"):
        if f"vq/{name}" in mp.stats:
            mp.state[f"vq_layer.{name}"] = mp.take(f"vq/{name}")
    mp.conv("decoder.0.0", "dec_in")
    for r in range(R):
        mp.conv(f"decoder.{1 + r}.resblock.0", f"dec_res_{r}/conv3",
                bias=False)
        mp.conv(f"decoder.{1 + r}.resblock.2", f"dec_res_{r}/conv1",
                bias=False)
    D = _count(mp.params, "dec_deconv_{}/kernel") + 1
    for i in range(D - 1):
        mp.conv(f"decoder.{2 + R + i}.0", f"dec_deconv_{i}", transpose=True)
    mp.conv(f"decoder.{2 + R + D - 1}.0", "dec_final", transpose=True)
    return mp.finish()


def _ros_encoder(mp: _Mapper, t: str, f: str, stride: int) -> None:
    """A VQ-VAE-2 ``Encoder``: ``{t}.blocks.N`` (ReLUs take indices)."""
    mp.conv(f"{t}.blocks.0", f"{f}/down1")
    if stride == 4:
        mp.conv(f"{t}.blocks.2", f"{f}/down2")
        mp.conv(f"{t}.blocks.4", f"{f}/mid")
        base = 5
    else:
        mp.conv(f"{t}.blocks.2", f"{f}/mid")
        base = 3
    for r in range(_count(mp.params, f + "/res_{}/conv3/kernel")):
        mp.conv(f"{t}.blocks.{base + r}.conv.1", f"{f}/res_{r}/conv3")
        mp.conv(f"{t}.blocks.{base + r}.conv.3", f"{f}/res_{r}/conv1")


def _ros_decoder(mp: _Mapper, t: str, f: str, stride: int) -> None:
    """A VQ-VAE-2 ``Decoder``: k3 conv, residual blocks, transposed convs."""
    mp.conv(f"{t}.blocks.0", f"{f}/in")
    R = _count(mp.params, f + "/res_{}/conv3/kernel")
    for r in range(R):
        mp.conv(f"{t}.blocks.{1 + r}.conv.1", f"{f}/res_{r}/conv3")
        mp.conv(f"{t}.blocks.{1 + r}.conv.3", f"{f}/res_{r}/conv1")
    mp.conv(f"{t}.blocks.{R + 2}", f"{f}/up1", transpose=True)
    if stride == 4:
        mp.conv(f"{t}.blocks.{R + 4}", f"{f}/up2", transpose=True)


def vqvae2_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None,
                      ema_stats: bool = False) -> Dict[str, np.ndarray]:
    """flax ``vq_vae2`` (params, batch_stats) -> reference-torch state_dict
    (numpy values), in the key order of ``_export_vqvae2``. With EMA
    codebooks the codebooks come from ``batch_stats``; their EMA statistics
    are dropped as the exporter drops them, or kept as
    ``quantize_{t,b}.{cluster_size,ema_embed}`` with ``ema_stats``."""
    mp = _Mapper(params, batch_stats)
    _ros_encoder(mp, "enc_b", "enc_b", 4)
    _ros_encoder(mp, "enc_t", "enc_t", 2)
    mp.conv("quantize_conv_t", "quantize_conv_t")
    mp.state["quantize_t.embedding.weight"] = mp.take("vq_top/embedding")
    _ros_decoder(mp, "dec_t", "dec_t", 2)
    mp.conv("quantize_conv_b", "quantize_conv_b")
    mp.state["quantize_b.embedding.weight"] = mp.take("vq_bottom/embedding")
    mp.conv("upsample_t", "upsample_t", transpose=True)
    _ros_decoder(mp, "dec", "dec", 4)
    for side, tname in (("vq_top", "quantize_t"), ("vq_bottom", "quantize_b")):
        for name in ("cluster_size", "ema_embed"):
            if f"{side}/{name}" in mp.stats:
                value = mp.take(f"{side}/{name}")
                if ema_stats:
                    mp.state[f"{tname}.{name}"] = value
    return mp.finish()


def _gated_res(mp: _Mapper, tprefix: str, fprefix: str) -> None:
    for name in ("conv1", "conv2", "conv_gate", "conv_feature"):
        mp.conv(f"{tprefix}.{name}", f"{fprefix}/{name}")


def _pixelcnn(mp: _Mapper, t: str = "", f: str = "") -> None:
    mp.state[f"{t}embedding.weight"] = mp.take(f"{f}embedding/embedding")
    mp.conv(f"{t}conv_in", f"{f}conv_in")
    for i in range(_count(mp.params, f + "res_{}/conv1/kernel")):
        _gated_res(mp, f"{t}res_blocks.{i}", f"{f}res_{i}")
    mp.conv(f"{t}conv_out.1", f"{f}out1")
    mp.conv(f"{t}conv_out.3", f"{f}out2")


def _pixelsnail(mp: _Mapper, t: str = "", f: str = "") -> None:
    mp.state[f"{t}embedding.weight"] = mp.take(f"{f}embedding/embedding")
    mp.conv(f"{t}conv_in", f"{f}conv_in")
    for b in range(_count(mp.params, f + "block_{}/out_conv/kernel")):
        tb, fb = f"{t}blocks.{b}", f"{f}block_{b}"
        for r in range(_count(mp.params, fb + "/res_{}/conv1/kernel")):
            _gated_res(mp, f"{tb}.res_blocks.{r}", f"{fb}/res_{r}")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            mp.dense_as_1x1(f"{tb}.attention.{proj}",
                            f"{fb}/attention/{proj}")
        mp.conv(f"{tb}.out_conv", f"{fb}/out_conv")
    mp.conv(f"{t}conv_out.1", f"{f}out1")
    mp.conv(f"{t}conv_out.3", f"{f}out2")


def pixelcnn_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``PixelCNN`` params -> reference-torch state_dict (numpy)."""
    mp = _Mapper(params, None)
    _pixelcnn(mp)
    return mp.finish()


def pixelsnail_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``PixelSNAIL`` params -> reference-torch state_dict (numpy);
    the attention projections become 1x1 convolutions."""
    mp = _Mapper(params, None)
    _pixelsnail(mp)
    return mp.finish()


def hierarchical_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``HierarchicalPixelCNN`` / ``HierarchicalPixelSNAIL`` params ->
    reference-torch state_dict (numpy), in the key order of
    ``_export_hierarchical``: ``prior_top.*`` (a PixelSNAIL where the top has
    attention blocks), ``embedding_top.weight``, ``upsample_top``,
    ``prior_bottom.*``."""
    mp = _Mapper(params, None)
    top = (_pixelsnail if "prior_top/block_0/out_conv/kernel" in mp.params
           else _pixelcnn)
    top(mp, "prior_top.", "prior_top/")
    mp.state["embedding_top.weight"] = mp.take("embedding_top/embedding")
    mp.conv("upsample_top", "upsample_top", transpose=True)
    _pixelcnn(mp, "prior_bottom.", "prior_bottom/")
    return mp.finish()


def _load_strict(model: torch.nn.Module, state: Mapping[str, np.ndarray]
                 ) -> None:
    ref = model.state_dict()
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)).to(ref[k].dtype)
         for k, v in state.items()}, strict=True)


def load_jax_prior_params(model: torch.nn.Module, params: Mapping
                          ) -> torch.nn.Module:
    """Copy a flax ``PixelCNN`` / ``PixelSNAIL`` / hierarchical prior param
    tree (nested dicts of numpy arrays) into the port's prior in place,
    strictly; returns it."""
    from movae_tpu_torch.models import pixelcnn as pc

    if isinstance(model, pc.HierarchicalPrior):
        fn = hierarchical_state_dict
    elif isinstance(model, pc.PixelSNAIL):
        fn = pixelsnail_state_dict
    else:
        fn = pixelcnn_state_dict
    _load_strict(model, fn(params))
    return model


def load_jax_params(model: MOVAEModel, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> MOVAEModel:
    """Copy a flax param tree (nested dicts of numpy arrays) and its
    batch_stats into ``model`` (``VQVAE`` or ``VQVAE2``) in place, strictly;
    returns the model."""
    from movae_tpu_torch.models.vq_vae2 import VQVAE2

    if isinstance(model, VQVAE2):
        state = vqvae2_state_dict(params, batch_stats, ema_stats=model.vq_ema)
    else:
        state = vqvae_state_dict(params, batch_stats)
    _load_strict(model, state)
    return model
