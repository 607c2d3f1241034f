"""Load the JAX package's flax parameters into the port's modules.

The JAX package's flax trees come in as nested dicts of numpy arrays; they
are mapped onto the reference-torch ``state_dict`` layout — the layout of
``movae_tpu/utils/torch_export.py:export_torch_state_dict``, of which this is
a self-contained copy for ``vq_vae``, ``pixelcnn`` and ``pixelsnail`` — and
loaded strictly. No JAX needed.
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


def _gated_res(mp: _Mapper, tprefix: str, fprefix: str) -> None:
    for name in ("conv1", "conv2", "conv_gate", "conv_feature"):
        mp.conv(f"{tprefix}.{name}", f"{fprefix}/{name}")


def _prior_io(mp: _Mapper, body) -> Dict[str, np.ndarray]:
    mp.state["embedding.weight"] = mp.take("embedding/embedding")
    mp.conv("conv_in", "conv_in")
    body()
    mp.conv("conv_out.1", "out1")
    mp.conv("conv_out.3", "out2")
    return mp.finish()


def pixelcnn_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``PixelCNN`` params -> reference-torch state_dict (numpy)."""
    mp = _Mapper(params, None)

    def body():
        for i in range(_count(mp.params, "res_{}/conv1/kernel")):
            _gated_res(mp, f"res_blocks.{i}", f"res_{i}")

    return _prior_io(mp, body)


def pixelsnail_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``PixelSNAIL`` params -> reference-torch state_dict (numpy);
    the attention projections become 1x1 convolutions."""
    mp = _Mapper(params, None)

    def body():
        for b in range(_count(mp.params, "block_{}/out_conv/kernel")):
            t, f = f"blocks.{b}", f"block_{b}"
            for r in range(_count(mp.params, f + "/res_{}/conv1/kernel")):
                _gated_res(mp, f"{t}.res_blocks.{r}", f"{f}/res_{r}")
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                mp.dense_as_1x1(f"{t}.attention.{proj}",
                                f"{f}/attention/{proj}")
            mp.conv(f"{t}.out_conv", f"{f}/out_conv")

    return _prior_io(mp, body)


def _load_strict(model: torch.nn.Module, state: Mapping[str, np.ndarray]
                 ) -> None:
    ref = model.state_dict()
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)).to(ref[k].dtype)
         for k, v in state.items()}, strict=True)


def load_jax_prior_params(model: torch.nn.Module, params: Mapping
                          ) -> torch.nn.Module:
    """Copy a flax ``PixelCNN`` / ``PixelSNAIL`` param tree (nested dicts of
    numpy arrays) into the port's prior in place, strictly; returns it."""
    from movae_tpu_torch.models.pixelcnn import PixelSNAIL

    fn = (pixelsnail_state_dict if isinstance(model, PixelSNAIL)
          else pixelcnn_state_dict)
    _load_strict(model, fn(params))
    return model


def load_jax_params(model: MOVAEModel, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> MOVAEModel:
    """Copy a flax param tree (nested dicts of numpy arrays) and its
    batch_stats into ``model`` in place, strictly; returns the model."""
    _load_strict(model, vqvae_state_dict(params, batch_stats))
    return model
