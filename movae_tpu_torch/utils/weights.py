"""Load the JAX package's flax parameters into the port's modules.

The JAX package's flax trees come in as nested dicts of numpy arrays; they
are mapped onto the reference-torch ``state_dict`` layout — the layout of
``movae_tpu/utils/torch_export.py:export_torch_state_dict``, of which this is
a self-contained copy for ``vq_vae`` — and loaded strictly. No JAX needed.
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


def load_jax_params(model: MOVAEModel, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> MOVAEModel:
    """Copy a flax param tree (nested dicts of numpy arrays) and its
    batch_stats into ``model`` in place, strictly; returns the model."""
    state = vqvae_state_dict(params, batch_stats)
    ref = model.state_dict()
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)).to(ref[k].dtype)
         for k, v in state.items()}, strict=True)
    return model
