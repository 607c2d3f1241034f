"""Load the JAX package's flax parameters into the port's modules.

The JAX package's flax trees come in as nested dicts of numpy arrays; they
are mapped onto the reference-torch ``state_dict`` layout — the layout of
``movae_tpu/utils/torch_export.py:export_torch_state_dict``, of which this is
a self-contained copy for the VAE family, ``betatc_vae``, ``vq_vae``,
``vq_vae2``, ``pixelcnn``, ``pixelsnail`` and the hierarchical priors — and
loaded strictly. No JAX needed.

The metric towers' converted ``.npz`` files (the layout of
``movae_tpu/metrics/{inception,vgg}.py:convert_torch_weights``) load through
:func:`load_tower_npz`, the inverse of those converters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

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

    def dense(self, tprefix: str, fpath: str) -> None:
        self.state[tprefix + ".weight"] = np.transpose(
            self.take(fpath + "/kernel"))
        self.state[tprefix + ".bias"] = self.take(fpath + "/bias")

    def dense_from_flat(self, tprefix: str, fpath: str, c: int, s: int
                        ) -> None:
        """A dense layer reading a flattened (s, s, c) NHWC map -> a torch
        Linear reading the (c, s, s) NCHW flattening."""
        k = np.transpose(self.take(fpath + "/kernel"))  # (out, s*s*c)
        self.state[tprefix + ".weight"] = k.reshape(
            k.shape[0], s, s, c).transpose(0, 3, 1, 2).reshape(k.shape[0], -1)
        self.state[tprefix + ".bias"] = self.take(fpath + "/bias")

    def dense_to_flat(self, tprefix: str, fpath: str, c: int, s: int
                      ) -> None:
        """A dense layer writing a flattened (s, s, c) map -> a torch
        Linear writing the (c, s, s) flattening."""
        k = np.transpose(self.take(fpath + "/kernel"))  # (s*s*c, in)
        self.state[tprefix + ".weight"] = k.reshape(
            s, s, c, -1).transpose(2, 0, 1, 3).reshape(-1, k.shape[1])
        self.state[tprefix + ".bias"] = self.take(fpath + "/bias").reshape(
            s, s, c).transpose(2, 0, 1).reshape(-1)

    def norm(self, tprefix: str, fpath: str) -> None:
        """BatchNorm (with its running statistics, ``num_batches_tracked``
        0) or LayerNorm: scale -> weight, bias -> bias."""
        self.state[tprefix + ".weight"] = self.take(fpath + "/scale")
        self.state[tprefix + ".bias"] = self.take(fpath + "/bias")
        if fpath + "/mean" in self.stats:
            self.state[tprefix + ".running_mean"] = self.take(fpath + "/mean")
            self.state[tprefix + ".running_var"] = self.take(fpath + "/var")
            self.state[tprefix + ".num_batches_tracked"] = np.zeros(
                (), np.int64)

    def flat_geometry(self, last_conv: str, head: str) -> Tuple[int, int]:
        """(c, s) of the map a dense ``head`` flattens."""
        c = int(self.params[last_conv + "/kernel"].shape[3])
        flat = int(self.params[head + "/kernel"].shape[0])
        return c, int(round((flat // c) ** 0.5))

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


def vae_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                   ) -> Dict[str, np.ndarray]:
    """flax ``vae`` / ``gg_vae*`` / ``cycle_vae`` / ``recursive_kl_vae`` /
    ``recursive_cyclic_vae`` (params, batch_stats) -> reference-torch
    state_dict (numpy values), in the key order of ``_export_vae``, at any
    ``layer_norm``. The anneal counter ``num_iter`` is dropped, as the
    exporter drops it."""
    mp = _Mapper(params, batch_stats)
    H = _count(mp.params, "enc_conv_{}/kernel")
    norm = "enc_norm_0/scale" in mp.params
    c, s = mp.flat_geometry(f"enc_conv_{H - 1}", "mu")
    for i in range(H):
        mp.conv(f"encoder.{i}.0", f"enc_conv_{i}")
        if norm:
            mp.norm(f"encoder.{i}.1", f"enc_norm_{i}")
    mp.dense_from_flat("mu", "mu", c, s)
    mp.dense_from_flat("log_var", "log_var", c, s)
    mp.dense_to_flat("decoder_input", "decoder_input", c, s)
    for i in range(H - 1):
        mp.conv(f"decoder.{1 + i}.0", f"dec_deconv_{i}", transpose=True)
        if norm:
            mp.norm(f"decoder.{1 + i}.1", f"dec_norm_{i}")
    mp.conv("final_layer.0", "final_deconv", transpose=True)
    if norm:
        mp.norm("final_layer.1", "final_norm_0")
    mp.conv("final_layer.3", "final_conv")
    mp.stats.pop("num_iter", None)
    return mp.finish()


def betatc_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                      ) -> Dict[str, np.ndarray]:
    """flax ``betatc_vae`` (params, batch_stats) -> reference-torch
    state_dict (numpy values), in the key order of ``_export_betatc``; the
    anneal counter ``num_iter`` is dropped, as the exporter drops it."""
    mp = _Mapper(params, batch_stats)
    H = _count(mp.params, "enc_conv_{}/kernel")
    c, s = mp.flat_geometry(f"enc_conv_{H - 1}", "fc")
    for i in range(H):
        mp.conv(f"encoder.{i}.0", f"enc_conv_{i}")
    mp.dense_from_flat("fc", "fc", c, s)
    mp.dense("fc_mu", "fc_mu")
    mp.dense("fc_var", "fc_var")
    mp.dense_to_flat("decoder_input", "decoder_input", c, s)
    for i in range(H - 1):
        mp.conv(f"decoder.{i}.0", f"dec_deconv_{i}", transpose=True)
    mp.conv("final_layer.0", "final_deconv", transpose=True)
    mp.conv("final_layer.2", "final_conv")
    mp.stats.pop("num_iter", None)
    return mp.finish()


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
    batch_stats into ``model`` (any model of the registry) in place,
    strictly; returns the model. An anneal counter ``num_iter`` comes from
    ``batch_stats`` (0 when absent)."""
    from movae_tpu_torch.models.betatc_vae import BetaTCVAE
    from movae_tpu_torch.models.vae import VAE
    from movae_tpu_torch.models.vq_vae2 import VQVAE2

    if isinstance(model, VQVAE2):
        state = vqvae2_state_dict(params, batch_stats, ema_stats=model.vq_ema)
    elif isinstance(model, BetaTCVAE):
        state = betatc_state_dict(params, batch_stats)
    elif isinstance(model, VAE):
        state = vae_state_dict(params, batch_stats)
    else:
        state = vqvae_state_dict(params, batch_stats)
    if "num_iter" in model.state_dict():
        state["num_iter"] = np.asarray((batch_stats or {}).get("num_iter", 0),
                                       np.float32)
    _load_strict(model, state)
    return model


def _tower_path(model: torch.nn.Module, key: str
                ) -> Optional[Tuple[str, str]]:
    """A tower ``state_dict`` key -> (flax path in the ``.npz``, kind of
    array: "conv" (OIHW <- HWIO), "dense" (out, in <- in, out) or "same"),
    or None for an entry the file does not carry (``num_batches_tracked``)."""
    from movae_tpu_torch.metrics.vgg import VGG16Features, conv_names

    parts = key.split(".")
    if isinstance(model, VGG16Features):
        name = conv_names()[int(parts[1])]
        if parts[2] == "weight":
            return f"params/{name}/kernel", "conv"
        return f"params/{name}/bias", "same"
    scope = "/".join(parts[:-1])
    if parts[0] == "fc":
        if parts[1] == "weight":
            return "params/fc/kernel", "dense"
        return "params/fc/bias", "same"
    if parts[-2] == "conv":
        return f"params/{scope}/kernel", "conv"
    leaf = {"weight": "params/{}/scale", "bias": "params/{}/bias",
            "running_mean": "batch_stats/{}/mean",
            "running_var": "batch_stats/{}/var"}.get(parts[-1])
    return (leaf.format(scope), "same") if leaf else None


def load_tower_npz(model: torch.nn.Module,
                   path_or_dict: Union[str, Mapping[str, np.ndarray]]
                   ) -> torch.nn.Module:
    """Load a converted tower ``.npz`` (a path, or its entries as a dict)
    into the port's ``InceptionV3`` or ``VGG16Features`` in place, strictly
    (``metrics/pretrained.py:merge_pretrained``); returns the model."""
    from movae_tpu_torch.metrics.pretrained import merge_pretrained

    if isinstance(path_or_dict, Mapping):
        flat, source = dict(path_or_dict), f"{type(model).__name__} weights"
    else:
        with np.load(path_or_dict) as npz:
            flat = {k: npz[k] for k in npz.files}
        source = f"{type(model).__name__} weights {path_or_dict}"
    state = model.state_dict()
    paths = {k: _tower_path(model, k) for k in state}
    paths = {k: v for k, v in paths.items() if v is not None}
    to_flax = {"conv": lambda s: (s[2], s[3], s[1], s[0]),
               "dense": lambda s: (s[1], s[0]), "same": lambda s: s}
    expected = {p: to_flax[kind](tuple(state[k].shape))
                for k, (p, kind) in paths.items()}
    arrays = merge_pretrained(expected, flat, source)
    from_flax = {"conv": lambda a: np.transpose(a, (3, 2, 0, 1)),
                 "dense": np.transpose, "same": lambda a: a}
    new = dict(state)
    for k, (p, kind) in paths.items():
        new[k] = torch.from_numpy(np.ascontiguousarray(
            from_flax[kind](arrays[p]))).to(state[k].dtype)
    model.load_state_dict(new, strict=True)
    return model
