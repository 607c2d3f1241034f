"""Serving export: self-contained ``torch.export`` inference artifacts —
port of ``movae_tpu/serving.py``.

The inference functions of a trained model (``reconstruct``,
``encode_codes``, ``decode_codes``, ``sample``) are captured by
``torch.export`` with the trained weights as the programs' constants and
saved with ``torch.export.save``, one ``<name>.pt2`` per program beside a
``manifest.json``. ``load_serving`` restores them to callables with
``torch`` and ``movae_tpu_torch.kernels`` alone (the latter registers
``movae::nearest_code``, which the VQ models' exported graphs hold by name
and which launches the nearest-code kernel on the card): no model module,
no checkpoint.

  * ``reconstruct(x_uint8_nhwc)`` casts and normalises in the graph
    (``train/step.py:preprocess_batch``); ``encode_codes`` and
    ``decode_codes`` cover the VQ families (the VQ-VAE-2 takes and returns
    the (top, bottom) pair). All three export with a symbolic batch: any
    batch from 1 up serves.
  * A ``torch.Generator`` cannot enter an exported graph, so every random
    draw of a function is an input of its program, handed to the model as
    its ``noise`` mapping (``models/base.py:draw``). The export records the
    draws (their name, op, shape and bound, in order) by running the
    function once with a ``DrawLog`` as its noise, refuses a graph that
    still draws, and the loaded callable makes the draws with an explicit
    generator and feeds them: ``reconstruct`` with seed 0 on every call
    (as the JAX package's serving passes ``PRNGKey(0)``), ``sample(seed)``
    with the caller's seed.
  * ``sample`` of a VQ model with a trained prior is a loop: one exported
    step of the cached sampler (``models/pixelcnn.py:SamplerStep``: one
    PixelSNAIL pixel with its key/value caches as tensors in and out, or
    one PixelCNN front), its initialisation and, for a hierarchical prior,
    the top-to-bottom condition; the manifest describes the loop (state
    shapes, index tables, draws) and :func:`load_serving` runs it (on the
    card a raster loop replays its step as one captured CUDA graph). The
    live samplers call the same step, so that the artifact and the live model
    draw the same codes from the same noise; sampling runs under cuDNN's
    deterministic algorithms, so that a seed repeats its images.
  * ``quantize="int8"`` stores every Conv, ConvTranspose and Linear weight
    but the codebooks as int8 with a float32 scale per output channel
    (:func:`quantize_params`), dequantized inside the graph; prior weights
    stay float.
  * An artifact runs on the device it was exported for; loading it for
    another raises.
  * ``data_parallel=N`` (the JAX package's SPMD export over an N-device
    mesh) serves ``reconstruct``, ``encode_codes`` and ``decode_codes`` on
    N replicas of their program, each taking batch / N rows (the batch
    must be a multiple of N; the draws are made for the whole batch and
    split with it), so each answer is the single replica's on the whole
    batch. The replicas run on the artifact's device, each on a CUDA
    stream of its own on the card. ``sample`` stays single-device.

Reference parity anchor: the exported functions mirror the reference's
inference surfaces — ``model(images)["recons"]`` (main.py:159),
``net.sample(n, device)`` (vae.py:230-245), ``get_code_indices`` /
``decode_code`` (vq_vae.py:393-423) and prior-driven generation
(main.py:1054-1085).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

import movae_tpu_torch.kernels.nearest_code  # noqa: F401  movae::nearest_code
from movae_tpu_torch.device import (DeviceLike, deterministic_cudnn,
                                    replay_steps, resolve_device)

SUFFIX = ".pt2"
MANIFEST = "manifest.json"
TABLES = ".tables.pt"
FORMAT = "torch.export"
KV_CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": torch.int8}
_QUANT_LAYERS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)
_QUANT_LAYERS_T = (nn.ConvTranspose1d, nn.ConvTranspose2d,
                   nn.ConvTranspose3d)
BATCH = -1  # a draw's axis of the batch, in the manifest


# ---------------------------------------------------------------------------
# weight-only int8 quantization
# ---------------------------------------------------------------------------

def _out_axis(module: nn.Module) -> Optional[int]:
    """The output-channel axis of a weight: 0 for Conv (O, I, kh, kw) and
    Linear (out, in), 1 for ConvTranspose (I, O, kh, kw)."""
    if isinstance(module, _QUANT_LAYERS_T):
        return 1
    if isinstance(module, _QUANT_LAYERS):
        return 0
    return None


def quantize_params(model: nn.Module, exclude: Sequence[str] = ("embedding",)
                    ) -> Dict[str, Any]:
    """Weight-only symmetric int8 quantization of ``model``'s parameters,
    keyed like ``named_parameters()``.

    Every parameter with ndim >= 2 whose name avoids the ``exclude``
    substrings becomes ``{"_q8": int8, "_scale": float32}``: s = max(max|w|
    / 127, 1e-12) per OUTPUT channel, q8 = clip(round(w / s), -127, 127),
    rounding half to even, as the JAX package computes them. The JAX package
    takes the max-abs over every axis but a flax kernel's last; here the
    output axis is the torch layout's (Conv and Linear 0, ConvTranspose 1;
    the scale keeps the weight's rank), so that each dequantized weight
    equals the
    JAX package's, loaded with ``utils/weights.py:load_jax_params``, bit for
    bit. Biases, norm parameters and other 1-D tensors stay float, and so
    do the VQ codebooks ("embedding"): their values drive the discrete
    nearest-code argmin, where quantization error would flip codes rather
    than add bounded output noise."""
    owners = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = mod
    out: Dict[str, Any] = {}
    for name, w in model.named_parameters():
        if w.dim() < 2 or any(e in name for e in exclude):
            out[name] = w.detach()
            continue
        axis = _out_axis(owners[name])
        if axis is None:
            raise ValueError(f"quantize_params: no output-channel axis known "
                             f"for {name} ({type(owners[name]).__name__})")
        w = w.detach().float()
        dims = tuple(d for d in range(w.dim()) if d != axis)
        s = torch.clamp_min(w.abs().amax(dim=dims, keepdim=True) / 127.0,
                            1e-12)
        out[name] = {"_q8": torch.clamp(torch.round(w / s), -127, 127).to(
            torch.int8), "_scale": s}
    return out


def _is_qleaf(v) -> bool:
    return isinstance(v, dict) and "_q8" in v


def dequantize(q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``W ~= q8 * scale``, in float32."""
    return q8.float() * scale


def dequantize_params(qparams: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params`: every quantized leaf becomes
    ``q8 * scale`` (float32), the others pass through."""
    return {n: dequantize(v["_q8"], v["_scale"]) if _is_qleaf(v) else v
            for n, v in qparams.items()}


# ---------------------------------------------------------------------------
# draws: recorded by a first run, inputs of the exported program
# ---------------------------------------------------------------------------

# the random ops a program must not hold: every draw is one of its inputs
_RANDOM_OPS = ("rand", "normal", "uniform", "bernoulli", "multinomial",
               "exponential", "poisson", "dropout")


def make_draw(spec: Dict[str, Any], generator: torch.Generator,
              device: torch.device, batch: Optional[int] = None
              ) -> torch.Tensor:
    """One recorded draw from ``generator``, the batch axis (``BATCH``)
    set to ``batch``; ``then: "gumbel"`` maps uniform draws to standard
    Gumbel noise as ``models/pixelcnn.py:gumbel_noise`` does."""
    shape = [batch if d == BATCH else d for d in spec["shape"]]
    kw = dict(generator=generator, device=device)
    if spec["op"] == "randint":
        out = torch.randint(0, spec["high"], shape, **kw)
    else:
        out = getattr(torch, spec["op"])(shape, **kw)
    if spec.get("then") == "gumbel":
        out = -torch.log(-torch.log(out.clamp_min(torch.finfo(
            out.dtype).tiny)))
    return out


def _check_no_draws(ep, name: str) -> None:
    """A draw the function makes outside its ``noise`` (one no draw site of
    the models takes) would stay in the graph, unseeded: refuse it."""
    ops = sorted({str(n.target) for n in ep.graph.nodes
                  if n.op == "call_function"
                  and any(r in str(n.target) for r in _RANDOM_OPS)})
    if ops:
        raise RuntimeError(f"{name}: the exported graph draws outside its "
                           f"noise inputs: {ops}")


# ---------------------------------------------------------------------------
# the exportable functions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _bound(pairs, tensors):
    """Each ``(module, attribute)`` of ``pairs`` bound to the matching
    tensor for the block (the quantized weights, dequantized in the
    graph)."""
    for (mod, attr), t in zip(pairs, tensors):
        setattr(mod, attr, t)
    try:
        yield
    finally:
        for mod, attr in pairs:
            delattr(mod, attr)


class ServingFn(nn.Module):
    """``fn(model, *inputs, noise=...)`` as a module ``torch.export`` can
    capture: its data inputs first, then one input per recorded draw,
    handed to the model as ``noise`` by name (``draw_names``). With
    ``quantize="int8"`` the model is a copy whose quantized weights are
    int8 buffers of this module with their scales, dequantized at each call
    into the copy's layers, so that the exported program holds the int8
    tensors and not the float ones."""

    def __init__(self, model: nn.Module, fn: Callable, n_data: int,
                 draw_names: Sequence[str] = (),
                 quantize: Optional[str] = None):
        super().__init__()
        self.fn, self.n_data = fn, n_data
        self.draw_names = list(draw_names)
        self.pairs: List[Tuple[nn.Module, str]] = []
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(f"unsupported quantize={quantize!r} "
                                 f"(only 'int8')")
            qparams = quantize_params(model)
            model = copy.deepcopy(model)
            for i, (name, v) in enumerate(qparams.items()):
                if not _is_qleaf(v):
                    continue
                mpath, _, attr = name.rpartition(".")
                mod = model.get_submodule(mpath)
                del mod._parameters[attr]
                self.pairs.append((mod, attr))
                self.register_buffer(f"q8_{i}", v["_q8"])
                self.register_buffer(f"scale_{i}", v["_scale"])
        self.model = model

    def _weights(self) -> List[torch.Tensor]:
        bufs = dict(self.named_buffers(recurse=False))
        return [dequantize(bufs[f"q8_{n[3:]}"], bufs[f"scale_{n[3:]}"])
                for n in bufs if n.startswith("q8_")]

    def forward(self, *inputs):
        data, drawn = inputs[:self.n_data], inputs[self.n_data:]
        with _bound(self.pairs, self._weights()):
            return self.fn(self.model, *data,
                           noise=dict(zip(self.draw_names, drawn)))


class _SamplerInit(nn.Module):
    """A sampler level's state initialisation (the fixed input planes)."""

    def __init__(self, step):
        super().__init__()
        self.step = step

    def forward(self, state: List[torch.Tensor], *condition):
        self.step.init_state(state, condition[0] if condition else None)
        return state[0][:1, :1, :1, :1].clone()


class _Condition(nn.Module):
    """The hierarchical prior's top-to-bottom condition plane."""

    def __init__(self, prior: nn.Module):
        super().__init__()
        self.prior = prior

    def forward(self, z_top: torch.Tensor) -> torch.Tensor:
        return self.prior.condition_from_top(z_top)


class Program:
    """One program to export: ``module(*args)`` with ``dynamic`` the
    dynamic shapes (``torch.export``'s ``dynamic_shapes``)."""

    def __init__(self, module: nn.Module, args: tuple, dynamic=None):
        self.module, self.args, self.dynamic = module, args, dynamic


def _record(fn: Callable, model: nn.Module, args: tuple,
            batch: Optional[int]) -> list:
    """Run ``fn(model, *args, noise=DrawLog)`` once with a seed-0 generator
    behind every draw: the draws' specs, in order, axis 0 marked as the
    batch where it equals ``batch``."""
    from movae_tpu_torch.models.base import DrawLog

    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(0)
    log = DrawLog(gen)
    with torch.no_grad():
        fn(model, *args, noise=log)
    for spec in log.log:
        if batch is not None and spec["shape"] and spec["shape"][0] == batch:
            spec["shape"][0] = BATCH
    return log.log


def _draw_examples(specs: list, device, batch: Optional[int]) -> tuple:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return tuple(make_draw(s, gen, device, batch) for s in specs)


def build_serving_fns(model: nn.Module, *, normalize_inputs: bool = False,
                      prior: Optional[Dict[str, Any]] = None,
                      sample_batch: int = 16, temperature: float = 1.0,
                      image_batch: int = 8,
                      input_size: Optional[int] = None,
                      quantize: Optional[str] = None,
                      kv_cache_dtype: str = "int8") -> Dict[str, Dict]:
    """The serving functions of ``model`` (on its device, weights in it) as
    programs to export: ``{name: {"programs": {file stem: Program},
    "draws": [...], "draw_seed": 0 | "seed", "symbolic_batch": bool,
    "loop": ... (prior-driven sample)}}``.

      * ``reconstruct(x_uint8_nhwc) -> recons`` — every arch.
      * ``encode_codes(x_uint8) -> indices`` and ``decode_codes(indices) ->
        images`` — VQ families; hierarchical models take and return the
        (top, bottom) pair.
      * ``sample(seed) -> images`` — ``sample_batch`` images; for VQ models
        with a trained ``prior`` (``{"model", "hierarchical"}``) the cached
        sampler's loop at ``kv_cache_dtype`` (``f32``, ``bf16`` or
        ``int8``), decoded by ``decode_codes``; otherwise ``model.sample``.

    ``quantize="int8"``: see :class:`ServingFn`."""
    from movae_tpu_torch.models import pixelcnn as pc
    from movae_tpu_torch.train.step import preprocess_batch

    if quantize is not None and quantize != "int8":
        raise ValueError(f"unsupported quantize={quantize!r} (only 'int8')")
    model = model.eval()
    dev = next(model.parameters()).device
    size = int(input_size if input_size is not None
               else getattr(model, "input_size"))
    batch = torch.export.Dim("batch", min=1)
    norm = bool(normalize_inputs)

    def served(name, fn, args, symbolic):
        """``fn(model, *args)`` as the program ``name``: draws recorded,
        the batch symbolic where ``symbolic``."""
        draw_batch = image_batch if symbolic else None
        specs = _record(fn, model, args, draw_batch)
        mod = ServingFn(model, fn, len(args), [d["name"] for d in specs],
                        quantize)
        drawn = _draw_examples(specs, dev, draw_batch)
        dynamic = None
        if symbolic:
            # one entry: ServingFn.forward's varargs
            dynamic = (tuple([{0: batch}] * len(args) + [
                {0: batch} if s["shape"] and s["shape"][0] == BATCH else None
                for s in specs]),)
        return {"programs": {name: Program(mod, tuple(args) + drawn,
                                           dynamic)},
                "draws": specs, "draw_seed": 0 if symbolic else "seed",
                "symbolic_batch": symbolic}

    x_ex = torch.zeros((image_batch, size, size, 3), dtype=torch.uint8,
                       device=dev)
    fns = {"reconstruct": served(
        "reconstruct",
        lambda m, x, noise: m(preprocess_batch(x, norm), train=False,
                              noise=noise)["recons"].float(),
        (x_ex,), True)}

    hierarchical = hasattr(model, "latent_spatial_dim_top")
    is_vq = hasattr(model, "num_embeddings")
    if is_vq:
        if hierarchical:
            st = model.latent_spatial_dim_top
            sb = model.latent_spatial_dim_bottom
            code_ex = (torch.zeros((image_batch, st, st), dtype=torch.int32,
                                   device=dev),
                       torch.zeros((image_batch, sb, sb), dtype=torch.int32,
                                   device=dev))
            fns["encode_codes"] = served(
                "encode_codes", lambda m, x, noise: tuple(
                    c.to(torch.int32) for c in m.get_code_indices_pair(
                        preprocess_batch(x, norm))), (x_ex,), True)
        else:
            s = model.latent_spatial_dim
            code_ex = (torch.zeros((image_batch, s, s), dtype=torch.int32,
                                   device=dev),)
            fns["encode_codes"] = served(
                "encode_codes", lambda m, x, noise: m.get_code_indices(
                    preprocess_batch(x, norm)).to(torch.int32), (x_ex,), True)
        fns["decode_codes"] = served(
            "decode_codes",
            lambda m, *codes, noise: m.decode_code(*codes).float(),
            code_ex, True)

    if prior is not None and is_vq:
        fns["sample"] = _prior_sample(pc, model, prior, sample_batch,
                                      temperature, kv_cache_dtype)
    else:
        fns["sample"] = served(
            "sample",
            lambda m, noise: m.sample(sample_batch, noise=noise).float(), (),
            False)
    return fns


def _level(pc, name: str, prior: nn.Module, batch: int, shape, temperature,
           cache_dtype, condition: Optional[dict] = None) -> Tuple[Dict,
                                                                   Dict]:
    """One prior level of a sample loop: its programs (init, step) and its
    manifest entry."""
    h, w = shape
    raster = not (isinstance(prior, pc.PixelCNN) and pc.wavefront_steps(
        prior.kernel_size, h, w) < h * w)
    step = pc.SamplerStep(prior, batch, h, w, temperature, cache_dtype,
                          raster=raster).eval()
    dev = step.w_in.device
    cols, bounds = step.tables()
    state = step.new_state(None if condition is None
                           else condition["example"])
    # the example step: the widest front (a symbolic axis is traced at a
    # size of 2 or more); a raster step's shapes are all one
    fronts = bounds["t"]
    s = int(np.argmax(fronts[:, 1] - fronts[:, 0])) if not raster else 0
    example_idx = [cols[n][int(bounds[n][s][0]):int(bounds[n][s][1])].to(dev)
                   for n in cols]
    cells = (torch.export.Dim(f"{name}_cells", min=1) if not raster
             else None)
    dyn_idx = [None if cells is None else {0: cells}
               for _ in pc.FRONT_COLUMNS]
    gumbel = torch.zeros((h * w, batch, prior.num_embeddings), device=dev)
    init_args = (state,) + ((condition["example"],)
                            if condition is not None else ())
    programs = {
        f"sample.{name}.init": Program(_SamplerInit(step), init_args),
        f"sample.{name}.step": Program(
            step, (state, example_idx, gumbel),
            ([None] * len(state), dyn_idx, None)),
    }
    entry = {"name": name, "init": f"sample.{name}.init",
             "step": f"sample.{name}.step",
             "state": [[list(s), str(d)] for s, d in step.state_specs()],
             "columns": list(cols), "steps": int(len(bounds["t"])),
             "tables": f"sample.{name}{TABLES}", "noise": f"gumbel_{name}",
             "condition": None if condition is None else condition["entry"],
             "raster": step.raster}
    entry["_tables"] = (cols, bounds)
    return programs, entry


def _sampler_key(prior: nn.Module, batch: int, temperature: float,
                 levels: list, draws: list) -> str:
    """A digest of everything a prior's sampler programs are made of: its
    weights (never quantized), the batch, the temperature and the loop. Two
    artifacts with one key hold the same sampler programs."""
    import hashlib

    h = hashlib.sha256(json.dumps(
        [batch, float(temperature), draws,
         [{k: v for k, v in lvl.items() if k != "_tables"}
          for lvl in levels]], sort_keys=True).encode())
    for name, t in sorted(prior.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _prior_sample(pc, model, prior: Dict[str, Any], batch: int,
                  temperature: float, kv_cache_dtype: str) -> Dict:
    """``sample`` as a loop over the prior's exported sampler steps, the
    codes decoded by ``decode_codes``."""
    pm = prior["model"].eval()
    cache_dtype = KV_CACHE_DTYPES[kv_cache_dtype]
    k = pm.num_embeddings
    if prior.get("hierarchical"):
        st, sb = model.latent_spatial_dim_top, model.latent_spatial_dim_bottom
        top_p, top = _level(pc, "top", pm.prior_top, batch, (st, st),
                            temperature, cache_dtype)
        z_ex = torch.zeros((batch, st, st), dtype=torch.int32,
                           device=next(pm.parameters()).device)
        with torch.no_grad():
            cond = pm.condition_from_top(z_ex)
        bot_p, bottom = _level(pc, "bottom", pm.prior_bottom, batch,
                               (sb, sb), temperature, cache_dtype,
                               {"example": cond,
                                "entry": {"program": "sample.condition",
                                          "args": ["top"]}})
        programs = {**top_p, "sample.condition": Program(_Condition(pm),
                                                         (z_ex,)), **bot_p}
        levels = [top, bottom]
    else:
        s = model.latent_spatial_dim
        programs, lvl = _level(pc, "codes", pm, batch, (s, s), temperature,
                               cache_dtype)
        levels = [lvl]
    draws = [{"name": lvl["noise"], "op": "rand",
              "shape": [int(np.prod(lvl["state"][-1][0][1:])), batch, k],
              "high": None, "then": "gumbel"}
             for lvl in levels]
    return {"programs": programs, "draws": draws, "draw_seed": "seed",
            "symbolic_batch": False,
            "sampler_key": _sampler_key(pm, batch, temperature, levels,
                                        draws),
            "loop": {"levels": levels, "decode": "decode_codes",
                     "prior": type(pm).__name__,
                     "kv_cache_dtype": kv_cache_dtype}}


# ---------------------------------------------------------------------------
# export / load
# ---------------------------------------------------------------------------

def _spec(t) -> Dict[str, Any]:
    return {"shape": [str(d) for d in t.shape], "dtype": str(t.dtype)}


def _export_program(prog: Program, path: str) -> Tuple[int, Any]:
    with torch.no_grad():
        ep = torch.export.export(prog.module, prog.args,
                                 dynamic_shapes=prog.dynamic, strict=False)
    _check_no_draws(ep, os.path.basename(path))
    # the example inputs would be saved with the program: a sampler's state
    # is ~1 GB at full width
    ep.example_inputs = None
    torch.export.save(ep, path)
    return os.path.getsize(path), ep


def _signature(ep) -> Tuple[list, list]:
    """The user inputs' and outputs' shapes (symbols as named by export) and
    dtypes of an exported program."""
    sig = ep.graph_signature
    user_in = set(sig.user_inputs)
    nodes = {n.name: n for n in ep.graph.nodes}
    ins = [_spec(nodes[n].meta["val"]) for n in sig.user_inputs
           if n in user_in and "val" in nodes[n].meta]
    outs = [_spec(nodes[n].meta["val"]) for n in sig.user_outputs
            if n in nodes and "val" in nodes[n].meta]
    return ins, outs


def export_serving(model: nn.Module, out_dir: str, *,
                   data_parallel: int = 1,
                   manifest_extra: Optional[Dict[str, Any]] = None,
                   sampler_from: Optional[str] = None,
                   **build_kwargs) -> Dict[str, Any]:
    """Export the serving surface of ``model`` (on its device, which the
    artifact records) to ``out_dir``: one ``<program>.pt2`` per program
    (``torch.export.save``), each sample loop level's index tables
    (``<level>.tables.pt``) and ``manifest.json``. Returns the manifest.
    ``sampler_from``: an artifact directory whose sampler programs are
    copied instead of exported again where its ``sampler_key`` equals this
    export's (the int8 artifact of a checkpoint whose float32 one exists:
    prior weights are never quantized). ``data_parallel`` N > 1: the
    symbolic-batch functions are served on N replicas (``nr_devices`` in
    the manifest; see the module docstring)."""
    import shutil

    nr = int(data_parallel)
    if nr < 1:
        raise ValueError(f"data_parallel must be >= 1, got {nr}")
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device
    fns = build_serving_fns(model, **build_kwargs)
    other = (load_manifest(sampler_from)["functions"].get("sample", {})
             if sampler_from else {})
    manifest: Dict[str, Any] = {
        "format": FORMAT, "torch_version": torch.__version__,
        "device": str(dev), "platforms": [dev.type],
        "quantize": build_kwargs.get("quantize"),
        "kv_cache_dtype": build_kwargs.get("kv_cache_dtype", "int8"),
        "functions": {}}
    manifest.update(manifest_extra or {})
    for name, fn in fns.items():
        entry = {"symbolic_batch": fn["symbolic_batch"],
                 "nr_devices": nr if fn["symbolic_batch"] else 1,
                 "draws": fn["draws"], "draw_seed": fn["draw_seed"],
                 "programs": {}, "bytes": 0, "export_seconds": 0.0}
        key = fn.get("sampler_key")
        if key is not None:
            entry["sampler_key"] = key
        copy_from = (sampler_from if key is not None
                     and other.get("sampler_key") == key else None)
        for stem, prog in fn["programs"].items():
            t0 = time.perf_counter()
            path = os.path.join(out_dir, stem + SUFFIX)
            if copy_from is not None:
                shutil.copyfile(os.path.join(copy_from, stem + SUFFIX), path)
                nbytes, ep = os.path.getsize(path), None
            else:
                nbytes, ep = _export_program(prog, path)
            secs = time.perf_counter() - t0
            entry["programs"][stem] = {"bytes": nbytes, "seconds": secs,
                                       "copied": copy_from is not None}
            entry["bytes"] += nbytes
            entry["export_seconds"] += secs
            if stem == name:
                entry["in"], entry["out"] = _signature(ep)
        if "loop" in fn:
            loop = fn["loop"]
            for lvl in loop["levels"]:
                cols, bounds = lvl.pop("_tables")
                path = os.path.join(out_dir, lvl["tables"])
                torch.save({"cols": cols, "bounds": {
                    n: torch.from_numpy(np.ascontiguousarray(b))
                    for n, b in bounds.items()}}, path)
                entry["bytes"] += os.path.getsize(path)
            entry["loop"] = loop
            out = manifest["functions"]["decode_codes"]["out"][0]
            entry["in"] = []  # the seed
            entry["out"] = [dict(out, shape=[str(build_kwargs.get(
                "sample_batch", 16))] + out["shape"][1:])]
        manifest["functions"][name] = entry
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def load_manifest(art_dir: str) -> Dict[str, Any]:
    with open(os.path.join(art_dir, MANIFEST)) as f:
        return json.load(f)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


def _module(ep):
    """A sampler program's callable without the per-call checks of its
    inputs' shapes (a forward pre-hook: the loop makes its inputs from the
    manifest, and the checks cost host time at each of thousands of
    steps)."""
    mod = ep.module()
    mod._forward_pre_hooks.clear()
    return mod


class _Loaded:
    """A loaded serving function: its program(s), draws and loop."""

    def __init__(self, art_dir: str, name: str, entry: Dict[str, Any],
                 device: torch.device):
        self.name, self.entry, self.device = name, entry, device
        self.programs = {}
        for stem in entry["programs"]:
            ep = torch.export.load(os.path.join(art_dir, stem + SUFFIX))
            self.programs[stem] = (_module(ep) if "loop" in entry
                                   else ep.module())
        # data_parallel: the further replicas of the program
        nr = int(entry.get("nr_devices", 1))
        self.replicas = [self.programs.get(name)] + [
            torch.export.load(os.path.join(art_dir, name + SUFFIX)).module()
            for _ in range(nr - 1)]
        self.tables = {}
        for lvl in (entry.get("loop") or {}).get("levels", []):
            tab = torch.load(os.path.join(art_dir, lvl["tables"]),
                             weights_only=True)
            cols = {n: c.to(device) for n, c in tab["cols"].items()}
            rows = {n: b.tolist() for n, b in tab["bounds"].items()}
            self.tables[lvl["name"]] = [
                [cols[n][rows[n][s][0]:rows[n][s][1]] for n in lvl["columns"]]
                for s in range(lvl["steps"])]

    def _draws(self, seed: int, batch: Optional[int]) -> list:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return [make_draw(s, gen, self.device, batch)
                for s in self.entry["draws"]]

    def _tensor(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        return t.to(self.device)

    def __call__(self, *args, seed: int = 0, draws: Optional[list] = None):
        """``draws`` (a list in the manifest's order) stands in for the
        generator's draws: the hook through which a caller feeds noise of
        its own."""
        with torch.no_grad():
            if self.entry.get("loop"):
                return self._loop(seed if not args else int(args[0]), draws)
            data = [self._tensor(a) for a in args]
            if self.entry["draw_seed"] != "seed":
                seed = self.entry["draw_seed"]
            if self.name == "sample" and args:
                seed, data = int(args[0]), []
            batch = data[0].shape[0] if data else None
            drawn = (self._draws(seed, batch) if draws is None
                     else [self._tensor(d) for d in draws])
            if len(self.replicas) > 1 and batch is not None:
                return self._replicated(data, drawn)
            return self.programs[self.name](*data, *drawn)

    def _replicated(self, data: list, drawn: list):
        """The batch's rows split into one contiguous block per replica
        (the draws with them), each replica on its block, the answers
        joined in order: the single replica's answer on the whole
        batch."""
        nr = len(self.replicas)
        batch = data[0].shape[0]
        if batch % nr:
            raise ValueError(f"{self.name}: batch {batch} is not a multiple "
                             f"of data_parallel={nr}")
        blocks = [t.chunk(nr) for t in (*data, *drawn)]
        streams = ([torch.cuda.Stream(self.device) for _ in range(nr)]
                   if self.device.type == "cuda" else None)
        outs = []
        for i, replica in enumerate(self.replicas):
            ctx = (torch.cuda.stream(streams[i]) if streams
                   else contextlib.nullcontext())
            if streams:
                streams[i].wait_stream(torch.cuda.current_stream())
            with ctx:
                outs.append(replica(*(b[i] for b in blocks)))
        if streams:
            for st in streams:
                torch.cuda.current_stream().wait_stream(st)
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    def _loop(self, seed: int, draws: Optional[list] = None
              ) -> torch.Tensor:
        loop = self.entry["loop"]
        drawn = (self._draws(seed, None) if draws is None
                 else [self._tensor(d).float() for d in draws])
        noise = dict(zip((d["name"] for d in self.entry["draws"]), drawn))
        codes = {}
        with deterministic_cudnn():
            for lvl in loop["levels"]:
                state = [torch.zeros(s, dtype=_dtype(d), device=self.device)
                         for s, d in lvl["state"]]
                cond = lvl.get("condition")
                extra = ()
                if cond:
                    extra = (self.programs[cond["program"]](
                        *(codes[a] for a in cond["args"])),)
                self.programs[lvl["init"]](state, *extra)
                replay_steps(self.programs[lvl["step"]], state,
                             self.tables[lvl["name"]], noise[lvl["noise"]])
                codes[lvl["name"]] = state[-1]
            return self.decode(*(codes[lvl["name"]]
                                 for lvl in loop["levels"]))


def load_serving(art_dir: str, device: DeviceLike = None
                 ) -> Dict[str, Callable]:
    """Restore an exported serving directory to callables: ``{name:
    fn}``, ``fn(*arrays)`` taking numpy arrays or tensors and returning
    tensors on the artifact's device (``sample(seed)`` an int). Needs only
    ``torch`` and ``movae_tpu_torch.kernels``. ``device`` (default: the
    manifest's) must be the device the artifact was exported for: an
    artifact is never moved quietly."""
    manifest = load_manifest(art_dir)
    exported = torch.device(manifest["device"])
    want = exported if device is None else torch.device(device)
    if want.type != exported.type or (
            want.index is not None and exported.index is not None
            and want.index != exported.index):
        raise ValueError(f"{art_dir}: exported for {exported}, asked to "
                         f"run on {want}; export it again for that device")
    resolve_device(exported.type)
    out: Dict[str, Callable] = {}
    for name, entry in manifest["functions"].items():
        out[name] = _Loaded(art_dir, name, entry, exported)
    if "sample" in out and "decode_codes" in out:
        out["sample"].decode = out["decode_codes"]
    return out


# ---------------------------------------------------------------------------
# checkpoint -> artifact
# ---------------------------------------------------------------------------

CODEBOOK_KEYS = ("vq_layer.embedding.weight", "quantize_t.embedding.weight")


def _model_from_checkpoint(model_path: str, arch: Optional[str],
                           device: DeviceLike = None):
    """Rebuild ``(model on device, args, input_size)`` from a saved ``.pth``
    WITHOUT touching the dataset files: the input size comes from the
    dataset NAME (``data/__init__.py:dataset_input_size``)."""
    from types import SimpleNamespace

    from movae_tpu_torch.data import dataset_input_size
    from movae_tpu_torch.models import get_network
    from movae_tpu_torch.train import checkpoint as ckpt_lib

    dev = resolve_device(device)
    payload = ckpt_lib.load_checkpoint(model_path)
    args = SimpleNamespace(**dict(payload.get("args") or {}))
    if arch is not None:
        # mismatches warn and the checkpoint wins: the saved weights only
        # fit the saved arch (reference evaluate.py:48-59)
        saved_arch = getattr(args, "arch", None)
        if saved_arch is not None and saved_arch.lower() != arch.lower():
            print(f"Warning: checkpoint arch ({saved_arch}) does not match "
                  f"provided arch ({arch}); using the checkpoint arch.")
        else:
            args.arch = arch
    state = payload["model_state_dict"]
    for key in CODEBOOK_KEYS:
        if key in state:
            args.num_embeddings, args.embedding_dim = state[key].shape
            break
    input_size = dataset_input_size(getattr(args, "dataset", "cifar10"))
    model = get_network(input_size, 3, args)
    ckpt_lib.load_module_state(model, payload)
    return model.to(dev).eval(), args, input_size


def export_checkpoint(model_path: str, out_dir: str, *,
                      arch: Optional[str] = None,
                      device: DeviceLike = None,
                      sample_batch: int = 16,
                      with_prior: bool = True,
                      temperature: float = 1.0,
                      data_parallel: int = 1,
                      quantize: Optional[str] = None,
                      kv_cache_dtype: str = "int8",
                      sampler_from: Optional[str] = None) -> Dict[str, Any]:
    """One-call checkpoint -> serving-artifact export (the CLI's): the model
    rebuilt from the checkpoint's args alone, the trained prior beside it
    loaded (``train/prior.py:find_prior``) so that ``sample`` is
    prior-driven, as the training pipeline's generation pass.
    ``sampler_from`` and ``data_parallel``: as :func:`export_serving`'s."""
    if int(data_parallel) < 1:
        raise ValueError(f"data_parallel must be >= 1, got {data_parallel}")
    model, args, input_size = _model_from_checkpoint(model_path, arch,
                                                     device)
    prior = None
    if with_prior and hasattr(model, "num_embeddings"):
        from movae_tpu_torch.train.prior import find_prior
        prior = find_prior(model_path, model, args)
    return export_serving(
        model, out_dir,
        manifest_extra={"arch": getattr(args, "arch", None),
                        "dataset": getattr(args, "dataset", None),
                        "input_size": input_size,
                        "prior": (None if prior is None else
                                  type(prior["model"]).__name__),
                        "source_checkpoint": os.path.abspath(model_path)},
        sampler_from=sampler_from, data_parallel=data_parallel,
        normalize_inputs=bool(getattr(args, "normalize_inputs", False)),
        prior=prior, sample_batch=sample_batch, temperature=temperature,
        input_size=input_size, quantize=quantize,
        kv_cache_dtype=kv_cache_dtype)
