"""Export a trained checkpoint to a self-contained serving artifact —
``python -m movae_tpu_torch.export_serving``.

The counterpart of the repo's ``scripts/export_serving.py``: the same
flags, except ``--device`` (``cuda`` by default) in place of
``--platforms``. The artifact directory holds one ``torch.export`` program
per inference function (``reconstruct``, ``encode_codes``,
``decode_codes``; ``sample`` as its sampler's programs) with the trained
weights as constants, and a ``manifest.json``; it loads with ``torch`` and
``movae_tpu_torch.kernels`` alone (``movae_tpu_torch/serving.py:
load_serving``), on the device it was exported for:

    python -m movae_tpu_torch.export_serving \\
        --model_path logs/.../checkpoints/final_checkpoint.pth \\
        --out ./served_model [--quantize int8] [--sample_batch 16]

    # then, to serve:
    #   from movae_tpu_torch.serving import load_serving
    #   fns = load_serving("./served_model")
    #   images = fns["sample"](0)
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", required=True,
                    help="checkpoint .pth (the port's or the reference's)")
    ap.add_argument("--out", required=True, help="artifact output dir")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device the artifact runs on: cuda (default) "
                    "or cpu")
    ap.add_argument("--sample_batch", type=int, default=16,
                    help="static batch of the sample() artifact")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--no_prior", action="store_true",
                    help="skip prior auto-load (uniform-code sample)")
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="serve reconstruct / encode_codes / decode_codes "
                    "on N replicas, each taking batch / N rows (batches a "
                    "multiple of N); sample stays single-device")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="weight-only int8 artifacts: kernels stored as "
                    "int8 + per-output-channel scales, dequantized "
                    "in-graph (VQ codebooks stay float)")
    ap.add_argument("--kv_cache_dtype", default="int8",
                    choices=["f32", "bf16", "int8"],
                    help="PixelSNAIL sampler KV-cache precision baked into "
                    "the sample artifact (int8 = production default; "
                    "f32 = the naive sampler's codes)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    from movae_tpu_torch.serving import export_checkpoint

    manifest = export_checkpoint(
        args.model_path, args.out, arch=args.arch, device=args.device,
        sample_batch=args.sample_batch, with_prior=not args.no_prior,
        temperature=args.temperature, data_parallel=args.data_parallel,
        quantize=args.quantize, kv_cache_dtype=args.kv_cache_dtype)
    print(json.dumps(manifest, indent=2, sort_keys=True))
    print(f"exported {len(manifest['functions'])} functions -> {args.out}")
    return manifest


if __name__ == "__main__":
    main()
