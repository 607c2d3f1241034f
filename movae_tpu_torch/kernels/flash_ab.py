"""A/B timing of the bfloat16 flash kernels of several builds on one card.

``python -m movae_tpu_torch.kernels.flash_ab --lib parent=DIR/movae_tpu_torch/
kernels/flash_attention.cu`` builds this checkout's ``flash_attention.cu``
and every ``--lib NAME=PATH`` source (the parent commit's, unpacked with
``git archive`` into a gitignored directory, or a variant) for one head
dim, and times each build's forward, dK/dV and dQ kernels on the same
inputs by CUDA-graph replay, the builds in turns (A B B A per round), beside
``scaled_dot_product_attention``'s bf16 forward and the flash backward its
autograd calls (the yardstick; the port never calls either). Every build's
outputs are checked against this checkout's first: the same function, so
within a few bf16 roundings (printed as 17a reads them: rms and best-fit
scale in u = 2^-8, ``scale_rms``), and whether each equals it bit for bit
(largest absolute difference 0), its backward kernels fed both its own
forward's o and lse2 and this checkout's (so that a backward kernel is held
alone where the forwards differ); so is every pair of builds. Also samples
the SM clock and power draw while each of this checkout's kernels replays
back to back. ``--gate B H L D``
also holds each build's dk and dv against float64 on random inputs and on
``sink_inputs`` (long runs of same-signed products a key), beside the
IEEE-summed plain version, and each against the plain version summed on
the tensor cores (:func:`dkv_gate`). Prints the bf16 kernels' ptxas
reports, then one JSON line with the card's name and power limit. Needs a
CUDA card; nothing here runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path
from typing import Dict

import torch

from movae_tpu_torch.kernels import build
from movae_tpu_torch.kernels import flash_attention as fa

KERNELS = ("fwd", "bwd_dkv", "bwd_dq")
PTXAS: Dict[str, str] = {}


def bf16_registers(report: str) -> Dict[str, list]:
    """{bf16 kernel: [registers, spill store bytes, spill load bytes]} from
    one build's ptxas report."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_(?:fwd|bwd_dkv|bwd_dq)_bf16_kernel", line)
            name = m.group(0) if m else None
            if name:
                out[name] = [None, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def compile_libs(srcs: Dict[str, Path], d: int) -> Dict[str, ctypes.CDLL]:
    """Each ``srcs`` entry built as the checkout's flash libraries are (its
    own directory's headers) into ``build/kernels/ab/``, all nvcc jobs
    started together; each build's ptxas report goes to ``PTXAS``."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        out = out_dir / f"lib{name}_d{d}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DMOVAE_FLASH_D={d}",
               "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {srcs[name]}:\n{err}")
        PTXAS[name] = err
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def capture(fn, reps: int):
    """``reps`` calls of ``fn`` captured in one CUDA graph (3 warm-up
    calls on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return graph


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph, replayed 3 times (CUDA events)."""
    graph = capture(fn, reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def clocks_during(fn, reps: int, seconds: float = 2.0) -> Dict[str, float]:
    """The SM clock (MHz) and power draw (W) that nvidia-smi samples every
    100 ms while ``fn`` replays back to back for about ``seconds``: the
    medians of the samples."""
    graph = capture(fn, reps)
    ms = graph_ms(fn, reps) * reps
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(max(1, int(seconds * 1e3 / ms))):
        graph.replay()
    torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate(timeout=60)
    samples = [[float(x) for x in line.split(",")]
               for line in out.strip().splitlines() if "," in line]
    if not samples:
        raise RuntimeError(f"nvidia-smi sampled nothing: {out!r}")
    mhz, watts = (sorted(col)[len(col) // 2] for col in zip(*samples))
    return {"sm_mhz": mhz, "power_w": watts, "samples": len(samples)}


def launchers(lib: ctypes.CDLL, q, k, v, do, scale: float, fed=None
              ) -> Dict:
    """The three kernels of ``lib`` on (q, k, v, do): closures that launch
    into preallocated outputs, and the outputs. The backward kernels read
    ``fed`` = (o, lse2), another build's forward outputs, where given, and
    else this build's forward's."""
    b, h, L, d = q.shape
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    lse2 = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    dev = q.device.index

    def run(name, *args):
        # the current stream at each launch: a graph captures on its own
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"movae_flash_bf16_{name}")(*args, dev, stream)
        if err != 0:
            raise RuntimeError(f"movae_flash_bf16_{name}: cudaError {err}")

    def fwd():
        run("fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse2.data_ptr(), b * h, L, d, scale)

    fwd()
    bo, blse2 = fed if fed is not None else (o, lse2)
    di = (bo.float() * do.float()).sum(-1)

    def dkv():
        run("bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), blse2.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, L, d, scale)

    def dqk():
        run("bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), blse2.data_ptr(), di.data_ptr(), dq.data_ptr(),
            b * h, L, d, scale)

    dkv()
    dqk()
    torch.cuda.synchronize()
    return {"fns": dict(zip(KERNELS, (fwd, dkv, dqk))),
            "out": {"o": o, "dq": dq, "dk": dk, "dv": dv}, "lse2": lse2}


def sdpa_ms(q, k, v, do, scale: float, reps: int):
    """scaled_dot_product_attention's causal bf16 forward, and the aten
    flash backward on that forward's outputs (graph replay)."""
    import torch.nn.functional as F

    with torch.no_grad():
        fwd = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), reps)
        out = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, True, False, scale=scale)
        o, lse, cq, ck, mq, mk, seed, off = out[:8]
        bwd = graph_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, True, seed, off,
                scale=scale), reps)
    return fwd, bwd


def sink_inputs(shape, gen: torch.Generator, alpha: float = 2.0,
                sinks: int = 64):
    """bf16 (q, k, v, do) on which each key's dk and dv sum long runs of
    same-signed products: every query attends about equally to the first
    ``sinks`` keys (their k lie along q's all-positive direction, scaled by
    ``alpha``; the other keys' logits are near 0), q is positive with
    magnitudes spread over several octaves, and do points about one way,
    so that a sink key's ds keeps its sign down all L queries. A sum that
    drifts one way at each add (the tensor core's own accumulator, chained
    over the queries) shows as a scale bias of dk and dv from float64."""
    dev = gen.device
    d = shape[-1]

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    q = randn(*shape).exp()
    k = randn(*shape) * 0.05
    k[..., :sinks, :] = alpha * d ** -0.5 + 0.1 * randn(sinks, d)
    do = randn(d) + 0.05 * randn(*shape)
    return tuple(t.to(torch.bfloat16) for t in (q, k, randn(*shape), do))


def scale_rms(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """The best-fit scale's distance from 1, sum((got - want) want) /
    sum(want^2), and the rms of got - want over want's, both in bf16
    roundings (u = 2^-8), as chip_smoke.py's 17a gate reads them."""
    got, want = got.double(), want.double()
    diff = got - want
    u = 2.0 ** -8
    return {"scale": float((diff * want).sum() / want.square().sum()) / u,
            "rms": float(diff.square().mean().sqrt()
                         / want.square().mean().sqrt()) / u}


def float64_grads(q, k, v, do, scale: float):
    """dk and dv of the dense causal attention in float64 from the bf16
    inputs, two batch rows at a time."""
    parts = []
    for i in range(0, q.shape[0], 2):
        leaves = [t[i:i + 2].double().requires_grad_() for t in (q, k, v)]
        out = fa.dense_causal_attention(*leaves, scale)
        parts.append(torch.autograd.grad(out, leaves[1:],
                                         do[i:i + 2].double()))
        del leaves, out
        torch.cuda.empty_cache()
    return {"dk": torch.cat([p[0] for p in parts]),
            "dv": torch.cat([p[1] for p in parts])}


def dkv_gate(libs: Dict[str, ctypes.CDLL], q, k, v, do) -> Dict:
    """Each build's dk and dv (from its own forward) against float64, beside
    the plain version's summed in IEEE float32 end to end (17a's float64
    half), and each build's largest difference from the plain version fed
    that build's o and lse2 with its products summed on the tensor cores
    (as the kernels sum them)."""
    scale = q.shape[-1] ** -0.5
    f64 = float64_grads(q, k, v, do, scale)
    o_p, lse2_p = fa.plain_fwd_bf16(q, k, v, scale)
    _, dk_p, dv_p = fa.plain_bwd_bf16(q, k, v, o_p, lse2_p, do, scale)
    out = {"plain_ieee": {"dk": scale_rms(dk_p, f64["dk"]),
                          "dv": scale_rms(dv_p, f64["dv"])}}
    del o_p, lse2_p, dk_p, dv_p
    for name, lib in libs.items():
        run = launchers(lib, q, k, v, do, scale)
        got = run["out"]
        res = {key: scale_rms(got[key], f64[key]) for key in ("dk", "dv")}
        _, dk_t, dv_t = fa.plain_bwd_bf16(q, k, v, got["o"], run["lse2"], do,
                                          scale, tensor_cores=True)
        res["max_abs_diff_tc"] = {
            "dk": float((got["dk"].float() - dk_t.float()).abs().max()),
            "dv": float((got["dv"].float() - dv_t.float()).abs().max())}
        out[name] = res
        del run, got, dk_t, dv_t
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lib", action="append", default=[],
                   metavar="NAME=PATH", help="another flash_attention.cu")
    p.add_argument("--shape", type=int, nargs=4, default=(16, 8, 4096, 16),
                   metavar=("B", "H", "L", "D"))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--gate", type=int, nargs=4, default=None,
                   metavar=("B", "H", "L", "D"),
                   help="also hold each build's dk and dv against float64 "
                   "on random and on sink_inputs of this shape (D as "
                   "--shape's)")
    p.add_argument("--alpha", type=float, nargs="+", default=[2.0],
                   help="sink_inputs' alpha, one gate case each")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    shape = tuple(args.shape)
    d = shape[-1]
    libs = {"this": fa._library(d)}
    PTXAS["this"] = build.build_logs.get(f"flash_attention_d{d}",
                                         "(built before this process)")
    libs.update(compile_libs(dict((n, Path(path)) for n, path in (
        spec.split("=", 1) for spec in args.lib)), d))
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    runs = {n: launchers(lib, q, k, v, do, scale) for n, lib in libs.items()}
    outs = {n: {**r["out"], "lse2": r["lse2"]} for n, r in runs.items()}
    ref = outs["this"]

    def max_diff(out):
        return {key: float((out[key].float() - ref[key].float()).abs().max())
                for key in out}

    diff = {n: max_diff(out) for n, out in outs.items()}
    roundings = {n: {key: scale_rms(x, ref[key]) for key, x in out.items()}
                 for n, out in outs.items()}
    # each build's backward kernels on this checkout's o and lse2
    fed = {}
    for n, lib in libs.items():
        out = launchers(lib, q, k, v, do, scale,
                        fed=(ref["o"], ref["lse2"]))["out"]
        fed[n] = max_diff({key: out[key] for key in ("dq", "dk", "dv")})
    equal, equal_fed = ({n: {key: x == 0.0 for key, x in dd.items()}
                         for n, dd in table.items()}
                        for table in (diff, fed))
    pairs = {f"{a}={b}": all(torch.equal(outs[a][key], outs[b][key])
                             for key in outs[a])
             for i, a in enumerate(outs) for b in list(outs)[i + 1:]}
    times: Dict[str, Dict[str, list]] = {
        n: {kern: [] for kern in KERNELS} for n in libs}
    names = list(libs)
    for _ in range(args.rounds):
        for n in names + names[::-1]:
            for kern in KERNELS:
                times[n][kern].append(
                    graph_ms(runs[n]["fns"][kern], args.reps) * 1e3)
    sdpa = [sdpa_ms(q, k, v, do, scale, args.reps) for _ in range(2)]
    clocks = {kern: clocks_during(runs["this"]["fns"][kern], args.reps)
              for kern in KERNELS}
    gate = {}
    if args.gate:
        gshape = tuple(args.gate)
        cases = {"random": tuple(
            torch.randn(gshape, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4))}
        for alpha in args.alpha:
            cases[f"sinks_alpha{alpha:g}"] = sink_inputs(gshape, gen, alpha)
        gate = {"shape": gshape}
        for case, inputs in cases.items():
            gate[case] = dkv_gate(libs, *inputs)
            print(json.dumps({"gate": case, **gate[case]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"ptxas": {n: bf16_registers(r)
                                for n, r in PTXAS.items()}}))
    print(json.dumps({
        "card": smi, "shape": shape, "reps_per_graph": args.reps,
        "us": times, "max_abs_diff_from_this": diff,
        "scale_rms_from_this": roundings,
        "bit_equal_to_this": equal, "all_bit_equal_pairs": pairs,
        "backward_fed_this_forward": {"max_abs_diff_from_this": fed,
                                      "bit_equal_to_this": equal_fed},
        "sdpa_fwd_us": [f * 1e3 for f, _ in sdpa],
        "sdpa_bwd_us": [b * 1e3 for _, b in sdpa],
        "this_clocks_under_load": clocks, "dkv_gate": gate}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
