"""The yardstick's arithmetic: model FLOPs against torch's FlopCounterMode
over the reference, the kernels' operations and bytes, and the reduction
of a trace."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import readers, work
from portbench.reference.pixelsnail import PixelSNAIL
from portbench.reference.vqvae2 import VQVAE2, images_to_input
from portbench.reference.weights import make_weights
from portbench.drivers.common import steady_timeline
from portbench.trace import STEP_RANGE, Trace

VQ = dict(image_size=32, hidden_dims=[16, 32], num_residual_layers=2,
          embedding_dim=8, num_embeddings=16,
          loss_weights={"reconstruction_loss": 1.0, "embedding_loss": 1.0,
                        "commitment_loss": 0.25})
PS = dict(num_embeddings=16, embedding_dim=8, hidden_channels=16,
          num_blocks=2, num_res_blocks=2, num_heads=2, kernel_size=7,
          dropout=0.1)


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def test_vqvae2_forward_flops_match_flop_counter():
    m = VQVAE2(VQ)
    m.load_state_dict(make_weights(m, 1, torch.device("cpu")))
    x = images_to_input(torch.randint(0, 256, (2, 32, 32, 3),
                                      dtype=torch.uint8))
    with torch.no_grad():
        got = _counted(lambda: m.heads(*m.trunk(x), x))
    want = work.vqvae2_forward(dict(VQ, image_size=32), 2)
    assert got == pytest.approx(want["model"] + want["vq"], rel=1e-9)


@pytest.mark.parametrize("grid", [4, 6])
def test_pixelsnail_forward_flops_match_flop_counter(grid):
    m = PixelSNAIL(PS)
    m.load_state_dict(make_weights(m, 2, torch.device("cpu")))
    codes = torch.randint(0, 16, (3, grid, grid))
    with torch.no_grad():
        got = _counted(lambda: m.logits(codes))
    want = work.pixelsnail_forward(PS, 3, grid, grid)
    L, b, heads, hd = grid * grid, 3, 2, 8
    # the counter counts the dense L x L attention; the work counts the
    # causal L(L + 1)/2 pairs
    dense = PS["num_blocks"] * 4.0 * b * heads * L * L * hd
    assert got - dense + want["attention"] == pytest.approx(
        want["model"] + want["attention"], rel=1e-9)


def test_step_flops_are_three_forwards():
    cfg = dict(VQ, image_size=32)
    f = work.vqvae2_forward(cfg, 4)
    assert work.vqvae2_step_flops(cfg, 4) == 3 * f["model"] + f["vq"]
    g = work.pixelsnail_forward(PS, 2, 5, 5)
    assert work.pixelsnail_step_flops(PS, 2, 5, 5) == 3 * (
        g["model"] + g["attention"])


def test_nearest_code_work_counts_products_and_bytes_once():
    n, k, d = 10, 4, 3
    z, cb = torch.randn(n, d), torch.randn(k, d)
    ops, nbytes = work.nearest_code_work(n, k, d)
    # the distances' product and the codebook's squared norms
    assert ops == _counted(lambda: z @ cb.T) + 2 * k * d
    assert nbytes == z.nbytes + cb.nbytes + 4 * n


def test_flash_work_at_a_small_shape():
    b, h, L, d = 2, 3, 5, 4
    w = work.flash_work(b, h, L, d, elem_bytes=2)
    pairs = b * h * L * (L + 1) / 2
    assert w["fwd"][0] == 4 * pairs * d
    assert w["dkv"][0] == 8 * pairs * d and w["dq"][0] == 6 * pairs * d
    mat = 2 * b * h * L * d
    assert w["fwd"][1] == 4 * mat + 4 * b * h * L
    # q, k, v and do in, dk and dv out, the log-sum-exp and di read
    assert w["dkv"][1] == 6 * mat + 8 * b * h * L


def test_bound_is_the_larger_of_operations_and_bytes():
    assert work.bound_seconds((989e12, 0.0), 989e12) == 1.0
    assert work.bound_seconds((0.0, 3.35e12), 989e12) == pytest.approx(1.0)


def _events():
    ev = []

    def op(name, ts, dur, corr, cat="kernel"):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})

    def host(name, ts, dur, cat="cpu_op", tid=1):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "tid": tid})

    host("portbench.range", 0, 50, cat="user_annotation")
    host("aten::copy_", 55, 40)
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 10, "dur": 1, "tid": 1, "args": {"correlation": 1}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 90, "dur": 1, "tid": 1, "args": {"correlation": 2}})
    op("void nearest_code_kernel<64>(float const*)", 100, 30, 1)
    op("gemm", 120, 20, 3)       # overlaps the first
    op("flash_fwd_bf16_kernel<16>", 200, 50, 2)
    op("copy", 260, 10, 4, cat="gpu_memcpy")
    return ev


def test_trace_reduction():
    tr = Trace(_events(), window_s=400e-6)
    assert tr.busy_seconds() == pytest.approx(100e-6)  # 100..140, 200..270
    assert tr.device_seconds(["nearest_code_kernel"]) == pytest.approx(30e-6)
    assert tr.device_seconds(["flash_", "gemm"]) == pytest.approx(70e-6)
    assert tr.range_seconds(["portbench.range"]) == pytest.approx(30e-6)
    assert tr.range_seconds(["aten::copy_"]) == pytest.approx(50e-6)
    top = tr.top_ops(2)
    assert top[0][0].startswith("flash") and len(top) == 2
    gaps = dict(tr.idle_gaps())
    # 140..200 ended by the flash kernel, launched inside aten::copy_
    assert gaps == {"aten::copy_": pytest.approx(60e-6),
                    "unattributed": pytest.approx(10e-6)}


def test_readers_on_a_trace(tmp_path):
    tr = Trace(_events(), window_s=400e-6)
    (tmp_path / "kernels-a.txt").write_text("# a comment\nnearest_code\n")
    (tmp_path / "work.txt").write_text("nearest_code\n")
    ctx = {"trace": tr, "traced_steps": 1, "step_s": 200e-6,
           "busy_s": 100e-6, "window_s": 200e-6, "steady_steps": 1,
           "launches": {"nearest_code": 2},
           "kernel_work": {"nearest_code": [(495e12 * 10e-6, 0.0),
                                            (495e12 * 5e-6, 0.0)]},
           "tensor_peak": 495e12, "step_flops": 495e12 * 50e-6,
           "syncs_per_step": 1.5}
    assert readers.kernel_ms_per_step(ctx, tmp_path) == pytest.approx(0.03)
    # two launches a step of 10 + 5 us each against 30 us spent
    assert readers.roofline_pct(ctx, tmp_path) == pytest.approx(50.0)
    assert readers.idle_pct(ctx, tmp_path) == pytest.approx(50.0)
    assert readers.mfu_pct(ctx, tmp_path) == pytest.approx(25.0)
    # unclamped: a busy time that the stretch cannot hold shows
    assert readers.idle_pct(dict(ctx, busy_s=250e-6), tmp_path) == \
        pytest.approx(-25.0)
    assert readers.idle_pct(dict(ctx, steady_steps=0), tmp_path) is None
    (tmp_path / "kernels-a.txt").write_text("no_such_kernel\n")
    assert readers.kernel_ms_per_step(ctx, tmp_path) is None
    assert readers.roofline_pct(ctx, tmp_path) is None


def _stepped_events():
    """Three optimizer steps marked as :func:`trace.step_marks` marks them
    (host ranges at 0, 300 and 600 us), each step's update launched
    inside its range, the next step's work launched between them."""
    ev = []

    def launch(corr, ts):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": 1,
                   "args": {"correlation": corr}})

    def op(corr, ts, dur):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
                   "dur": dur, "args": {"correlation": corr}})

    for t in (0, 300, 600):
        ev.append({"ph": "X", "cat": "user_annotation", "name": STEP_RANGE,
                   "ts": t, "dur": 20, "tid": 1})
    launch(1, 2), op(1, 30, 20)        # the call's work before step 1 ends
    launch(2, 8), op(2, 45, 25)        # step 1's update ends at 70
    launch(3, 100), op(3, 100, 150)    # step 2's work
    launch(4, 305), op(4, 310, 20)     # step 2's update ends at 330
    launch(5, 350), op(5, 400, 180)    # step 3's work
    launch(6, 605), op(6, 610, 30)     # step 3's update ends at 640
    launch(7, 700), op(7, 700, 50)     # after the last step
    return ev


def test_steady_stretch_is_whole_steps_between_updates():
    tr = Trace(_stepped_events(), window_s=800e-6)
    assert tr.step_ends(STEP_RANGE) == [70, 330, 640]
    start, end, n = tr.steady(STEP_RANGE)
    assert (start, end, n) == (70, 640, 2)
    # 100..250, 310..330, 400..580, 610..640 inside; 45..70 ends at 70
    assert tr.busy_seconds(start, end) == pytest.approx(380e-6)
    t = steady_timeline(tr)
    assert t == {"busy_s": pytest.approx(380e-6),
                 "window_s": pytest.approx(570e-6), "steady_steps": 2}
    assert readers.idle_pct(t, None) == pytest.approx(100 * (1 - 380 / 570))
    one = [e for e in _stepped_events()
           if not (e["name"] == STEP_RANGE and e["ts"] > 0)]
    assert Trace(one, window_s=800e-6).steady(STEP_RANGE) is None
    assert steady_timeline(Trace(one, window_s=800e-6))["steady_steps"] == 0
