"""Device resolution for the port's entry points, and the step loops that
run on the card."""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises if a CUDA device is asked for and none is
    present: the port never falls back to the CPU on its own.

    Also pins float32 numerics for the process: TF32 is turned off for both
    matmul (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``, which PyTorch enables by default),
    so card results stay comparable with the CPU path and the JAX reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev



@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning; the flags restored
    after. The hierarchical prior's top-to-bottom upsampling and the
    VQ-VAE-2 decoder are transposed convolutions, which cuDNN may otherwise
    run with an algorithm that sums in no fixed order (on an H100, two
    calls on one input part by ~3e-8): enough to flip a Gumbel-max near a
    tie, so that a seed would not repeat its images."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def replay_steps(step: Callable, state: Sequence[torch.Tensor],
                 steps: Sequence[Sequence[torch.Tensor]], *rest) -> None:
    """``step(state, idx, *rest)`` for each ``idx`` of ``steps``, in order;
    ``step`` updates ``state`` in place. On the card, where every ``idx``
    has the first one's shapes (a raster sampler's one pixel a step), the
    first step runs as it is on a side stream (the warm-up) and the second
    is captured in a CUDA graph whose index inputs are static buffers:
    each later step copies its ``idx`` into them and replays the graph, so
    a step costs one replay of host time instead of a launch per operator.
    Elsewhere, or where the shapes vary (a wavefront's fronts), the steps
    run as they are."""
    steps = list(steps)
    shapes = {tuple(tuple(t.shape) for t in idx) for idx in steps}
    if (len(steps) < 3 or len(shapes) > 1
            or not all(t.is_cuda for t in state)):
        for idx in steps:
            step(state, idx, *rest)
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(state, steps[0], *rest)
    torch.cuda.current_stream().wait_stream(side)
    bufs = [t.clone() for t in steps[1]]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(state, bufs, *rest)
    for idx in steps[1:]:
        for b, t in zip(bufs, idx):
            b.copy_(t, non_blocking=True)
        graph.replay()
