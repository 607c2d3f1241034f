"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a tiny size, with one fault planted in the port: a step that
leaves the state unchanged, or a step that sees half its batch and takes
the mean over it. The cells run on one chip, so no exchange between chips
can be left out; a training step produces no token or answer to alter.
"""

import contextlib
from unittest import mock

import pytest
import torch

from portbench import harness
from portbench.tests.test_portbench_reference import tiny_snail, tiny_vq


@contextlib.contextmanager
def state_unchanged_stage1():
    from movae_tpu_torch.train.state import TrainState
    with mock.patch.object(TrainState, "apply_gradients",
                           lambda self, grads, ok=None: None):
        yield


@contextlib.contextmanager
def half_batch_stage1():
    from movae_tpu_torch.train import step as step_mod
    real = step_mod.preprocess_batch
    with mock.patch.object(step_mod, "preprocess_batch",
                           lambda x, n: real(x[: len(x) // 2], n)):
        yield


@contextlib.contextmanager
def state_unchanged_prior():
    from movae_tpu_torch.train.optim import Optimizer
    with mock.patch.object(Optimizer, "step",
                           lambda self, opt, step, ok=None: None):
        yield


@contextlib.contextmanager
def half_batch_prior():
    from movae_tpu_torch.models.pixelcnn import PixelSNAIL
    real = PixelSNAIL.loss_function

    def half(self, codes, *a, **kw):
        return real(self, codes[: len(codes) // 2], *a, **kw)

    with mock.patch.object(PixelSNAIL, "loss_function", half):
        yield


def _run(cell, cfg, patch):
    return harness.run_cell(cell["name"], 2 ** 31 + 3, 0.3, False, 0.0,
                            cell=cell, cfg=cfg, device="cpu", patch=patch)


@pytest.mark.parametrize("agg", ["upgrad", "sum"])
@pytest.mark.parametrize("fault", [state_unchanged_stage1,
                                   half_batch_stage1])
def test_stage1_fault_is_not_correct(agg, fault):
    torch.manual_seed(0)
    cell = harness.workload(f"vqvae2-celebahq256.{agg}")
    res = _run(cell, tiny_vq(), fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [state_unchanged_prior, half_batch_prior])
def test_prior_fault_is_not_correct(fault):
    cell, cfg = tiny_snail()
    res = _run(cell, cfg, fault)
    assert not res["correct"], res["checks"]
