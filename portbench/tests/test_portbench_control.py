"""On the card: each cell's control, the reference computed one precision
below its configuration's in the program's place, fails the cell's
limits. The cells' own readings were taken at the cells' sizes
(``control.py``, PERF.md); this test holds the control at a smaller
batch that a test run can hold."""

import pytest
import torch

from portbench import control, harness, judge

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
CELLS = ["vqvae2-celebahq256.upgrad", "vqvae2-celebahq256.sum",
         "pixelsnail-k512-bf16.grid64"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.workload(name)
    cfg = harness.config(cell["config"])
    if "grid" in cell:
        cell.update(batch_size=32)
    else:
        cfg.update(batch_size=32, train_images=4 * 32)
    for seed in (11, 12):
        read = control.readings(name, CONTROL[cfg["compute_dtype"]], seed,
                                cell, cfg, "cuda")
        assert not judge.verdict(read, cell["limits"]), read
