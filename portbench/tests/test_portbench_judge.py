"""The comparison's own arithmetic, the cells' weight scaling, the
program tap that records a function's results, and the reference's
witnesses, on the CPU."""

import pytest
import torch

from portbench import control, judge
from portbench.drivers.common import recording
from portbench.reference.weights import scale_leaves
from portbench.tests.test_portbench_reference import tiny_snail


def test_code_mismatch_is_the_share_of_rows_that_differ():
    top, bottom = torch.arange(4), torch.arange(12)
    assert judge.code_mismatch([top, bottom], [top.clone(), bottom.clone()]
                               ) == 0.0
    moved = bottom.clone()
    moved[5] += 1
    assert judge.code_mismatch([top, moved], [top, bottom]) == \
        pytest.approx(1 / 16)
    assert judge.code_mismatch([top, bottom[:6]], [top, bottom]) == 1.0
    assert judge.code_mismatch([top], [top, bottom]) == 1.0


def _side(alpha=None, codes=None):
    p = {"w": torch.ones(3)}
    out = {"losses": [1.0], "grad1": {"w": torch.ones(3)}, "params": p}
    if alpha is not None:
        out["alpha1"] = alpha
    if codes is not None:
        out["codes1"] = codes
    return out


def test_weight_gap_and_code_mismatch_only_where_both_sides_give_them():
    start = {"w": torch.zeros(3)}
    a = torch.tensor([0.2, 0.3, 0.5], dtype=torch.float32)
    r = torch.tensor([0.2, 0.31, 0.49], dtype=torch.float64)
    read = judge.readings(_side(a, [torch.arange(3)]),
                          _side(r, [torch.arange(3)]), start)
    assert read["weight_gap"]["value"] == pytest.approx(0.01 / 0.49,
                                                        rel=1e-6)
    assert read["code_mismatch"]["value"] == 0.0
    read = judge.readings(_side(), _side(r), start)
    assert "weight_gap" not in read and "code_mismatch" not in read


def test_scale_leaves_scales_only_the_named_leaves():
    w = {"a": torch.ones(2), "b": torch.ones(2)}
    out = scale_leaves(w, {"b": 0.25})
    assert torch.equal(out["a"], w["a"])
    assert torch.equal(out["b"], torch.full((2,), 0.25))
    with pytest.raises(KeyError):
        scale_leaves(w, {"c": 2.0})


def test_recording_keeps_the_first_results_and_restores():
    real = judge.code_mismatch
    with recording("portbench.judge:code_mismatch", lambda o: o, 1) as kept:
        judge.code_mismatch([torch.arange(2)], [torch.arange(2)])
        judge.code_mismatch([torch.arange(2)], [torch.ones(2)])
    assert kept == [0.0]
    assert judge.code_mismatch is real


def test_witnesses_on_a_tiny_prior():
    """The float64 witness reads the float32 reference's rounding alone;
    the bf16 witness and the fp8 control read more on the first step."""
    cell, cfg = tiny_snail()
    read = {m: control.readings(cell["name"], m, 7, cell, cfg, "cpu")
            for m in ("fp32", "fp32_math", "fp64", "bf16", "fp8")}
    assert read["fp32"]["grad_gap"]["value"] == 0.0
    assert read["fp32_math"]["grad_gap"]["value"] == 0.0
    assert read["fp64"]["grad_gap"]["value"] < 1e-4
    assert read["fp64"]["loss1_gap"]["value"] < 1e-6
    for m in ("bf16", "fp8"):
        assert read[m]["grad_gap"]["value"] > \
            10 * read["fp64"]["grad_gap"]["value"]
