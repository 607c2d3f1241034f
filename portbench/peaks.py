"""Published peaks of the card (NVIDIA's H100 data sheet, dense rates
without sparsity), copied from ``chip_smoke.py``'s ``PEAKS``,
``TF32_SXM`` and ``BF16_SXM`` and frozen here.

A share of a peak is stated against the SXM part's published rates, with
the card's power limit beside it. The tensor-core rate of an operand type
is the fastest way the card has to multiply such operands, so no correct
implementation reads above 100% of it.
"""

from __future__ import annotations

# fp32 on the CUDA cores and HBM bytes/s, by part (chip_smoke.py PEAKS)
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12),
         "nvl": (60e12, 3.9e12)}
# dense tensor-core rates of the SXM part, by operand type
TENSOR_PEAK = {"float32": 495e12,   # TF32
               "bfloat16": 989e12}
HBM_BYTES_PER_S = PEAKS["sxm"][1]
