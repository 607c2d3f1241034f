"""Host synchronisations counted by CUDA's sync debug mode — a frozen copy
of ``movae_tpu_torch/bench.py:count_syncs``."""

from __future__ import annotations

import warnings

import torch


def count_syncs(fn, device: torch.device) -> int:
    """Host synchronisations while ``fn()`` runs, as CUDA's sync debug mode
    reports them; 0 off a card."""
    if device.type != "cuda":
        fn()
        return 0
    torch.cuda.synchronize(device)
    # the debug mode's first switch in a process reports a synchronisation
    # of its own: switch it once before counting
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)
