"""Experiment logging — port of ``movae_tpu/utils/logging.py``.

The same call surface (``log``, ``log_image``, ``set_summary``,
``save_file``, ``finish``) in three modes: real wandb when the package is
importable and ``use_wandb`` is set; otherwise a local JSONL run
(``<save_root>/wandb_local/history.jsonl`` + ``config.json`` +
``summary.json``, the JAX package's files and keys); a no-op without a
``save_dir``. :class:`StepTimer` gives images/s for the bench and the loop.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

try:
    import wandb as _wandb
except Exception:  # pragma: no cover - optional package
    _wandb = None


def _jsonable(d):
    out = {}
    for k, v in d.items():
        n = v.numel() if hasattr(v, "numel") else getattr(v, "size", 2)
        if hasattr(v, "item") and n == 1:
            v = v.item()
        elif hasattr(v, "tolist") and not isinstance(v, (int, float, str)):
            continue  # images and arrays stay out of the local JSONL
        out[k] = v
    return out


class _LocalRun:
    def __init__(self, save_dir: str, config: Dict[str, Any]):
        self.dir = os.path.join(save_dir, "wandb_local")
        os.makedirs(self.dir, exist_ok=True)
        self.summary: Dict[str, Any] = {}
        self._history = open(os.path.join(self.dir, "history.jsonl"), "a")
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(_jsonable(config), f, indent=2, default=str)

    def log(self, data: Dict[str, Any], step: Optional[int] = None):
        rec = dict(_jsonable(data))
        rec["_step"] = step
        rec["_time"] = time.time()
        self._history.write(json.dumps(rec, default=str) + "\n")
        self._history.flush()

    def finish(self):
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(_jsonable(self.summary), f, indent=2, default=str)
        self._history.close()


class ExperimentLogger:
    """wandb-shaped logger with the local JSONL run."""

    def __init__(self, use_wandb: bool, save_dir: Optional[str],
                 config: Optional[Dict[str, Any]] = None,
                 project: str = "mo-vae", entity: Optional[str] = None,
                 name: Optional[str] = None, group: Optional[str] = None,
                 tags=None):
        self.save_dir = save_dir
        self._wb = None
        self._local = None
        if use_wandb and _wandb is not None:
            key = os.getenv("WANDB_API_KEY")
            if key:
                _wandb.login(key=key)
            self._wb = _wandb.init(project=project, entity=entity, name=name,
                                   config=config or {}, dir=save_dir,
                                   group=group, tags=tags)
        elif save_dir:
            self._local = _LocalRun(save_dir, config or {})

    @property
    def active(self) -> bool:
        return self._wb is not None or self._local is not None

    def log(self, data: Dict[str, Any], step: Optional[int] = None):
        if self._wb is not None:
            self._wb.log(data, step=step)
        elif self._local is not None:
            self._local.log(data, step=step)

    def log_image(self, key: str, path: str, step: Optional[int] = None):
        if self._wb is not None:
            self._wb.log({key: _wandb.Image(path)}, step=step)
        elif self._local is not None:
            self._local.log({key: {"image_path": path}}, step=step)

    def set_summary(self, key: str, value: Any):
        if self._wb is not None:
            self._wb.summary[key] = value
        elif self._local is not None:
            self._local.summary[key] = value

    def save_file(self, path: str):
        if self._wb is not None:
            try:
                self._wb.save(path)
            except Exception as e:  # pragma: no cover - wandb side
                print(f"wandb save of {path} failed: {e!r}")

    def finish(self):
        if self._wb is not None:
            self._wb.finish()
        elif self._local is not None:
            self._local.finish()


class StepTimer:
    """Wall-clock throughput over timed spans (one span per epoch; the
    caller ends each span after the device has finished its work)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n_images = 0
        self.n_steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_images: int):
        self.elapsed += time.perf_counter() - self._t0
        self.n_images += n_images
        self.n_steps += 1

    @property
    def images_per_sec(self) -> float:
        return self.n_images / self.elapsed if self.elapsed else 0.0
