"""Structured metrics: stdout lines, JSONL stream, optional TensorBoard
(the port's own copy of the JAX package's ``utils/metrics.py``).

The reference's only observability is a tqdm loss line every 100 iterations
(main.py:406-407) and its README's aspirational TensorBoard claim (no import
exists — SURVEY.md §5). Here: every metric goes to a machine-readable JSONL
stream and stdout; TensorBoard event files are written when tensorboardX is
importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    def __init__(self, run_dir: str, enable_tensorboard: bool = True):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except ImportError:
                pass
        self._t0 = time.time()

    def log_image(self, step: int, tag: str, image) -> None:
        """Write a render thumbnail into the TensorBoard event stream.

        ``image``: float [H, W, 3] in [0, 1] (HWC). No-op without a TB
        writer — the PNG/mp4 artifacts remain the primary image record.
        """
        if self._tb is None:
            return
        import numpy as np
        img = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
        self._tb.add_image(tag, (img * 255).astype(np.uint8), step,
                           dataformats="HWC")

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        parts = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items() if k not in ("step", "time"))
        print(f"[TRAIN] Iter: {step} {parts}", flush=True)
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
