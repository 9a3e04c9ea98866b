"""Metrics logging: JSONL scalars (+ optional TensorBoard if available).

A copy of ``mvae_tpu/train/metrics.py`` (the port imports nothing of the
JAX package): the primary sink is an append-only ``metrics.jsonl`` (one
{"step", "time", scalars...} object per line), with a best-effort
TensorBoard writer when ``torch.utils.tensorboard`` can be imported.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, run_dir: str | os.PathLike):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
        self._tb = None
        try:  # optional, best-effort
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(log_dir=str(self.run_dir / "tb"))
        except Exception:
            pass

    def log(self, step: int, scalars: dict, prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            if isinstance(v, (list, tuple)):
                rec[key] = [float(x) for x in v]
                continue  # sequences go to JSONL only, not TB scalars
            if isinstance(v, str):
                rec[key] = v  # status markers etc.: JSONL only
                continue
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
