"""Training observability: JSONL metrics logger + throughput accounting
(port of ``repro.train.metrics``).

Production posture: one append-only JSONL stream per host (restart-safe —
appends resume cleanly), flushed per write; tokens/sec and MFU derived from
the model config. Kept dependency-free (no tensorboard) by design.
"""
from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, flush_every: int = 1):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._n = 0
        self._flush_every = flush_every
        self._t_last = None

    def log(self, step: int, metrics: dict, tokens_per_step: int = 0,
            model_flops_per_step: float = 0.0, peak_flops: float = 197e12,
            num_chips: int = 1):
        now = time.time()
        rec = {"step": step, "time": now}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        if self._t_last is not None:
            dt = now - self._t_last
            if dt > 0:
                if tokens_per_step:
                    rec["tokens_per_s"] = tokens_per_step / dt
                if model_flops_per_step:
                    rec["mfu"] = (model_flops_per_step / dt
                                  / (peak_flops * num_chips))
        self._t_last = now
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._n += 1
            if self._n % self._flush_every == 0:
                self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()


def read_metrics(path: str):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
