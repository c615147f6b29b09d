"""Checkpoint I/O with rolling retention and best-metric tracking
(counterpart of ``sdfa_tpu/train/checkpoints.py``).

- names ``epoch%04d-step%06d.ckpt`` plus a ``last.ckpt`` copy;
- rolling retention of ``max_nb`` checkpoints (by step);
- ``best-<metric>.ckpt`` with an ``.info`` sidecar on metric improvement;
- payload: epoch, global step, model state, optimizer state, scalers.

Files are written with ``torch.save`` and read back with
``weights_only=True``: a payload holds tensors, numbers, strings, lists and
dicts only.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

log = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"epoch(\d+)-step(\d+)\.ckpt$")


def save_checkpoint(log_dir: str, payload: Dict[str, Any], epoch: int, step: int,
                    max_nb: int = 10) -> str:
    os.makedirs(log_dir, exist_ok=True)
    name = f"epoch{epoch:04d}-step{step:06d}.ckpt"
    path = os.path.join(log_dir, name)
    torch.save(payload, path)
    shutil.copyfile(path, os.path.join(log_dir, "last.ckpt"))
    _prune(log_dir, max_nb)
    log.info("checkpoint saved: %s", name)
    return path


def save_best(log_dir: str, payload: Dict[str, Any], metric_name: str, metric_value: float,
              epoch: int, step: int) -> str:
    path = os.path.join(log_dir, f"best-{metric_name}.ckpt")
    torch.save(payload, path)
    with open(path + ".info", "w") as fp:
        json.dump(dict(metric=metric_name, value=float(metric_value), epoch=epoch, step=step),
                  fp, indent=2)
    return path


def _prune(log_dir: str, max_nb: int):
    found = []
    for name in os.listdir(log_dir):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(2)), name))
    found.sort()
    while len(found) > max_nb:
        _, name = found.pop(0)
        os.remove(os.path.join(log_dir, name))
        log.info("pruned old checkpoint: %s", name)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(log_dir: str) -> Optional[str]:
    last = os.path.join(log_dir, "last.ckpt")
    return last if os.path.exists(last) else None
