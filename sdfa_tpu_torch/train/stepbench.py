"""Train-step timing harness (counterpart of ``sdfa_tpu/train/stepbench.py``).

``StepEnv`` holds one ``Experiment`` of the ``dgrad`` config on a dataset
root (PCA-coefficient targets) and the reader's first raw-mode batch on the
device, ready to step: a benchmark's train-step fields come from its
``timed_median_s`` (every step synchronized), ``timed_steady_s`` (one
synchronize at the end, the ``Trainer``'s loop shape; ``upload=True`` sends
the batch anew each step through the pinned double buffer, as
``Trainer._fetch_put`` does), ``n_windows`` and ``cost_stats`` (one step's
FLOP and bytes).
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import ops
from .trainer import Experiment, step_seed


class ByteCounter(TorchDispatchMode):
    """Sums, over the aten ops dispatched inside it, the bytes of each op's
    tensor inputs and outputs: every operand read once and every result
    written once, as a kernel's bound counts them. Views and uninitialized
    allocations move nothing and are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket.__name__.startswith("empty")):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out)) if torch.is_tensor(t))
        return out


class StepEnv:
    """One ``Experiment`` + one batch on its device, ready to step.

    The batch is the first of ``DatasetSlidingWindow.raw_batches`` (the
    reader in order, no shuffle), sent through ``Experiment.put_batch``.
    Every step runs at the learning rate and beta1 of the experiment's first
    step (``lr``, ``b1``), as the JAX harness passes them; its dropout seed is
    the ``Trainer``'s ``step_seed`` of the step index."""

    def __init__(self, root: str, log_dir: str, overrides: Optional[dict] = None,
                 device="cuda", seed: int = 1234):
        from ..config import configure
        from ..data import DatasetSlidingWindow
        from ..models import build_model

        ov = dict(trainer=dict(pca_targets=True))
        if overrides:
            ov.update(overrides)
        hp = configure("dgrad", dataset_root=root, overrides=ov)
        train_set = DatasetSlidingWindow(hp, training=True)
        self.exp = Experiment(hp, build_model(hp), log_dir=log_dir, device=device, seed=seed)
        bs = int(hp.trainer.anime_loader.batch_size)
        self.batch_host = next(iter(train_set.raw_batches(bs, shuffle=False)))
        self.batch = self.exp.put_batch(self.batch_host)
        self.n_windows = int(max(len(v) for v in self.batch_host.values() if v.ndim > 0))
        self._step0 = self.exp.step
        self.lr, self.b1 = self.exp.current_lr()
        self.cost_parts: dict = {}  # cost_stats' split by library ops and kernel

    def sync(self, metrics=None) -> None:
        """Completion barrier: a synchronize of the experiment's device, then
        one parameter element read back (it is written by the optimizer's
        last kernel)."""
        if self.exp.device.type == "cuda":
            torch.cuda.synchronize(self.exp.device)
        _ = float(self.exp.params[0].detach().reshape(-1)[0])

    def step(self, step_index: int = 0, batch=None):
        """One train step on the held batch (or ``batch``, already on the
        device); returns the metrics dict, still on the device."""
        self.exp.step = self._step0  # every step at the first step's lr and beta1
        return self.exp.train_step(self.batch if batch is None else batch,
                                   dropout_seed=step_seed(self.exp.seed, step_index))

    def timed_median_s(self, n: int, upload: bool = False) -> float:
        """Median wall seconds a step over ``n`` steps, each synchronized
        (call ``step()`` and ``sync()`` once first, to warm up). ``upload``
        sends the batch anew before each step."""
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            if upload:
                self.batch = self.exp.put_batch(self.batch_host)
            self.sync(self.step())
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    def timed_steady_s(self, n: int, upload: bool = False) -> float:
        """Wall seconds a step over ``n`` back-to-back steps with one
        synchronize at the end: the ``Trainer``'s loop shape. ``upload=True``
        double-buffers the host → device copy as ``Trainer._fetch_put`` does:
        batch k + 1's upload is enqueued right after step k is dispatched, so
        the copy overlaps the step."""
        metrics = None
        nxt = self.exp.put_batch(self.batch_host) if upload else self.batch
        t0 = time.perf_counter()
        for i in range(n):
            cur = nxt
            metrics = self.step(i, batch=cur)
            if upload:
                nxt = self.exp.put_batch(self.batch_host)
        self.sync(metrics)
        return (time.perf_counter() - t0) / n

    def cost_stats(self) -> dict:
        """``{"flops", "bytes"}`` of ONE train step on the held batch: the
        library ops as ``torch.utils.flop_counter.FlopCounterMode`` and
        ``ByteCounter`` count them, plus each hand-written kernel's own count
        (``ops.<kernel>.cost``, the same work its bound in ``chip_smoke.py``
        reckons) for every launch the step makes, which neither counter sees.
        ``cost_parts`` keeps the split: ``library`` and, by kernel, launches,
        flops and bytes. The step is taken and undone: the model, optimizer
        and scaler state and the step counter are restored after it.

        Not comparable with the JAX harness's XLA ``cost_analysis``: XLA counts
        elementwise work as operations and the bytes of fused regions once,
        where the FLOP counter counts only products and convolutions and every
        aten op reads and writes its own operands."""
        from torch.utils.flop_counter import FlopCounterMode

        exp = self.exp
        saved = ({k: v.clone() for k, v in exp.model.state_dict().items()},
                 copy.deepcopy(exp.optimizer.state_dict()), dict(exp.scalers), exp.step)
        flop_mode, byte_mode = FlopCounterMode(display=False), ByteCounter()
        with ops.count_costs() as launches, flop_mode, byte_mode:
            metrics = self.step(0)
        self.sync(metrics)
        exp.model.load_state_dict(saved[0])
        exp.optimizer.load_state_dict(saved[1])
        exp.scalers, exp.step = saved[2], saved[3]
        kernels: dict = {}
        for name, flops, moved in launches:
            k = kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += moved
        self.cost_parts = {"library": {"flops": float(flop_mode.get_total_flops()),
                                       "bytes": float(byte_mode.bytes)},
                           "kernels": kernels}
        parts = [self.cost_parts["library"], *kernels.values()]
        return {"flops": float(sum(p["flops"] for p in parts)),
                "bytes": float(sum(p["bytes"] for p in parts))}
