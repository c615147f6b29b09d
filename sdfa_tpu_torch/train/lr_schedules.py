"""Learning-rate schedules (counterpart of ``sdfa_tpu/train/lr_schedules.py``).

Each schedule constructor returns ``(lr_fn, beta1_fn)`` of the iteration counter, as
plain Python functions returning floats; ``mode`` ("step" | "epoch") says
which counter the caller feeds in. NoamZero also ramps Adam's beta1 toward
0.5 during the final decay.
"""

from __future__ import annotations

from typing import Optional


def constant(base_lr: float, **_):
    return (lambda it: float(base_lr)), None


def exp_decay(base_lr: float, gamma: float, start_iter: int = 50000, gap_iters: int = 1,
              min_scale: float = 0.001, **_):
    def fn(it):
        expon = max(float((int(it) - start_iter) // gap_iters), 0.0)
        return base_lr * max(float(gamma) ** expon, min_scale)

    return fn, None


def _noam_scale(cur: float, warm: float) -> float:
    return (warm ** 0.5) * min(cur * (warm ** -1.5), cur ** -0.5)


def noam_decay(base_lr: float, warmup_iters: int, **_):
    def fn(it):
        return base_lr * _noam_scale(max(int(it), 0) + 1.0, float(warmup_iters))

    return fn, None


def noam_zero(base_lr: float, warmup_iters: int, start_ramp: int, total_iters: int,
              base_beta1: float = 0.9, **_):
    if not warmup_iters < start_ramp < total_iters:
        raise ValueError("noam_zero needs warmup_iters < start_ramp < total_iters")

    def ramp_of(it):
        cur = max(int(it), 0) + 1.0
        ramp = (total_iters - cur) / float(total_iters - start_ramp)
        return min(max(ramp, 0.0), 1.0), cur

    def fn(it):
        ramp, cur = ramp_of(it)
        scale = _noam_scale(cur, float(warmup_iters))
        return base_lr * (scale if cur < start_ramp else scale * ramp)

    def beta1_fn(it):
        ramp, cur = ramp_of(it)
        return base_beta1 if cur < start_ramp else base_beta1 * ramp + 0.5 * (1.0 - ramp)

    return fn, beta1_fn


_REGISTRY = {"Constant": constant, "ExpDecay": exp_decay, "NoamDecay": noam_decay,
             "NoamZero": noam_zero}


def build(name: Optional[str], base_lr: float, args: Optional[dict] = None):
    """Returns (lr_fn, beta1_fn, mode)."""
    args = dict(args or {})
    mode = args.pop("mode", "epoch")
    if name is None:
        fn, b1 = constant(base_lr)
    else:
        if name not in _REGISTRY:
            raise ValueError(f"unknown lr scheduler: {name}")
        fn, b1 = _REGISTRY[name](base_lr, **args)
    return fn, b1, mode
