"""Training losses with explicit scaler state (counterpart of
``sdfa_tpu/models/losses.py``).

- ``ploss``: MSE on values; for dgrad face data the 3-wide rotation branch is
  exp()'d first; dgrad losses sum over the last dim then mean; per-sample
  weights; mean over the batch.
- ``mloss`` ("motion"): MSE between adjacent-frame deltas, using the doubled
  batch (first half = frame i, second half = frame i + 1).
- ``ploss_flat`` / ``mloss_flat``: the same on flat (N, L, tris·k) tensors.
- ``eloss``: embedding consistency between adjacent frames.
- ``dynamic_scale``: divide a loss by the bias-corrected RMS EMA of its own
  history (beta 0.99); the state is an explicit ``ScalerState`` carry.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ScalerState(NamedTuple):
    vt: torch.Tensor      # scalar EMA of loss²
    beta_t: torch.Tensor  # scalar running beta^t

    @classmethod
    def init(cls, device="cpu") -> "ScalerState":
        return cls(vt=torch.zeros((), device=device), beta_t=torch.ones((), device=device))


def dynamic_scale(loss: torch.Tensor, state: ScalerState, training: bool, beta: float = 0.99,
                  eps: float = 1e-8, global_loss: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ScalerState]:
    """Divide ``loss`` by the bias-corrected RMS EMA; no gradient flows
    through the scale. Under data parallelism ``global_loss`` is the loss's
    mean over the ranks, detached: the EMA follows it, so that the state and
    the scale are the same on every rank and equal to one process's on the
    global batch."""
    if training:
        loss_ms = torch.mean((loss.detach() if global_loss is None else global_loss) ** 2)
        beta_t = state.beta_t * beta
        vt = beta * state.vt + (1.0 - beta) * loss_ms
        scale = torch.sqrt(vt / (1.0 - beta_t)) + eps
        new_state = ScalerState(vt=vt, beta_t=beta_t)
    else:
        scale = torch.sqrt(state.vt / torch.clamp(1.0 - state.beta_t, min=1e-12)) + eps
        scale = torch.where(state.beta_t >= 1.0, torch.ones_like(scale), scale)  # never updated
        new_state = state
    return torch.mean(loss) / scale, new_state


def _maybe_exp(pred, true, is_dgrad_face_data: bool):
    if is_dgrad_face_data and pred.shape[-1] == 3:
        return torch.exp(pred), torch.exp(true)
    return pred, true


def _reduce(loss: torch.Tensor, is_dgrad: bool) -> torch.Tensor:
    """dgrad: sum the last dim (scale and rotat widths differ), then mean the
    rest down to a per-sample vector."""
    if is_dgrad:
        loss = loss.sum(-1)
    while loss.ndim > 1:
        loss = loss.mean(-1)
    return loss


def ploss(pred, true, weights, *, is_dgrad: bool, is_face_data: bool) -> torch.Tensor:
    p, t = _maybe_exp(pred, true, is_dgrad and is_face_data)
    return torch.mean(_reduce((p - t) ** 2, is_dgrad) * weights)


def mloss(pred, true, weights, *, is_dgrad: bool, is_face_data: bool) -> torch.Tensor:
    bhs = pred.shape[0] // 2
    p, t = _maybe_exp(pred, true, is_dgrad and is_face_data)
    loss = _reduce(((p[bhs:] - p[:bhs]) - (t[bhs:] - t[:bhs])) ** 2, is_dgrad)
    return torch.mean(loss * (weights[bhs:] + weights[:bhs]))


def _flat_mean(sq: torch.Tensor, n_tris: int) -> torch.Tensor:
    """Sum over the k-wide last dim then mean over triangles == flat sum ÷
    n_tris; then mean down to a per-sample vector."""
    per = sq.sum(-1) / n_tris
    while per.ndim > 1:
        per = per.mean(-1)
    return per


def ploss_flat(pred_flat, true_flat, weights, *, group: int,
               exp_values: bool = False) -> torch.Tensor:
    """dgrad PLoss on flat (N, L, tris·group) tensors."""
    p, t = (torch.exp(pred_flat), torch.exp(true_flat)) if exp_values else (pred_flat, true_flat)
    return torch.mean(_flat_mean((p - t) ** 2, pred_flat.shape[-1] // group) * weights)


def mloss_flat(pred_flat, true_flat, weights, *, group: int,
               exp_values: bool = False) -> torch.Tensor:
    bhs = pred_flat.shape[0] // 2
    p, t = (torch.exp(pred_flat), torch.exp(true_flat)) if exp_values else (pred_flat, true_flat)
    sq = ((p[bhs:] - p[:bhs]) - (t[bhs:] - t[:bhs])) ** 2
    per = _flat_mean(sq, pred_flat.shape[-1] // group)
    return torch.mean(per * (weights[bhs:] + weights[:bhs]))


def eloss(evector: torch.Tensor) -> torch.Tensor:
    """Embedding-consistency loss."""
    bhs = evector.shape[0] // 2
    diff = (evector[bhs:] - evector[:bhs]) ** 2
    return torch.mean(diff.sum(dim=1) * 2.0 / torch.mean(evector ** 2))
