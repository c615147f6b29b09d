"""Plain reference of a training step of the ``dgrad`` configuration on a
raw-mode batch: the training features (mel of each raw window with its
preemphasis, the frequency and time augmentations as slices, pads and
linear resizes, the row scale and dropout, the delta fits), the network of
``common.Reference`` in training mode (BatchNorm over the batch, dropout
between the biLSTM layers with the step's mask), the PCA-decoded losses with
their dynamic scalers, and Adam.

The step takes the batch as the reader delivered it: the raw windows and the
augmentation knobs it drew. The dropout mask is drawn as the configuration's
step draws it: uniform floats from a generator on the batch's device seeded
with the step's seed, kept below 1 - rate.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .common import Reference, tf32_mode

MAX_EX_TIME, MAX_EX_FEAT, T_OUT = 4, 5, 64
PAD_MODES = ("constant", "reflect")


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of a step, a function of (run seed, step)."""
    return (int(seed) * 1_000_003 + int(step)) % (2 ** 63 - 1)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear resize with half-pixel centres and clamped edges,
    as OpenCV's INTER_LINEAR resizes one axis."""
    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        pos = (i + 0.5) * n_in / n_out - 0.5
        lo = math.floor(pos)
        w = pos - lo
        if lo < 0:
            lo, w = 0, 0.0
        if lo >= n_in - 1:
            lo, w = n_in - 1, 0.0
        m[i, lo] += 1 - w
        m[i, min(lo + 1, n_in - 1)] += w
    return m


def _delta_matrix(n: int, order: int) -> np.ndarray:
    """(n, n) Savitzky-Golay delta of ``order`` over 9 frames, mode interp."""
    from scipy.signal import savgol_filter

    return savgol_filter(np.eye(n), 9, polyorder=order, deriv=order, axis=-1, mode="interp")


class Step:
    """The reference's training state: weights, Adam's moments, the scalers."""

    def __init__(self, hp, state, params: List[str], device, seed: int, dtype=torch.float64,
                 tf32: bool = False, lr: float = 1e-4, betas=(0.9, 0.999), eps: float = 1e-8):
        self.net = Reference(hp, state, device, dtype, tf32)
        self.net.training = True
        self.device, self.dtype, self.tf32, self.seed = torch.device(device), dtype, tf32, seed
        self.params = list(params)
        for k in self.params:
            self.net.w[k].requires_grad_(True)
        self.m = {k: torch.zeros_like(self.net.w[k]) for k in self.params}
        self.v = {k: torch.zeros_like(self.net.w[k]) for k in self.params}
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.scalers = {}
        drop = [o for o in hp["model"]["audio_encoder"]["layers"][9] if isinstance(o, str)
                and o.startswith("dropout=")]
        self.drop_rate = float(drop[0].split("=")[1]) if drop else 0.0
        t = dict(device=self.device, dtype=dtype)
        self.deltas = [torch.as_tensor(_delta_matrix(T_OUT, o), **t) for o in (1, 2)]
        self.pca = {n: (self.net.w[f"{n}_pca.compT"], self.net.w[f"{n}_pca.means"])
                    for n in ("scale", "rotat")}

    # -- features -----------------------------------------------------------
    def features(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        net, g = self.net, self.net.geo
        x = b["raw_wav"].to(self.dtype)
        p = b["preemph"].to(self.dtype)
        et = b["t_idx"].long() - MAX_EX_TIME
        y = torch.cat([x[:, :1], x[:, 1:] - p[:, None] * x[:, :-1]], dim=1)
        # the augmented window starts (4 - et) hops in and keeps its first sample
        start = (MAX_EX_TIME - et) * g.hop
        rows = torch.arange(len(x), device=x.device)
        y[rows, start] = x[rows, start]
        frames = y.unfold(1, g.win, g.hop)[:, :T_OUT + 2 * MAX_EX_TIME] * net.window
        spec = torch.fft.rfft(frames, dim=-1)
        power = (spec.real ** 2 + spec.imag ** 2).to(self.dtype)
        db = 10.0 * torch.log10(torch.clamp(power @ net.mel_fb.T, min=float(np.finfo(np.float32).eps)))
        mel = torch.clamp((db - net.ref_db + net.top_db) / net.top_db, 0.0, 1.0).transpose(1, 2)
        out = []
        n_mels = mel.shape[1]
        for n in range(len(x)):
            e = int(et[n])
            m = mel[n, :, MAX_EX_TIME - e:MAX_EX_TIME - e + T_OUT + 2 * e]
            if m.shape[1] != T_OUT:
                m = m @ torch.as_tensor(resize_matrix(m.shape[1], T_OUT).T, device=m.device,
                                        dtype=m.dtype)
            f = int(b["f_idx"][n])
            ef, lower, trunc, mode = f // 8 - MAX_EX_FEAT, bool(f // 4 % 2), bool(f // 2 % 2), \
                PAD_MODES[f % 2]
            if ef < 0:
                m = m[-ef:] if lower else m[:ef]
            elif ef > 0:
                if lower:
                    m = F.pad(m, (0, 0, ef, 0))
                    m = m[:-ef] if trunc else m
                else:
                    m = F.pad(m[None], (0, 0, 0, ef), mode=mode)[0]
                    m = m[ef:] if trunc else m
            if m.shape[0] != n_mels:
                m = torch.as_tensor(resize_matrix(m.shape[0], n_mels), device=m.device,
                                    dtype=m.dtype) @ m
            m = m * b["feat_scale"][n].to(self.dtype)[:, None]
            if float(b["drop_is_max"][n]) == 0.0:  # the "max" mode changes nothing
                m = m * (1.0 - b["drop_rows"][n].to(self.dtype))[:, None]
            out.append(m)
        feat = torch.stack(out)  # (N, M, T)
        return torch.stack([feat, feat @ self.deltas[0], feat @ self.deltas[1]], -1).transpose(1, 2)

    # -- loss ---------------------------------------------------------------
    def _scaled(self, name: str, loss: torch.Tensor, beta: float = 0.99, eps: float = 1e-8):
        vt, bt = self.scalers.get(name, (0.0, 1.0))
        bt = bt * beta
        vt = beta * vt + (1 - beta) * float(loss.detach()) ** 2
        self.scalers[name] = (vt, bt)
        return loss / (math.sqrt(vt / (1 - bt)) + eps)

    def loss(self, b, step: int) -> torch.Tensor:
        net = self.net
        feat = self.features(b)
        n, t = feat.shape[:2]
        z = net.encode_frames(feat.reshape(n * t, *feat.shape[2:])).reshape(n, t, -1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, step))

        def dropout(x):
            u = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32)
            keep = 1.0 - self.drop_rate
            return torch.where(u < keep, x / keep, torch.zeros_like(x))

        heads = net.suffix(z, b["speaker_id"].long(), between=dropout if self.drop_rate else None)
        terms = []
        for name, k, group in (("scale", "dgrad_3d_scale_coef", 6), ("rotat", "dgrad_3d_rotat_coef", 3)):
            comp, means = self.pca[name]
            pred = heads[name] @ comp.T + means
            true = b[k].to(self.dtype).reshape(n, -1) @ comp.T + means
            if name == "rotat":
                pred, true = torch.exp(pred), torch.exp(true)
            tris = pred.shape[-1] // group
            ploss = (((pred - true) ** 2).sum(-1) / tris).mean()
            h = n // 2
            mloss = ((((pred[h:] - pred[:h]) - (true[h:] - true[:h])) ** 2).sum(-1) / tris * 2).mean()
            terms += [(f"p_{name}", ploss), (f"m_{name}", mloss)]
        return sum(self._scaled(name, value) for name, value in terms)

    def step(self, batch: Dict[str, np.ndarray], step: int):
        """One step on a host batch: (loss, {param: gradient})."""
        b = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in batch.items()}
        with tf32_mode(self.tf32):
            total = self.loss(b, step)
            grads = torch.autograd.grad(total, [self.net.w[k] for k in self.params])
        self.t += 1
        b1, b2 = self.betas
        with torch.no_grad():
            for k, g in zip(self.params, grads):
                self.m[k].mul_(b1).add_((1 - b1) * g)
                self.v[k].mul_(b2).add_((1 - b2) * g * g)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                self.net.w[k].sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return float(total.detach()), dict(zip(self.params, grads))
