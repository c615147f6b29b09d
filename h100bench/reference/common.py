"""Plain PyTorch reference of the shipped models' inference: from a clip of
samples to the heads' PCA coefficients of every 60 fps window.

It follows the published description (mel + delta features on the clip's hop
grid, the spectral-gathering encoder, the 2-layer biLSTM, additive attention
over a 3-frame query, the speaker-conditioned heads) with no kernel, cache or
batching of the program, and imports nothing of it. Weights come as the
benchmark's seeded state dict, by name; everything derived from them (weight
norm, the stacked gates, the solver's factorization) is worked out here again.

Precision: float64 by default; ``Reference(..., dtype=torch.float32,
tf32=True)`` is the control, the nearest precision below the configuration's
float32.
"""

from __future__ import annotations

import ast
import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32_mode(on: bool):
    """TF32 on or off for library products and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class Geometry:
    """The hop grid and the 60 fps windows of a clip (the reference's sliding
    windows, each start snapped to the nearest hop)."""

    def __init__(self, hp):
        mel = hp["audio"]["mel"]
        sr = int(hp["audio"]["sample_rate"])
        self.sr = sr
        self.win = int(mel["win_size"] * sr) if isinstance(mel["win_size"], float) else int(mel["win_size"])
        self.hop = int(mel["hop_size"] * sr) if isinstance(mel["hop_size"], float) else int(mel["hop_size"])
        self.frames = int(hp["audio"]["feature"]["sliding_window_frames"])
        self.fps = float(hp["anime"]["fps"])
        self.sliding = self.hop * (self.frames - 1) + self.win

    def n_windows(self, n: int) -> int:
        w = 0
        while (w - 1.0) * self.sr / self.fps + self.sliding <= n + 2 * self.sliding:
            w += 1
        return w

    def first_frames(self, n: int) -> np.ndarray:
        """The first hop-grid frame of every window, the grid starting
        ``sliding`` samples of silence before the clip."""
        out = []
        for w in range(self.n_windows(n)):
            m = math.floor((w - 1.0) * self.sr / self.fps)
            start = m + self.sliding // 2 - self.sliding
            snapped = int(np.round(np.float64(start) / self.hop)) * self.hop
            out.append((snapped + self.sliding) // self.hop)
        return np.asarray(out, np.int64)


def _mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalized triangular filters on the Slaney mel scale."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(f / 1000.0) / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        (200.0 / 3) * m)

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    out = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, c, hi = hz[i], hz[i + 1], hz[i + 2]
        tri = np.maximum(0.0, np.minimum((freqs - lo) / (c - lo), (hi - freqs) / (hi - c)))
        out[i] = tri * 2.0 / (hi - lo)
    return out


class Reference:
    """The network's inference in plain PyTorch. ``coefficients(clip, speaker)``
    gives the heads' outputs of every window of a clip; the decode to vertices
    is the configuration's own module's."""

    def __init__(self, hp: dict, state: Dict[str, torch.Tensor], device,
                 dtype=torch.float64, tf32: bool = False):
        from scipy.signal import savgol_coeffs

        self.hp, self.device, self.dtype, self.tf32 = hp, torch.device(device), dtype, tf32
        self.geo = g = Geometry(hp)
        mel = hp["audio"]["mel"]
        self.preemph = float(mel.get("preemphasis", 0.0) or 0.0)
        self.ref_db, self.top_db = float(mel["ref_db"]), float(mel["top_db"])
        self.n_speakers = int(hp["model"]["speaker_embedding"]["num_speakers"])
        self.layers = hp["model"]["audio_encoder"]["layers"]
        kinds = [spec[0] for spec in self.layers]
        if kinds != ["permute", "conv2d", "pool2d", "conv2d", "pool2d", "conv2d", "freq-lstm",
                     "squeeze", "permute", "lstm", "attn"]:
            raise ValueError(f"the reference follows the shipped encoder, not {kinds}")
        t = dict(device=self.device, dtype=dtype)
        self.window = torch.as_tensor(np.hamming(g.win), **t)
        self.mel_fb = torch.as_tensor(_mel_filters(g.sr, g.win, int(mel["n_mels"]),
                                                   float(mel["fmin"]), float(mel["fmax"])), **t)
        # the delta features' 9-tap Savitzky-Golay fits, applied as dot products
        self.sg = [torch.as_tensor(savgol_coeffs(9, o, deriv=o, use="dot"), **t) for o in (1, 2)]
        self.w = {k: v.detach().to(**t, copy=True) for k, v in state.items()}
        self.encoded_width = self.w["audio_encoder.built_layers_6.proj.kernel"].shape[1]
        self.training = False  # True: BatchNorm over the batch, no score scale at eval

    # -- weights ------------------------------------------------------------
    def _normed(self, prefix: str, axes) -> torch.Tensor:
        """A weight-normed kernel: v / |v| over ``axes``, times g."""
        v, g = self.w[prefix + ".kernel_v"], self.w[prefix + ".kernel_g"]
        norm = v.pow(2).sum(dim=axes, keepdim=True).sqrt()
        shape = [1 if a in axes else v.shape[a] for a in range(v.ndim)]
        return v / norm * g.reshape(shape)

    def _fc_stack(self, prefix: str, specs, x, cond):
        """The output stacks' fully connected layers, each with its
        activation, the speaker condition concatenated where it says so."""
        for i, spec in enumerate(specs):
            opts = dict(o.split("=", 1) for o in spec[3:] if isinstance(o, str) and "=" in o)
            if "cat_condition" in opts:
                x = torch.cat([x, cond], dim=-1)
            p = f"{prefix}.built_layers_{i}"
            x = x @ self._normed(p, (0,)) + self.w[p + ".bias"]
            act = opts.get("act", "linear")
            if act.startswith("lrelu"):
                x = F.leaky_relu(x, float(act.split(":")[1]) if ":" in act else 0.0)
            elif act == "tanh":
                x = torch.tanh(x)
            elif act != "linear":
                raise ValueError(f"activation {act!r}")
        return x

    # -- features -----------------------------------------------------------
    def features(self, clip: np.ndarray, last_frame: int) -> torch.Tensor:
        """(n_frames, n_mels, 3): mel, delta, delta-delta on the hop grid of
        the clip padded with ``sliding`` samples of silence on the left, up to
        ``last_frame`` + 4 (the fits need four frames on each side)."""
        g = self.geo
        n_frames = last_frame + 5
        n = g.win + g.hop * (n_frames - 1)
        sig = torch.zeros(n, dtype=torch.float64)
        body = torch.from_numpy(np.asarray(clip, np.float64))[:max(0, n - g.sliding)]
        sig[g.sliding:g.sliding + len(body)] = body
        if self.preemph:
            sig = torch.cat([sig[:1], sig[1:] - self.preemph * sig[:-1]])
        frames = sig.to(self.device, self.dtype).unfold(0, g.win, g.hop) * self.window
        spec = torch.fft.rfft(frames.double() if self.dtype == torch.float64 else frames, dim=-1)
        power = (spec.real ** 2 + spec.imag ** 2).to(self.dtype)
        mel = power @ self.mel_fb.T
        db = 10.0 * torch.log10(torch.clamp(mel, min=float(np.finfo(np.float32).eps)))
        mel = torch.clamp((db - self.ref_db + self.top_db) / self.top_db, 0.0, 1.0)
        win = mel.unfold(0, 9, 1)  # (T - 8, M, 9): frames t-4 .. t+4 around t = 4 ..
        deltas = [torch.zeros_like(mel) for _ in self.sg]
        for d, c in zip(deltas, self.sg):
            d[4:-4] = win @ c
        return torch.stack([mel] + deltas, dim=-1)

    # -- encoder ------------------------------------------------------------
    def _conv_block(self, prefix: str, x, pool: bool):
        """A frequency conv (kernel along F, same padding) per frame, leaky
        ReLU, then BatchNorm with its running statistics; max pool by 2."""
        k = self._normed(prefix, (1, 2, 3))[..., 0]  # (out, in, kF)
        pad = k.shape[-1] - 1
        x = F.conv1d(F.pad(x, (pad // 2, pad - pad // 2)), k, self.w[prefix + ".bias"])
        x = F.leaky_relu(x, 0.2)
        spec = self.layers[int(prefix.split("_")[-1])]
        bn = [o for o in spec if isinstance(o, str) and o.startswith("batch_norm=")][0]
        eps = float(ast.literal_eval(bn.split("=", 1)[1]).get("eps", 1e-5))
        if self.training:  # the batch's own statistics, over every frame and bin
            mean = x.mean(dim=(0, 2))
            var = x.var(dim=(0, 2), unbiased=False)
        else:
            mean, var = self.w[prefix + ".post_bn.mean"], self.w[prefix + ".post_bn.var"]
        x = ((x - mean[:, None]) / torch.sqrt(var[:, None] + eps)
             * self.w[prefix + ".post_bn.scale"][:, None] + self.w[prefix + ".post_bn.bias"][:, None])
        if pool:
            assert x.shape[-1] % 2 == 0, "an even frequency count pools without padding"
            return F.max_pool1d(x, 2)
        return x

    @staticmethod
    def _lstm_dir(xp, w_hh, reverse: bool):
        """xp (rows, T, 4H) → h (rows, T, H); gates i, f, g, o."""
        rows, steps, _ = xp.shape
        h = xp.new_zeros(rows, w_hh.shape[0])
        c = torch.zeros_like(h)
        out = [None] * steps
        for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
            i, f, gg, o = (xp[:, t] + h @ w_hh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
        return torch.stack(out, dim=1)

    def _bilstm(self, prefix: str, x, layer: int, bias: bool):
        outs = []
        for d, sfx in enumerate((f"_l{layer}", f"_l{layer}_reverse")):
            xp = x @ self.w[prefix + ".w_ih" + sfx]
            if bias:
                xp = xp + self.w[prefix + ".b_ih" + sfx] + self.w[prefix + ".b_hh" + sfx]
            outs.append(self._lstm_dir(xp, self.w[prefix + ".w_hh" + sfx], bool(d)))
        return torch.cat(outs, dim=-1)

    def encode_frames(self, feat: torch.Tensor) -> torch.Tensor:
        """(frames, n_mels, 3) → (frames, 256): the per-frame prefix."""
        x = feat.permute(0, 2, 1)  # (frames, C, F)
        x = self._conv_block("audio_encoder.built_layers_1", x, pool=True)
        x = self._conv_block("audio_encoder.built_layers_3", x, pool=True)
        x = self._conv_block("audio_encoder.built_layers_5", x, pool=False)
        h = self._bilstm("audio_encoder.built_layers_6.lstm", x.transpose(1, 2), 0, bias=True)
        p = "audio_encoder.built_layers_6.proj"
        return h.reshape(len(h), -1) @ self.w[p + ".kernel"] + self.w[p + ".bias"]

    def suffix(self, z: torch.Tensor, speaker: torch.Tensor, between=None) -> Dict[str, torch.Tensor]:
        """Windows of encoded frames (W, T, 256) → the heads' outputs;
        ``between`` (training) is applied between the two biLSTM layers."""
        p = "audio_encoder.built_layers_9"
        x = self._bilstm(p, z, 0, bias=False)
        x = self._bilstm(p, between(x) if between is not None else x, 1, bias=False)
        a = "audio_encoder.built_layers_10"
        radius = int(self.layers[10][4])
        mid = x.shape[1] // 2
        query = x[:, mid - (radius - 1):mid + radius, :]  # (W, 2r - 1, C)
        q = torch.einsum("wkc,ock->wo", query, self.w[a + ".conv_query.kernel"])[:, None]
        score = torch.tanh(q @ self.w[a + ".proj_qry.kernel"] + x @ self.w[a + ".proj_key.kernel"]
                           + self.w[a + ".b"]) @ self.w[a + ".v.kernel"]  # (W, T, 1)
        opts = dict(o.split("=", 1) for o in self.layers[10][5:] if "=" in o)
        scale = 1.0 if self.training else float(opts.get("scale_score_at_eval", 1.0))
        align = torch.softmax(score[..., 0] * scale, dim=-1)
        ctx = torch.einsum("wt,wtc->wc", align, x)
        cond = torch.eye(self.n_speakers, device=ctx.device, dtype=ctx.dtype)[speaker]
        out = self.hp["model"]["output"]
        trunk = self._fc_stack("output_trunk", out["layers"], ctx, cond)
        if "layers_scale" not in out:
            return {"coef": trunk}
        return {"scale": self._fc_stack("scale_head", out["layers_scale"], trunk, cond),
                "rotat": self._fc_stack("rotat_head", out["layers_rotat"], trunk, cond)}

    def coefficients(self, clip: np.ndarray, speaker: int, block: int = 2048):
        """Every window's head outputs for a clip: {head: (W, K)}."""
        with tf32_mode(self.tf32), torch.no_grad():
            f0 = self.geo.first_frames(len(clip))
            idx = torch.from_numpy(f0[:, None] + np.arange(self.geo.frames)[None]).to(self.device)
            feat = self.features(clip, int(f0[-1]) + self.geo.frames - 1)
            z = torch.cat([self.encode_frames(feat[i:i + block])
                           for i in range(0, len(feat), block)])
            spk = torch.full((len(f0),), int(speaker), dtype=torch.long, device=self.device)
            outs = [self.suffix(z[idx[i:i + block]], spk[i:i + block])
                    for i in range(0, len(f0), block)]
            return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
