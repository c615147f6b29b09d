"""Feature registry (counterpart of ``sdfa_tpu/audio/features.py``;
reference: saber/data/audio/features/__init__.py:13-73).

A name → function map over the reference's names; ``get_dict`` extracts
several from a config with one argument sub-dict per feature. ``mel``,
``spec`` (and its aliases) and ``deepspeech_spec`` run in torch on the
device of the signal (``audio/dsp.py``); ``lpc`` is a per-frame
Levinson-Durbin loop in float64 numpy on the host. A numpy signal gives
numpy features; a tensor gives tensors on its device.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from ..config import ConfigDict
from . import dsp


def _as_tensor(signal) -> torch.Tensor:
    return signal.float() if torch.is_tensor(signal) else torch.from_numpy(
        np.asarray(signal, np.float32))


def _like(out: torch.Tensor, signal):
    return out if torch.is_tensor(signal) else out.cpu().numpy()


def _mel(signal, sr, **kw):
    kw = dict(kw)
    kw.pop("sr", None)
    preemph = kw.pop("preemphasis", 0.0)
    return _like(dsp.mel_spectrogram(_as_tensor(signal), sr=sr, preemph=preemph, **kw), signal)


def _spec(signal, sr, **kw):
    kw = dict(kw)
    kw.pop("sr", None)
    preemph = kw.pop("preemphasis", 0.0)
    return _like(dsp.spectrogram(_as_tensor(signal), sr=sr, preemph=preemph, **kw), signal)


def _lpc(signal, sr, order=32, win_size=None, hop_size=None, win_fn="hamm",
         preemphasis=0.65, **kw):
    """LPC per frame via autocorrelation + Levinson-Durbin, in float64 on the
    host (reference uses pysptk, saber/data/audio/features/lpc.py:7-77;
    zero-fallback on failure)."""
    host = signal.detach().cpu().numpy() if torch.is_tensor(signal) else signal
    sig = np.asarray(host, np.float64)
    if preemphasis:
        sig = np.append(sig[:1], sig[1:] - preemphasis * sig[:-1])
    win_size, hop_size = int(win_size), int(hop_size)
    n_frames = dsp.num_frames(len(sig), win_size, hop_size)
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(win_size)[None, :]
    frames = sig[idx] * dsp.get_window(win_fn, win_size).astype(np.float64)
    out = np.zeros((len(frames), order + 1), np.float32)
    for i, frame in enumerate(frames):
        try:
            r = np.correlate(frame, frame, mode="full")[len(frame) - 1: len(frame) + order]
            if r[0] <= 0:
                continue
            a = np.zeros(order + 1)
            a[0] = 1.0
            err = r[0]
            for k in range(1, order + 1):
                acc = r[k] + np.dot(a[1:k], r[1:k][::-1])
                lam = -acc / err
                a[1: k + 1] += lam * a[:k][::-1]
                err *= 1.0 - lam * lam
                if err <= 0:
                    raise FloatingPointError
            out[i, 0] = np.log(np.sqrt(max(err, 1e-12)))
            out[i, 1:] = a[1:]
        except FloatingPointError:
            out[i] = 0.0
    out = out.T  # (order+1, frames)
    return torch.from_numpy(np.ascontiguousarray(out)).to(signal.device) if torch.is_tensor(
        signal) else out


def _deepspeech_spec(signal, sr, win_size, hop_size, win_fn="hann",
                     padding=False, normalize=False, preemphasis=0, **kw):
    """log1p magnitude spectrogram (reference features/others.py:6-28)."""
    if normalize:
        raise NotImplementedError("normalize is NotImplemented upstream too")
    sig = dsp.preemphasis(_as_tensor(signal), preemphasis)
    power = dsp.stft_power(sig, int(win_size), int(hop_size), win_fn, padding)
    return _like(torch.log1p(torch.sqrt(torch.clamp(power, min=0.0))), signal)


__support__ = {
    "lpc": _lpc,
    "mel": _mel,
    "mag": _spec,
    "spec": _spec,
    "linear": _spec,
    "spectrogram": _spec,
    "deepspeech_spec": _deepspeech_spec,
}


def get(name: str, signal, sr: int, **kwargs):
    if name not in __support__:
        raise KeyError(f"'{name}' is not supported!")
    kwargs.pop("sr", None)
    return __support__[name](signal, sr, **kwargs)


def size(name: str, args: dict) -> int:
    if name == "lpc":
        return int(args["order"]) + 1
    if name in ("mag", "spec", "linear", "spectrogram", "deepspeech_spec"):
        return int(args["win_size"]) // 2 + 1
    if name == "mel":
        return int(args.get("n_mels", 80))
    raise NotImplementedError(name)


def get_dict(name_list: Iterable[str], signal, args_dict) -> Dict[str, object]:
    if not isinstance(args_dict, ConfigDict):
        args_dict = ConfigDict(args_dict)
    ret = {}
    for name in name_list:
        if name not in __support__:
            raise KeyError(f"'{name}' is not supported!")
        args = args_dict.get(name)
        if args is None:
            raise KeyError(f"audio config has no arg sub-dict for feature '{name}'")
        ret[name] = get(name, signal, int(args_dict["sample_rate"]), **dict(args))
    return ret
