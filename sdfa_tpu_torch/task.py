"""AnimationTask, the serving wrapper around the model (counterpart of
``sdfa_tpu/task.py``): offline requests on every wire, ensembling, the exact
per-window path, the device functions of live streaming
(``streaming.StreamingSession`` / ``StreamingServer``) and ``evaluate``, the
evaluation of wav files or dataset sentences into mesh frames and video.

Per request on the overlap path: the clip's frame grid and clip-level
features (frontend), the per-frame encoder prefix once per clip (convs +
FreqLstm kernel), then per window the temporal suffix (2-layer biLSTM kernel,
or the per-layer kernel for a stack of another depth, attention, heads) and,
on the vertex wires, the decode + solve kernel from PCA coefficients to
vertices (dgrad; on a template with triangle correspondences the PCA decode,
the equation gather and the product with P over the equations instead, as
the JAX package routes it), or the PCA product and the template (offsets;
positions without the template). The coefficient wires (dgrad only) stop at the heads:
the client decodes (``streaming.CoefDecoder``).

With ``device_frontend=False`` the per-window features come from the host
(``DatasetSlidingWindow.fetch_audio_features``, numpy) and the request takes
the per-window path.

Shape policy: the clip's frame count is rounded up to a multiple of 256
exactly as the JAX package does (``frame_idx`` and ``ts_list`` are
identical; the extra frames are trailing silence no window reads). The
256-window padding of the window batch existed to bound XLA recompiles and
is dropped: eager PyTorch runs exactly the clip's windows, in chunks of at
most ``MAX_WINDOW_BATCH`` to bound the decode scratch. For the same reason
nothing here is a compiled-function cache: what is kept per task are device
constants (the Δ operators of a block size, the quantized template) and the
pinned host buffer results come down through.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import ops
from .audio import dsp, rms
from .audio import io as audio_io
from .audio.pipeline import (WindowSpec, clip_frame_features_padded, fetch_audio_features_device,
                             mel_from_frames)
from .data.sliding_window import DatasetSlidingWindow
from .models.sdfa import SpeechDrivenAnimation
from .ops.decode_solve import decode_solve_fused, prep_consts
from .ops.deform_solver import solve_fn
from .utils import ArgumentParser
from .viewer import frame as frame_mod

log = logging.getLogger(__name__)

MAX_WINDOW_BATCH = 2048  # decode scratch: 9·10112·4 B ≈ 364 KB per window

# int16 vertex wire: metres per LSB. ±32767 LSB spans ±0.327 m (head
# coordinates stay under 0.3 m) with at most 5e-6 m of quantization error.
WIRE_LSB = 1e-5
# int8-delta wire step: ±127·LSB8 ≈ ±5 mm a frame, 2e-5 m steady-state error,
# no drift (see ``AnimationTask._get_verts_fn_i8d``).
WIRE_LSB8 = 4e-5
WIRES = ("f32", "i16", "i8d", "coef")  # what ``generate_vertices`` takes; servers add "coef16"


def load_dataset_truth(path: str, fps: float) -> Dict:
    """Truth track of a preprocessed sentence directory: {"title", "tslist",
    "data" (F, D)} (the reference's eval_utils._load_source, dataset branch).

    Frames sort by their number: the preprocessing writes negative-numbered
    frames (-00001.npy) when speech starts late, which a lexical sort would
    play out of order; ``tslist`` keeps each frame's real number, so the truth
    track lines up with the audio."""
    frames = sorted((f for f in os.listdir(path) if re.match(r"^-?\d+\.npy$", f)),
                    key=lambda f: int(os.path.splitext(f)[0]))
    frame_ids = [int(os.path.splitext(f)[0]) for f in frames]
    data = np.stack([np.load(os.path.join(path, f)) for f in frames])
    return dict(title="truth", tslist=[fi * 1000.0 / fps for fi in frame_ids], data=data)


class HostBuffer:
    """Device → host copies through one pinned buffer that grows on demand.
    ``start`` enqueues the copy on the current stream and records an event;
    ``finish`` waits for it and returns an array the caller owns. CPU tensors
    pass through untouched."""

    def __init__(self):
        self._buf = None

    def start(self, t: torch.Tensor):
        if t.device.type == "cpu":
            return t, None
        n = t.numel() * t.element_size()
        if self._buf is None or self._buf.numel() < n:
            self._buf = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
        host = self._buf[:n].view(t.dtype).view(t.shape)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        return host, done

    @staticmethod
    def finish(pending) -> np.ndarray:
        host, done = pending
        if done is None:
            return host.numpy()
        done.synchronize()
        return host.numpy().copy()  # the buffer is reused: the caller gets its own array

    def download(self, t: torch.Tensor) -> np.ndarray:
        return self.finish(self.start(t))


def quantize(flat: torch.Tensor, lsb: float) -> torch.Tensor:
    """round(flat / lsb) as the reference computes it in float32: the
    reciprocal as a Python float, rounding half to even. Still float32."""
    return torch.round(flat * (1.0 / lsb))


def delta_steps(q: torch.Tensor, carry: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """The clamped delta recurrence of the int8 wire along dim 0 of q
    (steps, ..., V3) int32: d_t = clip(q_t − carry, ±127), carry += d_t (only
    where ``valid[t]`` (steps, ...) is non-zero, when given). Integer
    arithmetic throughout, so a host mirror that adds the same deltas agrees
    to the bit. Sequential in time: one short loop of tensor ops.
    → (deltas int8, the last carry)."""
    deltas = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    for t in range(q.shape[0]):
        d = (q[t] - carry).clamp_(-127, 127)
        deltas[t] = d
        carry = carry + (d if valid is None else d * valid[t].unsqueeze(-1))
    return deltas, carry


class AnimationTask:
    def __init__(self, hparams, model: SpeechDrivenAnimation, device, batch_windows: int = 100,
                 device_frontend: Optional[bool] = None,
                 overlap_frontend: Optional[bool] = None):
        ops.full_float32()
        self.hp = hparams
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.wspec = WindowSpec(hparams)
        self.bs = int(batch_windows)
        # the device frontend unless the caller asks for the host-numpy one
        # (``DatasetSlidingWindow.fetch_audio_features``, the reference's own
        # per-window features)
        self.device_frontend = device_frontend is None or bool(device_frontend)
        # window-overlap path: the per-frame encoder prefix once per clip, the
        # temporal suffix per window. On with the device frontend whenever the
        # encoder has a usable prefix; ``overlap_frontend=False`` restores exact
        # per-window semantics.
        if overlap_frontend is None:
            overlap_frontend = self.device_frontend
        self.overlap_frontend = bool(overlap_frontend) and model.split > 0
        self._signal_cache: Tuple[Optional[tuple], Optional[tuple]] = (None, None)
        self._decode = None  # dgrad: (solver, DeformConsts, DecodeSolveConsts), built on first use
        self._template = None  # offsets: the template's flat vertices on the device
        self._host = HostBuffer()
        self._stream_fns = {}  # block_frames → (fused_first, fused_steady)
        self._ring_fns = {}    # block_frames → (first_ring, batched_ring)
        self._template_q = None
        self._coef_dec = None

    def _speaker(self, speaker) -> int:
        if isinstance(speaker, str):
            speaker = dict(self.hp.dataset_anime.speakers)[speaker]
        return int(speaker)

    def _spk(self, speaker: int, n: int) -> torch.Tensor:
        return torch.full((n,), int(speaker), dtype=torch.long, device=self.device)

    def _has_coef_heads(self) -> bool:
        return self.hp.model.face_data_type == "dgrad_3d" and \
            bool(self.hp.model.output.get("using_pca", False))

    def _decode_consts(self):
        """(solver, its device constants, the decode + solve kernel's constants)
        of a dgrad model, built on first use: the delta body's on an identity
        equation table, the full body's on a table with triangle
        correspondences. They are None for a model without PCA heads (the
        kernel decodes PCA coefficients): it decodes to planes and takes
        ``solve_fn``."""
        if self.model.face_type != "dgrad_3d":
            raise ValueError("decode + solve constants exist for dgrad_3d models only")
        if self._decode is None:
            solver = frame_mod.get_solver()
            m = self.model
            dsc = None
            if m.using_pca:
                dsc = prep_consts(m.scale_pca.compT.detach(), m.scale_pca.means.detach(),
                                  m.rotat_pca.compT.detach(), m.rotat_pca.means.detach(),
                                  solver, self.device)
            self._decode = (solver, frame_mod.device_consts(self.device), dsc)
        return self._decode

    # -- the exact per-window path ---------------------------------------------
    @torch.inference_mode()
    def feature_to_anime(self, feat_list, speaker_id: int):
        """(W, T, F, C) window features (tensor or array) → (W, D) anime
        frames and ``others``. Runs in chunks of ``batch_windows``, the tail
        chunk padded by repeating its last row, so every call of the model sees
        one batch shape whatever the clip's length."""
        feats = torch.as_tensor(feat_list, dtype=torch.float32).to(self.device)
        animes, zs, aligns = [], [], []
        for i in range(0, len(feats), self.bs):
            chunk = feats[i:i + self.bs]
            keep = len(chunk)
            if keep < self.bs:
                chunk = torch.cat([chunk, chunk[-1:].expand(self.bs - keep, *chunk.shape[1:])])
            preds, z, align = self.model.forward_latent(chunk, self._spk(speaker_id, self.bs))
            animes.append(self._host.download(self.model.decode_to_anime(preds)[:keep, 0]))
            zs.append(self._host.download(z[:keep, 0]))
            if align:
                aligns.append(self._host.download(next(iter(align.values()))[:keep, 0]))
        others = dict(inputs=self._host.download(feats) if len(feats) else None,
                      latent=np.concatenate(zs) if zs else None,
                      latent_align=np.concatenate(aligns) if aligns else None,
                      phones=None, formants=None)
        return np.concatenate(animes).astype(np.float32), others

    # -- the overlap path --------------------------------------------------------
    def _overlap_prefix(self, signal: np.ndarray):
        """Clip-level stage: frame grid (bucketed to 256 frames), features
        and the per-frame encoder prefix → (frame_idx, ts_list, z_frames,
        clip_feat)."""
        signal = np.asarray(signal, np.float32).flatten()
        if signal.size and (signal.min() < -1 or signal.max() > 1):
            raise ValueError("signal must be float audio in [-1, 1]")
        frame_idx, ts_list, pad_l, pad_r, _ = self.wspec.frame_grid(len(signal), bucket=256)
        padded = torch.from_numpy(np.pad(signal, (pad_l, pad_r))).to(self.device)
        clip_feat = clip_frame_features_padded(padded, self.wspec)
        return frame_idx, ts_list, self.model.encode_frames(clip_feat), clip_feat

    @staticmethod
    def _window_chunks(n_windows: int):
        for i in range(0, n_windows, MAX_WINDOW_BATCH):
            yield slice(i, min(i + MAX_WINDOW_BATCH, n_windows))

    @torch.inference_mode()
    def feature_to_anime_overlap(self, signal: np.ndarray, speaker_id: int):
        """Overlap path: the clip-level prefix once, then the windowed suffix
        over all the clip's windows. Returns (tslist, animes (W, D), others)."""
        frame_idx, ts_list, z_frames, clip_feat = self._overlap_prefix(signal)
        idx = torch.from_numpy(frame_idx).long().to(self.device)
        animes, zs, aligns = [], [], []
        for sl in self._window_chunks(len(frame_idx)):
            preds, z, align = self.model.forward_windows(
                z_frames, idx[sl], self._spk(speaker_id, sl.stop - sl.start), raw_pca=True)
            animes.append(self._host.download(self.model.decode_to_anime(preds)[:, 0]))
            zs.append(self._host.download(z[:, 0]))
            if align:
                aligns.append(self._host.download(next(iter(align.values()))[:, 0]))
        others = dict(
            inputs=self._host.download(clip_feat)[frame_idx] if len(frame_idx) else None,
            latent=np.concatenate(zs) if zs else None,
            latent_align=np.concatenate(aligns) if aligns else None,
            phones=None, formants=None)
        return ts_list, np.concatenate(animes).astype(np.float32), others

    def _shifted(self, signal: np.ndarray, ensembling_ms: float) -> np.ndarray:
        """The clip delayed by ``ensembling_ms``: the second run of an ensemble."""
        pad = int(ensembling_ms * self.hp.audio.sample_rate) // 1000
        return np.pad(signal[:-pad], (pad, 0))

    def generate_animation(self, signal: np.ndarray, speaker, emotion=0,
                           ensembling_ms: Optional[float] = None, **_):
        """signal (float in [-1, 1], hp sample rate) → (tslist, animes, others);
        with ``ensembling_ms`` the mean of the clip's run and of a run delayed
        by that much."""
        signal = np.asarray(signal, np.float32).flatten()
        if signal.size and (signal.min() < -1 or signal.max() > 1):
            raise ValueError("signal must be float audio in [-1, 1]")
        speaker = self._speaker(speaker)
        if ensembling_ms is None:
            ensembling_ms = self.hp.get("ensembling_ms", 0)
        ensemble = bool(ensembling_ms and ensembling_ms > 0)

        if self.overlap_frontend:
            tslist, animes, others = self.feature_to_anime_overlap(signal, speaker)
            if ensemble:
                prev = self._shifted(signal, ensembling_ms)
                animes = (animes + self.feature_to_anime_overlap(prev, speaker)[1]) / 2.0
            return tslist, animes, others

        # per-window path: the features of the last signal are kept (on the
        # device, or on the host from the host frontend), keyed on the signal
        # and the ensembling shift
        cache_key = (signal.tobytes(), float(ensembling_ms or 0))
        if self._signal_cache[0] == cache_key:
            features_tuple = self._signal_cache[1]
        else:
            if self.device_frontend:
                def fetch(sig):
                    with torch.inference_mode():
                        return fetch_audio_features_device(sig, self.wspec, self.device)
            else:
                def fetch(sig):
                    return DatasetSlidingWindow.fetch_audio_features(sig, self.hp)
            features_tuple = (fetch(signal),)
            if ensemble:
                features_tuple += (fetch(self._shifted(signal, ensembling_ms)),)
            self._signal_cache = (cache_key, features_tuple)
        anime_sum, others = self.feature_to_anime(features_tuple[0]["audio_feat"], speaker)
        for extra in features_tuple[1:]:
            anime_sum = anime_sum + self.feature_to_anime(extra["audio_feat"], speaker)[0]
        return features_tuple[0]["tslist"], anime_sum / float(len(features_tuple)), others

    # -- vertices ----------------------------------------------------------------
    @torch.inference_mode()
    def generate_vertices(self, signal: np.ndarray, speaker, emotion=0,
                          ensembling_ms: Optional[float] = None, wire: str = "f32"):
        """signal → (tslist, verts (W, V, 3) float32 numpy): decode and solve
        stay on the device and only the wire's payload comes down, through
        pinned memory.

        ``wire="i16"`` downloads vertices quantized on the device to int16 at
        ``WIRE_LSB`` and dequantizes on the host (error ≤ 5e-6 m). ``"i8d"``
        downloads frame 0 as int16 in ``WIRE_LSB8`` units and clamped int8
        deltas after it (drift-free, error ≤ 2e-5 m); its recurrence is one
        device step per frame, so it pays off only where the link is slow.
        ``"coef"`` downloads the (W, 265) PCA coefficients and reconstructs on
        the host with ``streaming.CoefDecoder``. The result is float32 metres
        on every wire.

        Falls back to ``generate_animation`` + ``frames_to_meshes`` when the
        overlap path is off or ensembling is asked for (f32 either way)."""
        if wire not in WIRES:
            raise ValueError(f"unknown wire format {wire!r}")
        if wire == "coef" and not self._has_coef_heads():
            raise ValueError("wire='coef' needs dgrad_3d PCA heads")
        face_type = self.hp.model.face_data_type
        if ensembling_ms is None:
            ensembling_ms = self.hp.get("ensembling_ms", 0)
        if not self.overlap_frontend or (ensembling_ms and ensembling_ms > 0):
            tslist, animes, _ = self.generate_animation(signal, speaker, emotion,
                                                        ensembling_ms=ensembling_ms)
            return tslist, frame_mod.frames_to_meshes(animes, face_type, self.device)[0]

        speaker = self._speaker(speaker)
        frame_idx, ts_list, z_frames, _ = self._overlap_prefix(signal)
        idx = torch.from_numpy(frame_idx).long().to(self.device)
        fn = self._get_verts_fn(wire)
        chunks, carry, q0_host = [], None, None
        for sl in self._window_chunks(len(frame_idx)):
            spk = self._spk(speaker, sl.stop - sl.start)
            if wire == "i8d":
                first = carry is None
                ds, q0, carry = fn(z_frames, idx[sl], spk, carry)
                if first:
                    q0_host = self._host.download(q0).astype(np.int32)
                chunks.append(self._host.download(ds).astype(np.int32))
                continue
            host = self._host.download(fn(z_frames, idx[sl], spk))
            chunks.append(host.astype(np.float32) * WIRE_LSB if wire == "i16" else host)
        n_verts = len(frame_mod.template()[0])
        if not chunks:
            return ts_list, np.zeros((0, n_verts, 3), np.float32)
        if wire == "i8d":
            # the host mirror of the device's integer recurrence: both sides add
            # the transmitted clamped deltas, and row 0's delta is 0, so the
            # running sum lands on q0 exactly
            qs = q0_host[None] + np.cumsum(np.concatenate(chunks), axis=0)
            return ts_list, (qs.astype(np.float32) * WIRE_LSB8).reshape(len(frame_idx), -1, 3)
        if wire == "coef":
            return ts_list, self._coef_decoder().decode(np.concatenate(chunks))
        return ts_list, np.concatenate(chunks).reshape(len(frame_idx), -1, 3)

    def _coef_decoder(self):
        """The client-side ``CoefDecoder`` of this task (the coef wire's host half)."""
        if self._coef_dec is None:
            from .streaming import CoefDecoder

            self._coef_dec = CoefDecoder(self)
        return self._coef_dec

    def warmup(self, seconds: float = 3.0, wire: str = "f32", speaker=0) -> float:
        """Pre-pay the serving path's one-time costs (kernel builds, solver
        constants, the frontend's constants, the host solver factorization of
        the coef wire, allocator warm-up); returns the wall seconds spent."""
        t0 = time.perf_counter()
        sr = int(self.hp.audio.sample_rate)
        tt = np.arange(int(seconds * sr), dtype=np.float32) / sr
        self.generate_vertices((0.1 * np.sin(2 * np.pi * 150.0 * tt)).astype(np.float32),
                               speaker, wire=wire)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _verts_base_fn(self):
        """fn(z_frames, frame_idx, spk) → flat float32 vertices (W, V·3) on the
        device: the suffix, then for dgrad the decode + solve kernel (its
        body by the template's equation table; the decode and ``solve_fn``
        for a model without PCA heads), for the vertex face types the PCA
        product and, for offsets, the template.
        ``z_frames`` is any table of encoded frames (a clip's grid, a session's
        slice, the server's ring)."""
        face_type = self.model.face_type
        if face_type != "dgrad_3d":
            if self._template is None:
                self._template = torch.from_numpy(
                    np.asarray(frame_mod.template()[0], np.float32).reshape(-1)).to(self.device)
            tmpl = self._template if face_type == "verts_off_3d" else None

            def fn(z_frames, frame_idx, spk):
                preds, _, _ = self.model.forward_windows(z_frames, frame_idx, spk, raw_pca=True)
                anime = self.model.decode_to_anime(preds)[:, 0]
                return anime if tmpl is None else anime + tmpl

            return fn
        solver, consts, dsc = self._decode_consts()

        def fn(z_frames, frame_idx, spk):
            preds, _, _ = self.model.forward_windows(z_frames, frame_idx, spk, raw_pca=True)
            if dsc is None:  # no PCA heads: decode, gather, product
                planes = self.model.decode_to_anime(preds, planes=True)[:, 0]
                verts = solve_fn(consts, planes, consts.template_cnst, solver.spec)
            else:
                verts = decode_solve_fused(preds["dgrad_3d_scale_pca"][:, 0].contiguous(),
                                           preds["dgrad_3d_rotat_pca"][:, 0].contiguous(),
                                           dsc, consts, solver.spec, consts.template_cnst)
            return verts.reshape(len(frame_idx), -1)

        return fn

    def _get_verts_fn(self, wire: str = "f32"):
        """The windows → wire payload device function, shared by
        ``generate_vertices`` and the streaming session and server:
        fn(z_frames, frame_idx, spk) → (W, V·3) float32 metres ("f32"), int16 at
        ``WIRE_LSB`` ("i16"), or the raw (W, 85 + 180) PCA coefficients in
        float32 / float16 ("coef" / "coef16": the suffix and the heads only, no
        PCA inversion, no solve). "i8d" is the single-clip delta wire:
        fn(z_frames, frame_idx, spk, carry (V3,) int32, or None for a clip's
        first chunk) → (deltas (W, V3) int8, the chunk's frame 0 as int16 in
        ``WIRE_LSB8`` units, the new carry)."""
        if wire in ("coef", "coef16"):
            if not self._has_coef_heads():
                raise ValueError("the coefficient wire needs dgrad_3d PCA heads (85+180 "
                                 "coefficients); use a vertex wire for face type "
                                 f"{self.hp.model.face_data_type!r}")

            def fn(z_frames, frame_idx, spk):
                preds, _, _ = self.model.forward_windows(z_frames, frame_idx, spk, raw_pca=True)
                out = torch.cat([preds["dgrad_3d_scale_pca"][:, 0],
                                 preds["dgrad_3d_rotat_pca"][:, 0]], dim=-1)
                return out.to(torch.float16) if wire == "coef16" else out

            return fn
        base = self._verts_base_fn()
        if wire == "f32":
            return base
        if wire == "i16":
            return lambda z_frames, frame_idx, spk: quantize(
                base(z_frames, frame_idx, spk), WIRE_LSB).clamp_(-32767, 32767).to(torch.int16)
        if wire == "i8d":
            # frame 0 crosses absolute (a clip's first frame can sit further
            # than 127 steps from the template); the carry stays on the device
            # between window chunks

            def fn(z_frames, frame_idx, spk, carry):
                q = quantize(base(z_frames, frame_idx, spk), WIRE_LSB8).to(torch.int32)
                deltas, carry = delta_steps(q, q[0] if carry is None else carry)
                return deltas, q[0].to(torch.int16), carry  # |q0| ≤ 0.33 m / LSB8 < 32767

            return fn
        raise ValueError(f"unknown wire format {wire!r}")

    def _get_verts_fn_i8d(self):
        """(fn, template_q) of the server's int8 delta wire.

        fn(z_frames, frame_idx (n·E, F), spk (n·E,), lastq (n, V3) int32, valid
        (n, E) int32) → (deltas (n, E, V3) int8, the new lastq). Each of the n
        slots' E rows are consecutive frames of one stream, so frame k crosses
        as clip(round(v_k / LSB8) − carry, ±127) with the carry advanced by the
        clamped delta: the device carry and the host mirror run the same
        integer recurrence and never drift apart. A clamped step (more than
        5 mm between two frames) corrects itself at 5 mm a frame. Rows with
        ``valid`` 0 (padding) emit bytes but advance no state. ``template_q``
        (V3,) int32 is what both ends re-base a slot's carry on when a stream
        opens, so no key frame ever crosses the wire."""
        if self._template_q is None:
            self._template_q = np.round(
                np.asarray(frame_mod.template()[0], np.float64).reshape(-1) / WIRE_LSB8
            ).astype(np.int32)
        base = self._verts_base_fn()

        def fn(z_frames, frame_idx, spk, lastq, valid):
            n, e = valid.shape
            q = quantize(base(z_frames, frame_idx, spk), WIRE_LSB8).to(torch.int32)
            deltas, lastq = delta_steps(q.reshape(n, e, -1).transpose(0, 1), lastq,
                                        valid.transpose(0, 1))
            return deltas.transpose(0, 1).contiguous(), lastq

        return fn, self._template_q

    # -- streaming: the block functions -------------------------------------------
    def _band_ops(self, block_frames: int):
        """Band-structured Savitzky-Golay Δ / Δ² operators of one streaming
        block: band_ops(first) → (K1, K2, center0, n_out), the (B + 8, n_out)
        matrices applied to the mel context with its 8-frame carry. Their
        columns are the interior 9-tap kernel of the offline
        ``dsp.delta_matrix`` (it does not depend on T), with the offline
        operator's edge fits for frames 0..3 in the first-block variant."""
        B, width = int(block_frames), 9
        d1m, d2m = dsp.delta_matrix(4 * width, 1), dsp.delta_matrix(4 * width, 2)
        c = 2 * width
        k1, k2 = d1m[c - 4:c + 5, c], d2m[c - 4:c + 5, c]  # (9,)
        e1, e2 = d1m[:width, :4], d2m[:width, :4]          # (9, 4)

        def band_ops(first: bool):
            n_out = B - 4 if first else B
            K1 = np.zeros((B + 8, n_out), np.float32)
            K2 = np.zeros((B + 8, n_out), np.float32)
            o = 8 if first else 4
            for j in range(n_out):
                if first and j < 4:  # frames 0..3: the edge fit, rows 8..16 ↔ frames 0..8
                    K1[8:17, j], K2[8:17, j] = e1[:, j], e2[:, j]
                else:  # output j ↔ context rows [j + o − 4, j + o + 5)
                    K1[j + o - 4:j + o + 5, j], K2[j + o - 4:j + o + 5, j] = k1, k2
            return K1, K2, o, n_out

        return band_ops

    @staticmethod
    def _mel_block_part(s: WindowSpec, pre, carry, K1, K2, center0: int, n_out: int):
        """One block of the streaming frontend, batched over any leading slot
        axes: preemphasized block signal (..., samples) and the 8-frame mel
        carry (..., 8, M) → (the new 8-frame mel tail, (..., n_out, M, 3) mel +
        Δ + Δ² features). Shared by the session's and the server's block
        functions, so their frontend math cannot diverge."""
        mel = mel_from_frames(dsp.frame_signal(pre, s.win_size, s.hop_size), s)
        ctx = torch.cat([carry, mel], dim=-2)  # (..., B + 8, M)
        ctx_t = ctx.transpose(-1, -2)
        d1 = torch.matmul(ctx_t, K1).transpose(-1, -2)
        d2 = torch.matmul(ctx_t, K2).transpose(-1, -2)
        center = ctx[..., center0:center0 + n_out, :]
        return ctx[..., -8:, :], torch.stack([center, d1, d2], dim=-1)

    def _block_fns(self, block_frames: int):
        """(first, steady) block frontends with their Δ operators on the
        device, once per (task, block size): fn(pre, carry) → (tail, feats)."""
        band_ops = self._band_ops(block_frames)

        def make(first: bool):
            K1, K2, center0, n_out = band_ops(first)
            K1, K2 = torch.from_numpy(K1).to(self.device), torch.from_numpy(K2).to(self.device)
            return lambda pre, carry: self._mel_block_part(self.wspec, pre, carry, K1, K2,
                                                           center0, n_out)

        return make(True), make(False)

    def _get_stream_fns(self, block_frames: int):
        """(fused_first, fused_steady) of ``StreamingSession``: per block the
        mel frontend, the band Δ / Δ² and the per-frame encoder prefix, with an
        8-frame mel tail carried between calls on the device.
        fn(pre_block, mel_carry (8, M)) → (mel_tail (8, M), z (n_out, D)); the
        first-block variant applies the offline operator's edge fits for frames
        0..3 and emits block_frames − 4 frames, the steady one block_frames
        frames that lag the mel cursor by the 4-frame Δ context."""
        if block_frames not in self._stream_fns:
            def fused(part):
                @torch.inference_mode()
                def fn(pre, carry):
                    tail, feats = part(pre, carry)
                    return tail, self.model.encode_frames(feats)
                return fn

            self._stream_fns[block_frames] = tuple(map(fused, self._block_fns(block_frames)))
        return self._stream_fns[block_frames]

    def _get_ring_fns(self, block_frames: int):
        """(first_ring, batched_ring) of ``StreamingServer``'s ring of encoded
        frames on the device: a flat (capacity·ring_len, D) table in which
        slot s keeps absolute frame f at row s·ring_len + f mod ring_len. The
        suffix gathers its windows straight from it through
        ``forward_windows``; z never crosses to the host.

        first_ring(block, carries, slot, ring, rows): one stream's first block
            (the edge-fit Δ variant, block_frames − 4 frames).
        batched_ring(blocks (n, samples), carries, slots (n,), ring, rows):
            every live slot's steady block in one call, the prefix on the
            flattened n·block_frames frames.
        Both write ``carries`` (capacity, 8, M) and ``ring`` in place at the
        given slots and ``rows`` (index tensors the caller computed on the host:
        only live slots are computed and written, nothing is masked on the
        device). In place is safe because every write here and every gather of
        the suffix is enqueued on one CUDA stream in tick order."""
        key = int(block_frames)
        if key not in self._ring_fns:
            first_part, steady_part = self._block_fns(block_frames)
            n_mels = self.wspec.n_mels

            @torch.inference_mode()
            def first_ring(block, carries, slot: int, ring, rows):
                tail, feats = first_part(block, block.new_zeros(8, n_mels))
                ring.index_copy_(0, rows, self.model.encode_frames(feats))
                carries[slot] = tail

            @torch.inference_mode()
            def batched_ring(blocks, carries, slots, ring, rows):
                tails, feats = steady_part(blocks, carries[slots])
                ring.index_copy_(0, rows, self.model.encode_frames(feats.flatten(0, 1)))
                carries.index_copy_(0, slots, tails)

            self._ring_fns[key] = (first_ring, batched_ring)
        return self._ring_fns[key]

    def stream(self, speaker, emit_batch: int = 16, block_frames: int = 16):
        """A live session: push audio chunks, receive mesh frames with bounded
        lookahead. Larger ``emit_batch`` / ``block_frames`` trade latency for
        fewer dispatches. See ``streaming.StreamingSession``."""
        from .streaming import StreamingSession

        return StreamingSession(self, speaker, emit_batch=emit_batch, block_frames=block_frames)

    # -- evaluation ----------------------------------------------------------------
    def evaluate(self, sources, output_dir: str = "evaluate_results",
                 export_mesh_frames: bool = True, save_video: bool = True,
                 grid_w: int = 512, grid_h: int = 512, font_size: int = 24,
                 overwrite_video: bool = True, audio_target_db: Optional[float] = None,
                 **kwargs):
        """Evaluate sources (each a wav path or a dataset sentence directory,
        with ``"speaker=..."`` arguments) into ``output_dir/<name>/`` mesh
        frames and ``output_dir/<name>.avi`` (reference model.py:121-222).

        A wav is read at 44.1 kHz, the side signal of the exports, and
        resampled to the model's rate; a sentence directory gives its audio
        blob and its truth track. The model's signal is normalized to
        ``audio_target_db`` RMS. Video needs OpenCV (and matplotlib for
        ``draw_latent``): without them ``save_video=True`` raises before any
        inference."""
        from .viewer import video as video_mod

        if save_video:
            video_mod.require_video(bool(kwargs.get("draw_latent")))
        os.makedirs(output_dir, exist_ok=True)
        sr = int(self.hp.audio.sample_rate)
        fps = float(self.hp.anime.fps)
        face_type = self.hp.model.face_data_type
        if audio_target_db is None:
            audio_target_db = self.hp.dataset_anime.get("audio_target_db", -24.5)

        results = []
        for src_args in sources:
            if not isinstance(src_args, ArgumentParser):
                src_args = ArgumentParser(*src_args)
            path = src_args[0]
            name = os.path.splitext(os.path.basename(path))[0]
            truth = None
            if os.path.isdir(path):
                # a preprocessed sentence directory: its audio blob and truth frames
                blob_path = path + "_audio.npz"
                blob = np.load(blob_path if os.path.exists(blob_path)
                               else os.path.join(path, "_audio.npz"))
                sound_signal = np.asarray(blob["audio"], np.float32)
                src_sr = int(blob["sr"])
                signal = sound_signal if src_sr == sr else dsp.resample(sound_signal, src_sr, sr)
                truth = load_dataset_truth(path, fps)
                truth[face_type] = truth.pop("data")
                sound_signal = dsp.resample(sound_signal, src_sr, 44100)
            else:
                sound_signal, _ = audio_io.load(path, sr=44100)
                signal = dsp.resample(sound_signal, 44100, sr)
            signal = rms.normalize(signal, audio_target_db)
            speaker = src_args["speaker"] or 0
            log.info("infer from %s", name)
            tslist, animes, others = self.generate_animation(signal, speaker)

            out_base = os.path.join(output_dir, name)
            if export_mesh_frames:
                video_mod.export_mesh_frames(out_base, tslist, animes, face_type, fps,
                                             audio_signal=sound_signal, audio_sr=44100,
                                             device=self.device)
            video_path = None
            if save_video and not overwrite_video and os.path.exists(out_base + ".avi"):
                log.info("video exists, skipping: %s.avi", out_base)
                video_path = out_base + ".avi"
            elif save_video:
                render_sources = []
                if truth is not None and kwargs.get("draw_truth", True):
                    render_sources.append(truth)
                render_sources.append({"title": f"infer: {name}", face_type: animes,
                                       "tslist": tslist})
                # colour-mapped input and latent tracks (reference eval_utils.py:94-121)
                if kwargs.get("draw_latent"):
                    for key in ("inputs", "latent"):
                        data = others.get(key)
                        if data is None:
                            continue
                        if key == "inputs":  # (W, T, F, C) → the mel channel
                            imgs = [video_mod.color_mapping(w[:, :, 0].T) for w in data]
                        else:  # (W, D) latent → one column a window
                            imgs = [video_mod.color_mapping(w.reshape(-1, 1)) for w in data]
                        render_sources.append({"title": key, "images": np.asarray(imgs),
                                               "tslist": tslist})
                video_path = video_mod.render_video(
                    sources=render_sources, video_fps=fps, audio_sr=44100,
                    video_path=out_base + ".avi", grid_w=grid_w, grid_h=grid_h,
                    font_size=font_size, audio_signal=sound_signal, device=self.device)
            results.append(dict(name=name, tslist=tslist, animes=animes, video=video_path,
                                others=others))
        return results
