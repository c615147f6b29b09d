"""AnimationTask, the wav → vertices serving path (counterpart of
``sdfa_tpu/task.py``, f32 wire only).

Per request: the clip's frame grid and clip-level features (frontend),
the per-frame encoder prefix once per clip (convs + FreqLstm kernel), then
per window the temporal suffix (2-layer biLSTM kernel, or the
per-layer kernel for a stack of another depth, attention, heads) and the
decode+solve kernel from PCA coefficients to vertices.

Shape policy: the clip's frame count is rounded up to a multiple of 256
exactly as the JAX package does (``frame_idx`` and ``ts_list`` are
identical; the extra frames are trailing silence no window reads). The
256-window padding of the window batch existed to bound XLA recompiles
and is dropped: eager PyTorch runs exactly the clip's windows, in chunks
of at most ``MAX_WINDOW_BATCH`` to bound the decode scratch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import ops
from .audio.pipeline import WindowSpec, clip_frame_features_padded
from .models.sdfa import SpeechDrivenAnimation
from .ops.decode_solve import decode_solve_fused, prep_consts
from .viewer import frame as frame_mod

MAX_WINDOW_BATCH = 2048  # decode scratch: 9·10112·4 B ≈ 364 KB per window


class AnimationTask:
    def __init__(self, hparams, model: SpeechDrivenAnimation, device):
        ops.full_float32()
        self.hp = hparams
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.wspec = WindowSpec(hparams)
        if model.split <= 0:
            raise ValueError("the overlap serving path needs a time-independent encoder prefix")
        self._decode = None  # (solver, DeformConsts, DecodeSolveConsts), built on first use

    def _decode_consts(self):
        if self._decode is None:
            solver = frame_mod.get_solver()
            m = self.model
            dsc = prep_consts(m.scale_pca.compT, m.scale_pca.means, m.rotat_pca.compT,
                              m.rotat_pca.means, solver, self.device)
            self._decode = (solver, solver.device_consts(self.device), dsc)
        return self._decode

    def _overlap_prefix(self, signal: np.ndarray):
        """Clip-level stage: frame grid (bucketed to 256 frames), features
        and the per-frame encoder prefix → (frame_idx, ts_list, z_frames)."""
        signal = np.asarray(signal, np.float32).flatten()
        if signal.size and (signal.min() < -1 or signal.max() > 1):
            raise ValueError("signal must be float audio in [-1, 1]")
        frame_idx, ts_list, pad_l, pad_r, _ = self.wspec.frame_grid(len(signal), bucket=256)
        padded = torch.from_numpy(np.pad(signal, (pad_l, pad_r))).to(self.device)
        z_frames = self.model.encode_frames(clip_frame_features_padded(padded, self.wspec))
        return frame_idx, ts_list, z_frames

    @staticmethod
    def _window_chunks(n_windows: int):
        for i in range(0, n_windows, MAX_WINDOW_BATCH):
            yield slice(i, min(i + MAX_WINDOW_BATCH, n_windows))

    @torch.inference_mode()
    def generate_vertices(self, signal: np.ndarray, speaker, wire: str = "f32"):
        """signal (float in [-1, 1], hp sample rate) → (ts_list, verts
        (W, V, 3) float32 numpy)."""
        if wire != "f32":
            raise NotImplementedError(f"wire {wire!r} is not ported (f32 only)")
        if self.hp.get("ensembling_ms", 0):
            raise NotImplementedError("ensembling is not ported")
        if isinstance(speaker, str):
            speaker = dict(self.hp.dataset_anime.speakers)[speaker]
        solver, consts, dsc = self._decode_consts()
        frame_idx, ts_list, z_frames = self._overlap_prefix(signal)
        idx = torch.from_numpy(frame_idx).long().to(self.device)
        chunks = []
        for sl in self._window_chunks(len(frame_idx)):
            spk = torch.full((sl.stop - sl.start,), int(speaker), dtype=torch.long,
                             device=self.device)
            preds, _ = self.model.forward_windows(z_frames, idx[sl], spk)
            verts = decode_solve_fused(preds["dgrad_3d_scale_pca"][:, 0].contiguous(),
                                       preds["dgrad_3d_rotat_pca"][:, 0].contiguous(),
                                       dsc, consts, solver.spec, consts.template_cnst)
            chunks.append(verts.cpu().numpy())
        verts = (np.concatenate(chunks) if chunks
                 else np.zeros((0, solver.n_verts, 3), np.float32))
        return ts_list, verts

    def warmup(self, seconds: float = 3.0) -> float:
        """Pre-pay the serving path's one-time costs (kernel builds, solver
        constants, allocator warm-up); returns the wall seconds spent."""
        t0 = time.perf_counter()
        sr = int(self.hp.audio.sample_rate)
        tt = np.arange(int(seconds * sr), dtype=np.float32) / sr
        self.generate_vertices((0.1 * np.sin(2 * np.pi * 150.0 * tt)).astype(np.float32), 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0
