"""SpeechDrivenAnimation, dgrad face type (counterpart of
``sdfa_tpu/models/sdfa.py``): the config-driven audio encoder, the one-hot
speaker condition, the output trunk, the scale/rotat heads and their PCA
inversions. Submodule and parameter names follow the flax tree
(``audio_encoder.built_layers_6.lstm.w_ih_l0``, ``scale_pca.compT``, ...).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..nn.functions import one_hot
from ..nn.spec import LayerStack, encoder_overlap_split


class PcaInversion(nn.Module):
    """y = x·compTᵀ + means; compT (out, coeffs) and means are constants."""

    def __init__(self, coeffs_dim: int, output_dim: int):
        super().__init__()
        self.register_buffer("compT", torch.zeros(output_dim, coeffs_dim))
        self.register_buffer("means", torch.zeros(output_dim))

    def forward(self, x):
        return torch.matmul(x, self.compT.T) + self.means


class SpeakerEmbedding(nn.Module):
    """One-hot speaker condition (the shipped configs' choice)."""

    def __init__(self, num_speakers: int = 8):
        super().__init__()
        self.num_speakers = int(num_speakers)

    def forward(self, speaker_id):
        return one_hot(speaker_id, self.num_speakers)


@functools.lru_cache(maxsize=None)
def _km_perm(n_tris: int, per_tri: int) -> np.ndarray:
    """Column permutation of a tri-major decode to k-major planes:
    perm[k·T + j] = per_tri·j + k."""
    j = np.arange(n_tris)
    perm = np.empty(n_tris * per_tri, np.int64)
    for k in range(per_tri):
        perm[k * n_tris + j] = per_tri * j + k
    return perm


@functools.lru_cache(maxsize=None)
def _interleave_perm(n_tris: int) -> np.ndarray:
    """Gather indices that interleave concat([scale (T·6), rotat (T·3)]) into
    the reference frame layout: perm[9j + k] = 6j + k for k < 6, else
    6T + 3j + k − 6."""
    j = np.arange(n_tris)
    perm = np.empty(n_tris * 9, np.int64)
    for k in range(9):
        perm[9 * j + k] = 6 * j + k if k < 6 else 6 * n_tris + 3 * j + k - 6
    return perm


class SpeechDrivenAnimation(nn.Module):
    """audio features → dgrad PCA coefficients, or (``decode=True``, the
    ``face_data`` prediction type that training uses) the flat dgrad
    outputs behind the frozen PCA inversions."""

    def __init__(self, encoder_specs, output_specs, output_scale_specs, output_rotat_specs,
                 output_dim_scale: int, output_dim_rotat: int, pca_coeffs_scale: int,
                 pca_coeffs_rotat: int, weight_norm: bool = True, num_speakers: int = 8):
        super().__init__()
        self.encoder_specs, self.weight_norm = encoder_specs, bool(weight_norm)
        self.audio_encoder = LayerStack(encoder_specs, weight_norm, tag="audio_encoder")
        self.speaker_embedding = SpeakerEmbedding(num_speakers)
        self.output_trunk = LayerStack(output_specs, weight_norm, tag="output")
        self.scale_head = LayerStack(output_scale_specs, weight_norm, tag="output-scale")
        self.rotat_head = LayerStack(output_rotat_specs, weight_norm, tag="output-rotat")
        self.scale_pca = PcaInversion(pca_coeffs_scale, output_dim_scale)
        self.rotat_pca = PcaInversion(pca_coeffs_rotat, output_dim_rotat)
        self.split, self.taxis = encoder_overlap_split(encoder_specs, weight_norm)
        self._perms = {}  # (layout, device) → the decode's column permutation on that device

    def forward(self, audio_feat, speaker_id, decode: bool = False):
        """Per-window path: window features (N, T, F, C) → (prediction dict,
        alignments). By default the raw PCA coefficients, as
        ``forward_windows`` returns them; with ``decode=True`` the flat
        ``dgrad_3d_scale`` (N, 1, tris·6) and ``dgrad_3d_rotat`` (N, 1, tris·3),
        differentiable end to end."""
        preds, _, aligns = self.forward_latent(audio_feat, speaker_id)
        if decode:
            preds = {"dgrad_3d_scale": self.scale_pca(preds["dgrad_3d_scale_pca"]),
                     "dgrad_3d_rotat": self.rotat_pca(preds["dgrad_3d_rotat_pca"])}
        return preds, aligns

    def forward_latent(self, audio_feat, speaker_id):
        """``forward`` with the encoder's output beside it, as the JAX model's
        ``__call__`` returns: (raw PCA coefficients, z_audio, alignments)."""
        condition = self.speaker_embedding(speaker_id)
        z_audio, aligns = self.audio_encoder(audio_feat, condition=condition)
        return self._heads(z_audio, condition), z_audio, aligns

    def _heads(self, z_audio, condition):
        x, _ = self.output_trunk(z_audio, condition=condition)
        return {"dgrad_3d_scale_pca": self.scale_head(x, condition=condition)[0],
                "dgrad_3d_rotat_pca": self.rotat_head(x, condition=condition)[0]}

    def encode_frames(self, clip_feat):
        """Per-frame encoder prefix over the clip's frame grid:
        (T_total, F, C) → (T_total, …), time leading."""
        if self.split <= 0:
            raise ValueError("encoder has no time-independent prefix")
        z, _ = self.audio_encoder(clip_feat[None], stop=self.split)
        return torch.movedim(z[0], self.taxis - 1, 0)

    def encode_frames_batch(self, clip_feats):
        """Batched ``encode_frames``: (B, T_total, F, C) → (B, T_total, …).
        The prefix is per frame, so FreqLstm sees all B·T_total rows in one
        call and walks them in the row chunks its wrapper holds."""
        if self.split <= 0:
            raise ValueError("encoder has no time-independent prefix")
        z, _ = self.audio_encoder(clip_feats, stop=self.split)
        return torch.movedim(z, self.taxis, 1)

    def forward_windows(self, z_frames, frame_idx, speaker_id, raw_pca: bool = False):
        """Temporal suffix per window: gather each window's frames from the
        prefix output (a clip's frame grid, or any table of encoded frames:
        ``z_frames[frame_idx]`` is a pure gather), then biLSTM, attention and
        the heads. Returns (preds, z_audio, alignments). ``raw_pca=True``
        gives the heads' raw PCA coefficients, {"dgrad_3d_scale_pca": (W, 1,
        Ks), "dgrad_3d_rotat_pca": (W, 1, Kr)}; otherwise the flat decoded
        ``dgrad_3d_scale`` / ``dgrad_3d_rotat`` as ``forward(decode=True)``."""
        condition = self.speaker_embedding(speaker_id)
        z = torch.movedim(z_frames[frame_idx], 1, self.taxis)  # (W, frames, …)
        z_audio, aligns = self.audio_encoder(z, condition=condition, start=self.split)
        preds = self._heads(z_audio, condition)
        if not raw_pca:
            preds = {"dgrad_3d_scale": self.scale_pca(preds["dgrad_3d_scale_pca"]),
                     "dgrad_3d_rotat": self.rotat_pca(preds["dgrad_3d_rotat_pca"])}
        return preds, z_audio, aligns

    def _perm_on(self, layout: str, device) -> torch.Tensor:
        key = (layout, torch.device(device))
        if key not in self._perms:
            n_tris = self.scale_pca.means.shape[0] // 6
            perm = (_interleave_perm(n_tris) if layout == "interleave"
                    else _km_perm(n_tris, 6 if layout == "scale" else 3))
            with torch.inference_mode(False):
                self._perms[key] = torch.from_numpy(perm).to(device)
        return self._perms[key]

    def decode_to_anime(self, preds: Dict[str, torch.Tensor], planes: bool = False):
        """Prediction dict (PCA coefficients, or the decoded ``dgrad_3d_scale``
        / ``dgrad_3d_rotat``: the keys say which) → flat dgrad frames (N, L,
        tris·9): k-major planes (``planes=True``, [k·n_tris + tri]) or the
        reference layout [tri·9 + k]."""
        if "dgrad_3d_scale_pca" in preds:
            scale = self.scale_pca(preds["dgrad_3d_scale_pca"])
            rotat = self.rotat_pca(preds["dgrad_3d_rotat_pca"])
        else:
            scale, rotat = preds["dgrad_3d_scale"], preds["dgrad_3d_rotat"]
        if planes:
            return torch.cat([scale[..., self._perm_on("scale", scale.device)],
                              rotat[..., self._perm_on("rotat", scale.device)]], dim=-1)
        return torch.cat([scale, rotat], dim=-1)[..., self._perm_on("interleave", scale.device)]


def build_model(hparams, pca: Optional[Dict[str, np.ndarray]] = None) -> SpeechDrivenAnimation:
    """Construct the dgrad network from a resolved hparams tree. ``pca``:
    optional {"scale_compT", "scale_means", "rotat_compT", "rotat_means"}
    arrays; by default they are read from the config's .npy paths."""
    mp = hparams.model
    out = mp.output
    if mp.face_data_type != "dgrad_3d" or not out.get("using_pca", False):
        raise NotImplementedError("only the dgrad_3d PCA model is ported")
    if out.get("pca_trainable", False):
        raise NotImplementedError("trainable PCA is not ported")
    spk = mp.get("speaker_embedding") or {}
    if not spk.get("using_onehot", True):
        raise NotImplementedError("learned speaker embeddings are not ported")

    def coeffs(spec_list):
        return int([s for s in spec_list if s[0] == "fc"][-1][2])

    model = SpeechDrivenAnimation(
        encoder_specs=mp.audio_encoder.layers, output_specs=out.layers,
        output_scale_specs=out.layers_scale, output_rotat_specs=out.layers_rotat,
        output_dim_scale=int(out.output_dim_scale), output_dim_rotat=int(out.output_dim_rotat),
        pca_coeffs_scale=coeffs(out.layers_scale), pca_coeffs_rotat=coeffs(out.layers_rotat),
        weight_norm=bool(mp.get("weight_norm", False)),
        num_speakers=int(spk.get("num_speakers", 0) or 0))
    if pca is None:
        pca = dict(zip(("scale_compT", "scale_means"), out.pca_scale))
        pca.update(zip(("rotat_compT", "rotat_means"), out.pca_rotat))
        pca = {k: np.load(v) for k, v in pca.items()}
    with torch.no_grad():
        for name in ("scale", "rotat"):
            sub = getattr(model, f"{name}_pca")
            sub.compT.copy_(torch.as_tensor(np.asarray(pca[f"{name}_compT"], np.float32)))
            sub.means.copy_(torch.as_tensor(np.asarray(pca[f"{name}_means"], np.float32))
                            .reshape(-1))
    return model
