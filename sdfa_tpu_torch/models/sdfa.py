"""SpeechDrivenAnimation (counterpart of ``sdfa_tpu/models/sdfa.py``): the
config-driven audio encoder, the speaker condition (one-hot or learned), the
output trunk, and either the dgrad scale/rotat heads with their PCA
inversions or the one inversion of the vertex face types (offsets,
positions). Submodule and parameter names follow the flax tree
(``audio_encoder.built_layers_6.lstm.w_ih_l0``, ``scale_pca.compT``,
``pca.compT``, ``speaker_embedding.Embed_0.embedding``, ...).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..nn.functions import one_hot
from ..nn.spec import LayerStack, encoder_overlap_split

# the face types the port builds (its tasks turn each into vertices)
FACE_TYPES = ("dgrad_3d", "verts_pos_3d", "verts_off_3d")
PRED_TYPES = ("pca_coeffs", "pca_normal", "face_data")


class PcaInversion(nn.Module):
    """y = x·compTᵀ + means; compT (out, coeffs). Constants (buffers) unless
    ``trainable``, then parameters the optimizer moves."""

    def __init__(self, coeffs_dim: int, output_dim: int, trainable: bool = False):
        super().__init__()
        for name, shape in (("compT", (output_dim, coeffs_dim)), ("means", (output_dim,))):
            if trainable:
                setattr(self, name, nn.Parameter(torch.zeros(shape)))
            else:
                self.register_buffer(name, torch.zeros(shape))

    def forward(self, x):
        return torch.matmul(x, self.compT.T) + self.means

    def decode_targets(self, coef):
        """PCA-coefficient training targets → face data, with no gradient into
        the bases (the JAX trainer decodes them through the constants)."""
        return torch.matmul(coef.float(), self.compT.detach().T) + self.means.detach()

    def load_bases(self, comp_t, means):
        with torch.no_grad():
            self.compT.copy_(torch.as_tensor(np.asarray(comp_t, np.float32)))
            self.means.copy_(torch.as_tensor(np.asarray(means, np.float32)).reshape(-1))


class Embed(nn.Module):
    """flax ``nn.Embed``: a learned (num_embeddings, features) table indexed by id."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def reset_parameters(self, gen: torch.Generator):
        # flax's default: variance scaling 1.0 on fan-in, which for an embedding
        # table is ``features``
        with torch.no_grad():
            self.embedding.copy_(torch.randn(self.embedding.shape, generator=gen)
                                 / float(np.sqrt(self.embedding.shape[1])))

    def forward(self, ids):
        return self.embedding[ids]


class SpeakerEmbedding(nn.Module):
    """The speaker condition: one-hot (the shipped configs' choice) or a
    learned embedding of ``embedding_size`` (``Embed_0``, the flax name)."""

    def __init__(self, num_speakers: int = 8, using_onehot: bool = True,
                 embedding_size: int = 32):
        super().__init__()
        self.num_speakers = int(num_speakers)
        self.using_onehot = bool(using_onehot)
        if not self.using_onehot:
            self.Embed_0 = Embed(self.num_speakers, int(embedding_size))

    def forward(self, speaker_id):
        if self.using_onehot:
            return one_hot(speaker_id, self.num_speakers)
        return self.Embed_0(speaker_id)


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
    """audio features → PCA coefficients or face data. ``dgrad_3d`` has two
    heads after the trunk (``scale_head`` / ``rotat_head``, 6 + 3 floats per
    triangle) with an inversion each (``scale_pca`` / ``rotat_pca``); every
    other face type has the trunk alone, into one inversion ``pca``
    (``verts_off_3d``: offsets from the template, ``verts_pos_3d``: positions,
    3 floats per vertex), or no inversion at all without ``using_pca``.

    Prediction keys: ``{face_type}`` (``dgrad_3d_scale`` / ``dgrad_3d_rotat``
    for dgrad) for face data, the same with ``_pca`` for coefficients. The
    ``pca_coeffs`` / ``pca_normal`` prediction types always give
    coefficients; ``face_data`` gives them where the caller asks
    (``forward(decode=False)``, ``forward_windows(raw_pca=True)``), so that
    the caller decodes (``decode_to_anime``) or a kernel does."""

    def __init__(self, encoder_specs, output_specs, output_scale_specs=(), output_rotat_specs=(),
                 output_dim_scale: int = 0, output_dim_rotat: int = 0, pca_coeffs_scale: int = 0,
                 pca_coeffs_rotat: int = 0, weight_norm: bool = True, num_speakers: int = 8, *,
                 face_type: str = "dgrad_3d", pred_type: str = "face_data",
                 using_pca: bool = True, pca_trainable: bool = False, output_dim: int = 0,
                 pca_coeffs: int = 0, speaker_onehot: bool = True,
                 speaker_embedding_size: int = 32):
        super().__init__()
        if face_type not in FACE_TYPES:
            raise NotImplementedError(f"face type {face_type!r} is not ported")
        if pred_type not in PRED_TYPES:
            raise ValueError(f"unknown prediction type {pred_type!r}")
        self.face_type, self.pred_type = face_type, pred_type
        self.using_pca, self.pca_trainable = bool(using_pca), bool(pca_trainable)
        self.encoder_specs, self.weight_norm = encoder_specs, bool(weight_norm)
        self.audio_encoder = LayerStack(encoder_specs, weight_norm, tag="audio_encoder")
        self.speaker_embedding = SpeakerEmbedding(num_speakers, speaker_onehot,
                                                  speaker_embedding_size)
        self.output_trunk = LayerStack(output_specs, weight_norm, tag="output")
        if face_type == "dgrad_3d":
            self.scale_head = LayerStack(output_scale_specs, weight_norm, tag="output-scale")
            self.rotat_head = LayerStack(output_rotat_specs, weight_norm, tag="output-rotat")
            if self.using_pca:
                self.scale_pca = PcaInversion(pca_coeffs_scale, output_dim_scale, pca_trainable)
                self.rotat_pca = PcaInversion(pca_coeffs_rotat, output_dim_rotat, pca_trainable)
        elif self.using_pca:
            self.pca = PcaInversion(pca_coeffs, output_dim, pca_trainable)
        self.n_tris = int(output_dim_scale) // 6  # dgrad's triangles, with or without PCA heads
        self.split, self.taxis = encoder_overlap_split(encoder_specs, weight_norm)
        self._perms = {}  # (layout, device) → the decode's column permutation on that device

    @property
    def return_pca(self) -> bool:
        return self.pred_type.startswith("pca")

    def forward(self, audio_feat, speaker_id, decode: bool = False):
        """Per-window path: window features (N, T, F, C) → (prediction dict,
        alignments). By default the raw PCA coefficients, as
        ``forward_windows(raw_pca=True)`` returns them; with ``decode=True`` the
        face data behind the PCA inversions (the ``face_data`` prediction type
        that training uses), flat (N, 1, D) and differentiable end to end."""
        preds, _, aligns = self.forward_latent(audio_feat, speaker_id, raw_pca=not decode)
        return preds, aligns

    def forward_latent(self, audio_feat, speaker_id, raw_pca: bool = True):
        """``forward`` with the encoder's output beside it, as the JAX model's
        ``__call__`` returns: (predictions, z_audio, alignments)."""
        condition = self.speaker_embedding(speaker_id)
        z_audio, aligns = self.audio_encoder(audio_feat, condition=condition)
        return self._heads(z_audio, condition, raw_pca), z_audio, aligns

    def _heads(self, z_audio, condition, raw_pca: bool):
        emit_pca = self.return_pca or (raw_pca and self.using_pca)
        decode = self.using_pca and not emit_pca
        postfix = "_pca" if emit_pca else ""
        x, _ = self.output_trunk(z_audio, condition=condition)
        if self.face_type != "dgrad_3d":
            return {f"{self.face_type}{postfix}": self.pca(x) if decode else x}
        scale = self.scale_head(x, condition=condition)[0]
        rotat = self.rotat_head(x, condition=condition)[0]
        if decode:
            scale, rotat = self.scale_pca(scale), self.rotat_pca(rotat)
        return {f"dgrad_3d_scale{postfix}": scale, f"dgrad_3d_rotat{postfix}": rotat}

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
        gives the heads' raw PCA coefficients (dgrad: {"dgrad_3d_scale_pca":
        (W, 1, Ks), "dgrad_3d_rotat_pca": (W, 1, Kr)}; offsets:
        {"verts_off_3d_pca": (W, 1, K)}); otherwise the decoded face data, as
        ``forward(decode=True)``."""
        condition = self.speaker_embedding(speaker_id)
        z = torch.movedim(z_frames[frame_idx], 1, self.taxis)  # (W, frames, …)
        z_audio, aligns = self.audio_encoder(z, condition=condition, start=self.split)
        return self._heads(z_audio, condition, raw_pca), z_audio, aligns

    def _perm_on(self, layout: str, device) -> torch.Tensor:
        key = (layout, torch.device(device))
        if key not in self._perms:
            perm = (_interleave_perm(self.n_tris) if layout == "interleave"
                    else _km_perm(self.n_tris, 6 if layout == "scale" else 3))
            with torch.inference_mode(False):
                self._perms[key] = torch.from_numpy(perm).to(device)
        return self._perms[key]

    def decode_to_anime(self, preds: Dict[str, torch.Tensor], planes: bool = False):
        """Prediction dict (PCA coefficients or face data: the keys say which)
        → flat anime frames (N, L, D). dgrad: (N, L, tris·9), k-major planes
        (``planes=True``, [k·n_tris + tri]) or the reference layout
        [tri·9 + k]; the other face types: their face data, (N, L, V·3)."""
        if self.face_type != "dgrad_3d":
            if planes:
                raise ValueError("the planes layout exists for dgrad_3d only")
            key = f"{self.face_type}_pca"
            return self.pca(preds[key]) if key in preds else preds[self.face_type]
        if "dgrad_3d_scale_pca" in preds:
            scale = self.scale_pca(preds["dgrad_3d_scale_pca"])
            rotat = self.rotat_pca(preds["dgrad_3d_rotat_pca"])
        else:
            scale, rotat = preds["dgrad_3d_scale"], preds["dgrad_3d_rotat"]
        if planes:
            return torch.cat([scale[..., self._perm_on("scale", scale.device)],
                              rotat[..., self._perm_on("rotat", scale.device)]], dim=-1)
        return torch.cat([scale, rotat], dim=-1)[..., self._perm_on("interleave", scale.device)]


def build_model(hparams, pca: Optional[Dict[str, np.ndarray]] = None,
                load_pca: bool = True) -> SpeechDrivenAnimation:
    """Construct the network from a resolved hparams tree. ``pca``: optional
    arrays of the PCA bases, {"scale_compT", "scale_means", "rotat_compT",
    "rotat_means"} for dgrad, {"compT", "means"} for the other face types; by
    default they are read from the config's .npy paths. ``load_pca=False``
    leaves them at zero for a checkpoint to fill (``api.load_task``)."""
    mp = hparams.model
    out = mp.output
    face_type = mp.face_data_type
    using_pca = bool(out.get("using_pca", False))
    spk = mp.get("speaker_embedding") or {}

    def coeffs(spec_list):
        return int([s for s in spec_list if s[0] == "fc"][-1][2])

    kwargs = dict(
        face_type=face_type, pred_type=mp.get("prediction_type", "face_data"),
        using_pca=using_pca, pca_trainable=bool(out.get("pca_trainable", False)),
        weight_norm=bool(mp.get("weight_norm", False)),
        num_speakers=int(spk.get("num_speakers", 0) or 0),
        speaker_onehot=bool(spk.get("using_onehot", True)),
        speaker_embedding_size=int(spk.get("embedding_size", 32) or 32))
    if face_type == "dgrad_3d":
        model = SpeechDrivenAnimation(
            mp.audio_encoder.layers, out.layers, out.layers_scale, out.layers_rotat,
            int(out.output_dim_scale), int(out.output_dim_rotat), coeffs(out.layers_scale),
            coeffs(out.layers_rotat), **kwargs)
        bases = {"scale_pca": ("scale_", out.get("pca_scale")),
                 "rotat_pca": ("rotat_", out.get("pca_rotat"))}
    else:
        model = SpeechDrivenAnimation(mp.audio_encoder.layers, out.layers,
                                      output_dim=int(out.output_dim),
                                      pca_coeffs=coeffs(out.layers), **kwargs)
        bases = {"pca": ("", out.get("pca"))}
    if using_pca and load_pca:
        for name, (prefix, paths) in bases.items():
            comp_t, means = ((pca[prefix + "compT"], pca[prefix + "means"]) if pca is not None
                             else (np.load(path) for path in paths))
            getattr(model, name).load_bases(comp_t, means)
    return model
