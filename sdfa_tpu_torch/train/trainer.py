"""Experiment + Trainer: the training runtime (counterpart of
``sdfa_tpu/train/trainer.py``).

One optimization step is forward (BatchNorm on batch statistics, dropout
from a generator seeded by (experiment seed, global step)), the losses with
their dynamic scalers, backward — the recurrences through the
``bilstm_core`` kernels on a card — the gradient norm, optional clipping and
Adam. The ``Trainer`` takes any iterable of batch dicts, as numpy arrays or
tensors: ``audio_feat`` (N, T, F, C), ``speaker_id`` (N,), and the targets
either as face data (``dgrad_3d_scale`` / ``dgrad_3d_rotat``; ``verts_off_3d``
and the like for the other face types, whose loss has one branch and one pair
of scalers) or as PCA coefficients (``dgrad_3d_scale_coef`` /
``dgrad_3d_rotat_coef``, ``verts_off_3d_coef``), decoded on the device inside
the loss. The first half of a batch is frame i, the second half
frame i + 1. A raw-mode batch (``DatasetSlidingWindow.raw_batches``)
carries ``raw_wav`` and the augmentation knobs instead of ``audio_feat``;
the loss computes the features on the device first
(``data/device_features.py``).

Batches reach the device through two pinned host buffers that take turns
(``PinnedUploads``), and the ``Trainer`` fetches batch k + 1 and enqueues its
upload right after step k is dispatched, before anything of step k is read,
so that the host's batch preparation overlaps the device's step.

Run directory: ``hparams.json``, ``params_info.txt``,
``train_log/metrics.jsonl`` (with one ``timing`` line per epoch: wall time,
the time the ``Trainer`` waited on its loader, the median interval between
step dispatches), ``train_log/loss/epoch-loss.csv``, TensorBoard events under
``train_log/tb`` (``summary.py``: the train scalars every ``METRICS_EVERY``
steps and, every ``trainer.plot_gap_steps`` steps, the plot plugins on
``Experiment.plot_forward``), the videos of the mid-training evaluation
(``trainer.eval_gap_epochs``) under ``eval_at_train/epochNNNN`` and the
checkpoints of ``checkpoints.py``.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import ops, profiling
from ..compat.from_flax import init_params
from ..data.device_features import FeatureSpec, device_train_features
from ..models import losses as L
from ..models.sdfa import SpeechDrivenAnimation
from ..nn.layers import set_data_mesh, set_dropout_generator
from ..ops import bilstm2, bilstm_core, freq_lstm
from ..parallel import mesh as mesh_lib
from ..parallel import multihost as mh
from . import checkpoints as ckpt_io
from . import lr_schedules
from . import summary as summary_lib

log = logging.getLogger(__name__)

SCALER_NAMES = ("dyn_p_scale", "dyn_m_scale", "dyn_p_rotat", "dyn_m_rotat", "dyn_e")  # dgrad's
METRICS_EVERY = 50  # steps between lines of metrics.jsonl
RAW_KEYS = ("raw_wav", "preemph", "t_idx", "f_idx", "feat_scale", "drop_rows", "drop_is_max",
            "drop_thres")  # a raw-mode batch's frontend inputs, in device_train_features' order
HOST_ONLY = ("signal",)  # batch entries that never go to the device (summary audio clips)


def scaler_names(face_type: str) -> Tuple[str, ...]:
    """The dynamic loss scalers of a face type: one pair per dgrad branch, one
    pair for the others."""
    return SCALER_NAMES if face_type == "dgrad_3d" else ("dyn_p", "dyn_m", "dyn_e")


def make_loss_fn(model: SpeechDrivenAnimation, hparams, mesh: Optional[mesh_lib.Mesh] = None):
    """Returns loss_fn(scalers, batch, training) → (total, aux); ``batch``
    holds tensors on the model's device and the model's mode is the
    caller's to set. Under a data-parallel ``mesh`` the dynamic scalers
    follow the loss terms' means over the ranks."""
    hp_loss = hparams.loss
    face_type = model.face_type
    is_face_data = model.pred_type == "face_data"
    postfix = "_pca" if model.return_pca else ""
    dyn = bool(hp_loss.get("dynamic_scalar", False))
    p_scale = float(hp_loss.get("ploss_scale", 1))
    m_scale = float(hp_loss.get("mloss_scale", 1))
    weight_key = hp_loss.get("anime_loss_weight")
    feat_spec = None  # built on the first raw batch: a run on features needs no mel config

    def dgrad_terms(preds, batch, weights):
        """(scalars, [(term, value, scaler, scale)]) of the two dgrad branches."""
        pred_s = preds[f"dgrad_3d_scale{postfix}"]
        pred_r = preds[f"dgrad_3d_rotat{postfix}"]
        if "dgrad_3d_scale_coef" in batch:
            # PCA-coefficient targets decode on the device: 85 + 180 floats per
            # frame cross the bus instead of 89,784
            true_s = model.scale_pca.decode_targets(batch["dgrad_3d_scale_coef"])
            true_r = model.rotat_pca.decode_targets(batch["dgrad_3d_rotat_coef"])
        else:
            true_s = batch[f"dgrad_3d_scale{postfix}"].float()
            true_r = batch[f"dgrad_3d_rotat{postfix}"].float()
        if is_face_data:
            true_s = true_s.reshape(true_s.shape[:2] + (-1,))
            true_r = true_r.reshape(true_r.shape[:2] + (-1,))
            ps = L.ploss_flat(pred_s, true_s, weights, group=6)
            ms = L.mloss_flat(pred_s, true_s, weights, group=6)
            pr = L.ploss_flat(pred_r, true_r, weights, group=3, exp_values=True)
            mr = L.mloss_flat(pred_r, true_r, weights, group=3, exp_values=True)
        else:
            kw = dict(is_dgrad=True, is_face_data=False)
            ps = L.ploss(pred_s, true_s, weights, **kw)
            ms = L.mloss(pred_s, true_s, weights, **kw)
            pr = L.ploss(pred_r, true_r, weights, **kw)
            mr = L.mloss(pred_r, true_r, weights, **kw)
        scalars = dict(scalar_ps=ps, scalar_ms=ms, scalar_pr=pr, scalar_mr=mr,
                       scalar_ploss=ps + pr, scalar_mloss=ms + mr)
        terms = [("ps", ps, "dyn_p_scale", p_scale), ("ms", ms, "dyn_m_scale", m_scale),
                 ("pr", pr, "dyn_p_rotat", p_scale), ("mr", mr, "dyn_m_rotat", m_scale)]
        return scalars, terms

    def single_terms(preds, batch, weights):
        """The same for the one branch of the other face types."""
        pred = preds[f"{face_type}{postfix}"]
        if f"{face_type}_coef" in batch:
            # decoded on the device: 59 floats per frame cross the bus for offsets
            true = model.pca.decode_targets(batch[f"{face_type}_coef"])
        else:
            true = batch[f"{face_type}{postfix}"].float()
        kw = dict(is_dgrad=False, is_face_data=is_face_data)
        pl, ml = L.ploss(pred, true, weights, **kw), L.mloss(pred, true, weights, **kw)
        return (dict(scalar_ploss=pl, scalar_mloss=ml),
                [("ploss", pl, "dyn_p", p_scale), ("mloss", ml, "dyn_m", m_scale)])

    def loss_fn(scalers: Dict[str, L.ScalerState], batch, training: bool):
        nonlocal feat_spec
        if "raw_wav" in batch:
            # the host shipped raw windows and augmentation knobs only
            if feat_spec is None:
                feat_spec = FeatureSpec.from_hparams(hparams)
            audio_feat = device_train_features(*(batch[k] for k in RAW_KEYS), spec=feat_spec)
        else:
            audio_feat = batch["audio_feat"]
        preds, _ = model(audio_feat, batch["speaker_id"], decode=is_face_data)
        weights = batch.get(weight_key) if weight_key else None
        if weights is None:
            weights = audio_feat.new_ones(audio_feat.shape[0])

        terms_fn = dgrad_terms if face_type == "dgrad_3d" else single_terms
        scalars, terms = terms_fn(preds, batch, weights)
        loss_terms: Dict[str, torch.Tensor] = {}
        new_scalers = dict(scalers)
        global_terms = [None] * len(terms)
        if dyn and training and mesh is not None and mesh.parallel:
            # every term's global mean in one all-reduce: the scalers' state stays
            # the same on every rank and equal to one process's on the global batch
            global_terms = mesh_lib.mean_over_ranks(torch.stack([t[1] for t in terms]), mesh)
        for (key, val, sname, scl), global_val in zip(terms, global_terms):
            if dyn:
                scaled, new_scalers[sname] = L.dynamic_scale(val, scalers[sname], training,
                                                              global_loss=global_val)
                loss_terms[f"dyn_{key}"] = scaled * scl
            else:
                loss_terms[f"loss_{key}"] = val * scl
        total = sum(loss_terms.values())
        scalars["total"] = total
        return total, dict(new_scalers=new_scalers, scalars=scalars, loss_terms=loss_terms)

    return loss_fn


def make_optimizer(hparams, params: Iterable[torch.nn.Parameter]):
    """Adam (AdamW when a weight decay is set or named); lr and beta1 are
    written into the param groups before every step.
    Returns (optimizer, lr_fn, beta1_fn, mode, base_lr)."""
    opt = hparams.optim
    args = dict(opt.get("args") or {})
    base_lr = float(args.get("lr", 1e-3))
    wd = float(args.get("weight_decay", 0) or 0)
    sched = opt.get("lr_scheduler") or None
    lr_fn, beta1_fn, mode = lr_schedules.build(sched.get("name") if sched else None, base_lr,
                                               sched.get("args") if sched else None)
    name = opt.get("name", "Adam")
    if name not in ("Adam", "AdamW"):
        raise NotImplementedError(f"optimizer '{name}' is not ported")
    if wd > 0 or name == "AdamW":
        # decoupled decay p ← p − lr·wd·p, the rule of the JAX package's optimizer
        optimizer = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=wd)
    else:
        optimizer = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    return optimizer, lr_fn, beta1_fn, mode, base_lr


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """The dropout generator's seed for one global step: a function of
    (experiment seed, step) only, so a resumed run repeats an uninterrupted
    one. An aux loader's step draws from its own ``stream`` of the main step
    it follows (1_000_003 + the loader's index, as the JAX trainer folds it)."""
    base = (int(seed) * 1_000_003 + int(step)) % (2 ** 63 - 1)
    return base if not stream else (base * 1_000_003 + int(stream)) % (2 ** 63 - 1)


class PinnedUploads:
    """Host → device copies of batches through two pinned buffers that take
    turns. A batch's arrays are packed into one buffer, each copied with
    ``non_blocking`` on the current stream, and an event is recorded after the
    copies; a buffer is refilled only once its event has passed, so no copy
    still in flight reads a rewritten buffer. Tensors already on a device pass
    through; for a CPU device the arrays are taken as they are."""

    ALIGN = 256  # bytes between two arrays in a buffer

    def __init__(self):
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._done: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def put(self, batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
        if device.type != "cuda":
            return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        out, host = {}, {}
        for key, val in batch.items():
            if torch.is_tensor(val) and val.device.type != "cpu":
                out[key] = val.to(device, non_blocking=True)
            else:
                host[key] = val.numpy() if torch.is_tensor(val) else np.asarray(val)
        if not host:
            return out
        i, self._turn = self._turn, self._turn ^ 1
        if self._done[i] is not None:
            self._done[i].synchronize()
        offsets, n = {}, 0
        for key, arr in host.items():
            offsets[key] = n
            n += -(-arr.nbytes // self.ALIGN) * self.ALIGN
        if self._bufs[i] is None or self._bufs[i].numel() < n:
            self._bufs[i] = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
        for key, arr in host.items():
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            staged = self._bufs[i][offsets[key]:offsets[key] + arr.nbytes].view(dtype)
            staged = staged.view(arr.shape)
            staged.numpy()[...] = arr
            out[key] = staged.to(device, non_blocking=True)
        self._done[i] = torch.cuda.Event()
        self._done[i].record(torch.cuda.current_stream(device))
        return out


class Experiment:
    """Composition root: run directory, model and optimizer state, the train
    and eval steps, checkpoints, metric writers.

    Data parallel: with ``trainer.multihost`` it joins the process group
    (``parallel/multihost.py``); the mesh spans every process of the group,
    if there is one. Each rank then steps on its own rows of every global batch
    (``parallel.shard_batch``), and the step computes what one process computes
    on the global batch: BatchNorm statistics, the dropout draws, the scalers
    and the gradient are global, the metrics are global means. Rank 0 alone
    writes the run directory; every rank loads a checkpoint."""

    def __init__(self, hparams, model: SpeechDrivenAnimation, log_dir: str, device,
                 load_from: Optional[str] = None, seed: int = 1234):
        ops.full_float32()
        self.hp, self.log_dir, self.seed = hparams, log_dir, int(seed)
        self.multihost = bool((hparams.get("trainer") or {}).get("multihost", False))
        if self.multihost:
            # join the group before the mesh is built, so that it spans every process
            mh.maybe_initialize_distributed(
                backend=mh.default_backend(mesh_lib.rank_device(device)))
        self.mesh = mesh_lib.make_mesh(device)
        self.device, self.n_devices = self.mesh.device, self.mesh.world
        self.is_chief = self.mesh.rank == 0  # the rank that writes the run directory
        if self.mesh.parallel:
            log.info("data parallel: rank %d of %d on %s", self.mesh.rank, self.mesh.world,
                     self.device)
        os.makedirs(os.path.join(log_dir, "train_log", "loss"), exist_ok=True)
        if self.is_chief:
            hparams.dump(os.path.join(log_dir, "hparams.json"))

        self.model = mesh_lib.replicate(self.mesh, init_params(model, self.seed).to(self.device))
        set_data_mesh(self.model, self.mesh if self.mesh.parallel else None)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        (self.optimizer, self.lr_fn, self.beta1_fn, self.sched_mode,
         self.base_lr) = make_optimizer(hparams, self.params)
        self.grad_clip = (hparams.get("trainer") or {}).get("grad_clip")
        self.scalers = {name: L.ScalerState.init(self.device)
                        for name in scaler_names(self.model.face_type)}
        self.step = 0   # global optimization steps taken
        self.epoch = 0
        self.dropout_gen = torch.Generator(device=self.device)
        set_dropout_generator(self.model, self.dropout_gen)
        self.loss_fn = make_loss_fn(self.model, hparams, self.mesh)
        self._uploads = PinnedUploads()
        # TensorBoard events: written by the chief rank alone, disabled elsewhere
        self.summary = summary_lib.SummaryHelper(
            os.path.join(log_dir, "train_log", "tb") if self.is_chief else None)
        self._plot_feat_spec = None  # built on the first raw-mode batch plot_forward sees
        if self.is_chief:
            self._dump_params_info()
        if load_from:
            self.load(load_from)

    def _dump_params_info(self):
        lines, total = [], 0
        for name, p in sorted(self.model.named_parameters()):
            total += p.numel()
            lines.append(f"{name.replace('.', '/')}  {tuple(p.shape)}  {p.numel()}")
        lines.append(f"TOTAL: {total}")
        with open(os.path.join(self.log_dir, "params_info.txt"), "w") as fp:
            fp.write("\n".join(lines) + "\n")
        log.info("model parameters: %s", f"{total:,}")

    # -- steps ---------------------------------------------------------------
    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows (numpy arrays or tensors) → tensors on its device,
        through pinned memory on a card; tensors already on the device pass
        through, host-only entries are left out."""
        return mh.global_batch_from_local({k: v for k, v in batch.items() if k not in HOST_ONLY},
                                          self.device, self._uploads.put)

    def current_lr(self) -> Tuple[float, float]:
        """(lr, beta1) for the next step. In step mode the schedule is read
        at ``step + 1``: the first optimization step sees counter 1, not 0."""
        it = self.epoch if self.sched_mode == "epoch" else self.step + 1
        return self.lr_fn(it), (self.beta1_fn(it) if self.beta1_fn else 0.9)

    def train_step(self, batch, dropout_seed: Optional[int] = None) -> Dict[str, Any]:
        """One optimization step; returns the loss scalars and terms, the
        gradient norm (before clipping) as 0-dim device tensors, and lr.
        The gradients stay on the parameters until the next step. The four
        ``record_function`` spans name the stages in a ``torch.profiler`` trace.
        The dropout generator is seeded with ``step_seed(seed, step)`` unless
        ``dropout_seed`` says otherwise (an aux loader's step)."""
        with record_function("train/upload"):
            batch = self.put_batch(batch)
        lr, b1 = self.current_lr()
        for group in self.optimizer.param_groups:
            group["lr"], group["betas"] = lr, (b1, group["betas"][1])
        self.dropout_gen.manual_seed(step_seed(self.seed, self.step) if dropout_seed is None
                                     else dropout_seed)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with record_function("train/forward_loss"):
            total, aux = self.loss_fn(self.scalers, batch, True)
        with record_function("train/backward"):
            total.backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.mesh.parallel:
            # one flat all-reduce after backward rather than DistributedDataParallel:
            # the model stays unwrapped (its state_dict names, set_dropout_generator),
            # BatchNorm's statistics are already global, and the step is bit-equal
            # on every rank. DDP would overlap the reduction with the backward, which
            # pays only where the reduction is on the step's critical path
            with record_function("train/all_reduce"):
                mesh_lib.average_gradients(grads, self.mesh)
        with record_function("train/clip_adam"):
            grad_norm = global_norm(grads)
            if self.grad_clip:
                clip = float(self.grad_clip)
                scale = clip / torch.clamp(grad_norm, min=clip)  # g · c / max(‖g‖, c)
                for g in grads:
                    g.mul_(scale)
            self.optimizer.step()
        self.scalers = aux["new_scalers"]
        self.step += 1
        metrics = {k: v.detach() for k, v in {**aux["scalars"], **aux["loss_terms"]}.items()}
        if self.mesh.parallel:  # the global means, in one all-reduce
            keys = sorted(metrics)
            means = mesh_lib.mean_over_ranks(torch.stack([metrics[k] for k in keys]), self.mesh)
            metrics = dict(zip(keys, means))
        return {**metrics, "grad_norm": grad_norm, "lr": lr}

    @torch.no_grad()
    def plot_forward(self, batch) -> Dict[str, Any]:
        """The model's outputs for the plot plugins: ``prediction`` (as the
        JAX model returns it: face data for the ``face_data`` prediction type,
        which training uses, else the heads' raw PCA coefficients),
        ``latent`` (the encoder's output), ``align_dict`` and ``audio_feat``
        (a raw-mode batch featurized on the device as in the loss), tensors on
        the device. The model runs in eval mode (BatchNorm on its running
        statistics, no dropout) and goes back to its mode after.

        The JAX trainer splits a key off ``exp.rng`` for each call
        (``sdfa_tpu/train/trainer.py:713``); in eval mode nothing draws from
        it, and here nothing draws at all, so no later step's result depends
        on how many plots ran."""
        batch = self.put_batch(batch)
        if "raw_wav" in batch:
            if self._plot_feat_spec is None:
                self._plot_feat_spec = FeatureSpec.from_hparams(self.hp)
            audio_feat = device_train_features(*(batch[k] for k in RAW_KEYS),
                                               spec=self._plot_feat_spec)
        else:
            audio_feat = batch["audio_feat"]
        was_training = self.model.training
        self.model.eval()
        try:
            preds, z, aligns = self.model.forward_latent(
                audio_feat, batch["speaker_id"], raw_pca=self.model.pred_type != "face_data")
        finally:
            self.model.train(was_training)
        return dict(prediction=preds, latent=z, align_dict=aligns, audio_feat=audio_feat)

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        _, aux = self.loss_fn(self.scalers, self.put_batch(batch), False)
        return {**aux["scalars"], **aux["loss_terms"]}

    # -- metric IO -----------------------------------------------------------
    def write_metrics(self, tag: str, metrics: Dict[str, float], step: int):
        if not self.is_chief:
            return
        rec = {"tag": tag, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(os.path.join(self.log_dir, "train_log", "metrics.jsonl"), "a") as fp:
            fp.write(json.dumps(rec) + "\n")

    def write_loss_csv(self, history):
        """Rewrite epoch-loss.csv from the per-epoch rows."""
        if not history or not self.is_chief:
            return
        keys = sorted({k for row in history for k in row if k != "epoch"})
        path = os.path.join(self.log_dir, "train_log", "loss", "epoch-loss.csv")
        with open(path, "w", newline="") as fp:
            writer = csv.writer(fp)
            writer.writerow(["epoch"] + keys)
            for row in history:
                writer.writerow([row.get("epoch")] + [row.get(k, "") for k in keys])

    # -- checkpoint IO -------------------------------------------------------
    def payload(self) -> Dict[str, Any]:
        return dict(epoch=self.epoch, global_step=self.step,
                    model=self.model.state_dict(), optimizer=self.optimizer.state_dict(),
                    scalers={k: (v.vt, v.beta_t) for k, v in self.scalers.items()})

    def save(self, max_nb: int = 10) -> Optional[str]:
        """The checkpoint's path; None on every rank but 0, which alone writes."""
        if not self.is_chief:
            return None
        return ckpt_io.save_checkpoint(self.log_dir, self.payload(), self.epoch, self.step,
                                       max_nb=max_nb)

    def save_best(self, metric_name: str, value: float) -> Optional[str]:
        if not self.is_chief:
            return None
        return ckpt_io.save_best(self.log_dir, self.payload(), metric_name, value,
                                 self.epoch, self.step)

    def load(self, path: str):
        # read on the host: load_state_dict moves tensors to their parameters' device
        # and leaves Adam's step counters on the host, where a fresh optimizer has them
        payload = ckpt_io.load_checkpoint(path)
        if sorted(payload["scalers"]) != sorted(self.scalers):
            raise ValueError(
                f"{path} was trained with the loss scalers {sorted(payload['scalers'])}, of "
                f"another face type than this {self.model.face_type!r} model's "
                f"{sorted(self.scalers)}")
        self.model.load_state_dict(payload["model"], strict=True)
        mesh_lib.replicate(self.mesh, self.model)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scalers = {k: L.ScalerState(vt=v[0].to(self.device), beta_t=v[1].to(self.device))
                        for k, v in payload["scalers"].items()}
        self.epoch, self.step = int(payload["epoch"]), int(payload["global_step"])
        log.info("restored checkpoint from %s (epoch %d)", path, self.epoch)


def _to_host(step_metrics: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Per-step metric dicts (0-dim device tensors and floats) → floats, with
    one device round trip for the whole list."""
    if not step_metrics:
        return []
    keys = [k for k, v in step_metrics[0].items() if torch.is_tensor(v)]
    table = torch.stack([torch.stack([m[k].float() for k in keys])
                         for m in step_metrics]).cpu().numpy()
    return [{**{k: float(v) for k, v in m.items() if not torch.is_tensor(v)},
             **dict(zip(keys, map(float, row)))} for m, row in zip(step_metrics, table)]


def _mean(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]} if rows else {}


class Trainer:
    """Epoch loop with a hook registry, save cadences, validation, the resume
    of the loss history and aux loaders: each cycles forever and adds one
    optimization step after every main step (counted in the global step;
    its metrics are not kept).

    Data parallel: every loader, main, aux and validation, yields this rank's
    rows of each global batch (``parallel.shard_batch``, or a reader's
    ``shard=``), and every control decision is the same on every rank: the
    ranks agree that each has a batch before a step (a rank that took one more
    step would block the collectives), and validation metrics are means over
    the ranks, so the schedule, the best checkpoint and the epoch's end agree."""

    _hooks: Dict[str, list] = {k: [] for k in (
        "prev_train", "post_train", "prev_valid", "post_valid", "prev_epoch", "post_epoch")}

    @classmethod
    def register_hook(cls, point: str):
        if point not in cls._hooks:
            raise ValueError(f"unknown hook point: {point}")

        def deco(fn):
            cls._hooks[point].append(fn)
            return fn

        return deco

    def __init__(self, experiment: Experiment, train_loader, valid_loader=None,
                 aux_loaders: Optional[Dict[str, Any]] = None):
        self.exp = experiment
        self.train_loader, self.valid_loader = train_loader, valid_loader
        self.aux_loaders = dict(aux_loaders or {})
        self._aux_iters: Dict[str, Any] = {}
        self.aux_steps = 0  # steps taken on aux loaders' batches, every epoch
        hp_tr = experiment.hp.trainer
        self.max_epochs = int(hp_tr.get("max_epochs", 100))
        self.save_gap_epochs = hp_tr.get("save_gap_epochs")
        self.save_gap_steps = int(hp_tr.get("save_gap_steps", 0) or 0)
        if self.save_gap_epochs and self.save_gap_steps:
            raise ValueError("set save_gap_epochs or save_gap_steps, not both (the default "
                             "config sets save_gap_epochs=10: override it with None to "
                             "save by steps)")
        # a gap of 0 / None disables validation; the shipped configs set 0 on purpose
        self.valid_gap_epochs = int(hp_tr.get("valid_gap_epochs", 0) or 0)
        self.metric_name = hp_tr.get("reference_metric", "ploss")
        self.metric_larger = bool(hp_tr.get("reference_metric_larger", False))
        self.best_metric = None
        self.plot_gap_steps = int(hp_tr.get("plot_gap_steps", 0) or 0)
        self.eval_gap_epochs = int(hp_tr.get("eval_gap_epochs", 0) or 0)
        if self.eval_gap_epochs and experiment.is_chief and self._eval_sources():
            # the evaluation writes video: a host without OpenCV is told now, not
            # after the first epochs (the JAX trainer catches the failure and trains on)
            from ..viewer import video

            video.require_video()
        self.step_metrics: List[Dict[str, float]] = []  # the last epoch's, one dict per step
        self._history: Optional[List[dict]] = None
        self._steps_seen = 0
        self.loader_wait_s = 0.0  # time spent waiting on the train loader, over the run
        # a profiler capture window: trainer.profile = {dir, start_step=10, num_steps=5}
        prof = hp_tr.get("profile") or {}
        self.profile_dir = prof.get("dir") if experiment.is_chief else None
        self.profile_start = int(prof.get("start_step", 10) or 0)
        self.profile_steps = int(prof.get("num_steps", 5) or 5)
        self.profile_trace: Optional[str] = None  # the trace file, once written
        self._capture = None

    def _load_loss_history(self):
        """Prior epochs' loss rows from the run directory; rows at or past the
        resumed epoch are dropped, they will be trained again."""
        path = os.path.join(self.exp.log_dir, "train_log", "loss", "epoch-loss.csv")
        if not os.path.exists(path):
            return []
        rows = []
        with open(path, newline="") as fp:
            for row in csv.DictReader(fp):
                try:
                    epoch = int(row["epoch"])
                except (KeyError, ValueError):
                    continue
                if epoch >= self.exp.epoch:
                    continue
                parsed = {"epoch": epoch}
                for k, v in row.items():
                    if k == "epoch" or v in ("", None):
                        continue
                    try:
                        parsed[k] = float(v)
                    except ValueError:
                        parsed[k] = v
                rows.append(parsed)
        return rows

    def _run_hooks(self, point: str, **kwargs):
        for fn in self._hooks[point]:
            fn(self.exp, **kwargs)

    def _eval_sources(self) -> list:
        """The ``trainer.evaluate.test`` sources whose wav or sentence exists."""
        sources = (self.exp.hp.trainer.get("evaluate") or {}).get("test") or []
        return [s for s in sources if os.path.exists(str(s[0]))]

    def _evaluate_mid_training(self):
        """Video of every evaluation source from the live weights, into
        ``<log_dir>/eval_at_train/epochNNNN`` (reference trainer.py:494-497).
        Nothing to do without a source; a failure propagates."""
        sources = self._eval_sources()
        if not sources or not self.exp.is_chief:
            return
        from ..task import AnimationTask

        exp = self.exp
        task = AnimationTask(exp.hp, exp.model, exp.device)
        task.evaluate(sources, output_dir=os.path.join(exp.log_dir, "eval_at_train",
                                                       f"epoch{exp.epoch:04d}"),
                      export_mesh_frames=False)

    def _plot(self, batch: Dict[str, torch.Tensor], host_extra: Dict[str, Any]):
        """``plot_forward`` on the step's device batch, then the plot plugins
        on its host copy (with the host-only entries) and the outputs."""
        exp = self.exp
        outputs = exp.plot_forward(batch)
        if not exp.summary.enabled:
            return
        def to_host(t):
            return t.detach().cpu().numpy()

        host_batch = {**{k: to_host(v) for k, v in batch.items()}, **host_extra}
        host_out = {k: ({n: to_host(t) for n, t in v.items()} if isinstance(v, dict)
                        else to_host(v)) for k, v in outputs.items()}
        summary_lib.run_plot_plugins(exp.summary, exp, host_batch, host_out, exp.step)

    def _is_better(self, value: float) -> bool:
        if self.best_metric is None:
            return True
        return value > self.best_metric if self.metric_larger else value < self.best_metric

    def train(self):
        exp = self.exp
        log.info("training on %s", exp.device)
        while exp.epoch < self.max_epochs:
            self._run_hooks("prev_epoch", epoch=exp.epoch)
            t0 = time.time()
            train_metrics = self._train_epoch()
            if not train_metrics:
                log.info("no batches this epoch: stopping")
                break
            row = {"epoch": exp.epoch, **{f"train_{k}": v for k, v in train_metrics.items()}}
            if (self.valid_loader is not None and self.valid_gap_epochs > 0
                    and (exp.epoch + 1) % self.valid_gap_epochs == 0):
                valid_metrics = self._validate()
                row.update({f"valid_{k}": v for k, v in valid_metrics.items()})
                metric = valid_metrics.get("scalar_" + self.metric_name,
                                           valid_metrics.get(self.metric_name))
                if metric is not None and self._is_better(metric):
                    self.best_metric = metric
                    exp.save_best(self.metric_name, metric)
            if self._history is None:
                # a resumed run keeps the loss history the csv already holds
                self._history = self._load_loss_history()
            self._history.append(row)
            exp.write_loss_csv(self._history)
            exp.epoch += 1
            if self.save_gap_epochs and exp.epoch % int(self.save_gap_epochs) == 0:
                exp.save()
            if self.eval_gap_epochs and exp.epoch % self.eval_gap_epochs == 0:
                self._evaluate_mid_training()
            exp.summary.flush()  # the writer buffers: make each epoch visible
            self._run_hooks("post_epoch", epoch=exp.epoch)
            log.info("epoch %d/%d done in %.1fs train_ploss=%.5f", exp.epoch, self.max_epochs,
                     time.time() - t0, train_metrics.get("scalar_ploss", float("nan")))
        if self.profile_dir and self.profile_trace is None:
            log.warning("profile window never opened: start_step=%d but only %d steps ran",
                        self.profile_start, self._steps_seen)
        exp.save()
        log.info("trained %d steps; kernel launches in this process: freq_lstm %d, bilstm2 %d, "
                 "training core forward %d, backward %d", exp.step, freq_lstm.LAUNCHES.total(),
                 sum(bilstm2.LAUNCHES.values()), bilstm_core.FWD_LAUNCHES,
                 bilstm_core.BWD_LAUNCHES)
        mesh_lib.barrier(exp.mesh)  # the run's files are written when train() returns

    def _agreed(self, batch):
        """``batch``. Under a mesh the ranks agree first that each has one or
        that none has (at an epoch's end); ``all_ranks_agree`` raises on every
        rank where they differ: their loaders are out of step."""
        if self.exp.mesh.parallel and not mesh_lib.all_ranks_agree(batch is not None,
                                                                   self.exp.mesh):
            return None
        return batch

    def _next_aux(self, name: str):
        """The next batch of aux loader ``name``, started again at its end;
        None if it yields nothing at all."""
        it = self._aux_iters.get(name)
        if it is None:
            it = self._aux_iters[name] = iter(self.aux_loaders[name])
        batch = next(it, None)
        if batch is None:
            self._aux_iters[name] = iter(self.aux_loaders[name])
            batch = next(self._aux_iters[name], None)
        return self._agreed(batch)

    def _aux_steps(self, main_step: int):
        """One step per aux loader after the main step ``main_step``."""
        for index, name in enumerate(self.aux_loaders):
            batch = self._next_aux(name)
            if batch is not None:
                self.exp.train_step(batch, dropout_seed=step_seed(self.exp.seed, main_step,
                                                                  1_000_003 + index))
                self.aux_steps += 1

    def _stop_profile(self):
        self.profile_trace = profiling.stop_trace(self._capture)
        self._capture = None

    def _fetch_put(self, loader_it):
        """(the next batch with its upload enqueued, its host-only entries),
        or None at the end of the epoch; the wait on the loader is counted in
        ``loader_wait_s``. The host-only entries (``HOST_ONLY``) are kept for
        the plot plugins only when plotting is on."""
        t0 = time.perf_counter()
        batch = next(loader_it, None)
        self.loader_wait_s += time.perf_counter() - t0
        if self._agreed(batch) is None:
            return None
        host_extra = ({k: batch[k] for k in HOST_ONLY if k in batch} if self.plot_gap_steps
                      else {})
        return self.exp.put_batch(batch), host_extra

    def _train_epoch(self) -> Dict[str, float]:
        exp = self.exp
        device_metrics = []  # stay on the device; fetched once at the epoch's end
        self._run_hooks("prev_train", epoch=exp.epoch)
        t_start, wait_start, stamps = time.perf_counter(), self.loader_wait_s, []
        loader_it = iter(self.train_loader)
        pending = self._fetch_put(loader_it)
        while pending is not None:
            batch, host_extra = pending
            if (self.profile_dir and self.profile_trace is None and self._capture is None
                    and self._steps_seen == self.profile_start):
                self._capture = profiling.start_trace(self.profile_dir,
                                                      cuda=exp.device.type == "cuda")
            stamps.append(time.perf_counter())
            metrics = exp.train_step(batch)
            # batch k + 1 is fetched and its upload enqueued behind step k's
            # kernels before anything of step k is read
            pending = self._fetch_put(loader_it)
            self._aux_steps(exp.step - 1)
            device_metrics.append(metrics)
            self._steps_seen += 1
            if self.save_gap_steps and self._steps_seen % self.save_gap_steps == 0:
                exp.save()
            if len(device_metrics) % METRICS_EVERY == 0:
                values = _to_host([metrics])[0]
                exp.write_metrics("train", values, exp.step)
                exp.summary.scalar("train", values, exp.step)
            if (self.plot_gap_steps and exp.is_chief
                    and len(device_metrics) % self.plot_gap_steps == 0):
                self._plot(batch, host_extra)
            if (self._capture is not None
                    and self._steps_seen >= self.profile_start + self.profile_steps):
                self._stop_profile()
        self._run_hooks("post_train", epoch=exp.epoch)
        if self._capture is not None:  # the epoch ended inside the window: flush it
            self._stop_profile()
        self.step_metrics = _to_host(device_metrics)
        if stamps:
            intervals = np.diff(stamps)
            exp.write_metrics("timing", {
                "wall_s": time.perf_counter() - t_start, "steps": len(stamps),
                "loader_wait_s": self.loader_wait_s - wait_start,
                "step_interval_median_s": float(np.median(intervals)) if len(intervals)
                else float("nan")}, exp.step)
        return _mean(self.step_metrics)

    def _validate(self) -> Dict[str, float]:
        exp = self.exp
        self._run_hooks("prev_valid", epoch=exp.epoch)
        rows = _to_host([exp.eval_step(batch) for batch in self.valid_loader])
        self._run_hooks("post_valid", epoch=exp.epoch)
        out = _mean(rows)
        if exp.mesh.parallel:  # equal shards: the mean of the ranks' means
            out = mesh_lib.host_mean(out, exp.mesh)
        exp.write_metrics("valid", out, exp.step)
        return out
