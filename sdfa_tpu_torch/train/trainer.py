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

On one card the step runs as one CUDA graph (``StepGraph``): the first step
warms up on a side stream, captures everything from the batch's static
inputs to Adam's update, puts the state back as it was and replays; every
later step copies its batch into the static inputs and replays. A step runs
eagerly, op by op, where it cannot replay (``graph_refusal``: a
data-parallel mesh, a CPU device, launch costs being counted, another batch
signature than the captured one); ``GRAPH_STEPS`` counts how each step ran.

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

import collections
import csv
import json
import logging
import os
import time
import weakref
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import _get_current_dispatch_mode

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
GRAPH_STEPS = collections.Counter()  # train steps by how they ran: capture, replay, eager:<reason>
GRAPH_WARMUP = 3  # steps on a side stream before a capture: library workspaces, Adam's state


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
            with record_function("train/features"):
                audio_feat = device_train_features(*(batch[k] for k in RAW_KEYS),
                                                   spec=feat_spec)
        else:
            audio_feat = batch["audio_feat"]
        with record_function("train/model"):
            preds, _ = model(audio_feat, batch["speaker_id"], decode=is_face_data)
        with record_function("train/loss_terms"):
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


def make_optimizer(hparams, params: Iterable[torch.nn.Parameter], capturable: bool = False):
    """Adam (AdamW when a weight decay is set or named); lr and beta1 are
    written into the param groups before every step. ``capturable``: the
    update reads its step counts on the device, as a CUDA graph needs; with
    a beta1 schedule it is also the per-parameter update, which takes beta1
    as a device tensor (the multi-tensor update reads a tensor beta1 back to
    the host, which a graph capture refuses).
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
    foreach = False if capturable and beta1_fn is not None else None
    if wd > 0 or name == "AdamW":
        # decoupled decay p ← p − lr·wd·p, the rule of the JAX package's optimizer
        optimizer = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=wd, capturable=capturable, foreach=foreach)
    else:
        optimizer = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                                     capturable=capturable, foreach=foreach)
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


def step_signature(batch: Dict[str, torch.Tensor]) -> tuple:
    """What a captured step is specialised on: the batch's keys, shapes and
    dtypes, and what picks a route or a library algorithm while the step is
    traced (``ops.plain_versions()``, the float32 precision flags)."""
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())),
            ops.using_plain(), torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


def graph_refusal(device: torch.device, parallel: bool, signature, graph) -> Optional[str]:
    """Why a step may not run through ``graph`` (a ``StepGraph``; None: no
    capture yet, the step may make one), or None where it may: ``parallel``
    (a data-parallel mesh: its collectives and agreements run on the host),
    ``device`` (not a card), ``mode`` (inside ``ops.count_costs()`` or a
    PyTorch dispatch mode: they see each op, a replay runs none),
    ``signature`` (not the captured step's ``step_signature``), ``capture``
    (the capture of this signature failed)."""
    if parallel:
        return "parallel"
    if device.type != "cuda":
        return "device"
    if ops.counting_costs() or _get_current_dispatch_mode() is not None:
        return "mode"
    if graph is None:
        return None
    if signature != graph.signature:
        return "signature"
    if graph.graph is None:
        return "capture"
    return None


class StepGraph(NamedTuple):
    """One train step captured in a CUDA graph, what it was captured for and
    the static tensors it reads and writes."""
    signature: tuple
    graph: Optional[torch.cuda.CUDAGraph]  # None: the capture failed
    inputs: Dict[str, torch.Tensor]  # the batch, copied in before each replay
    scalers: Dict[str, L.ScalerState]  # the dynamic scalers, updated by the replay
    out: Optional[torch.Tensor]  # the step's metrics, then grad_norm, stacked
    keys: Tuple[str, ...]  # their names
    grads: List[Optional[torch.Tensor]]  # the gradients the replay writes, by parameter
    launches: dict  # the kernel launches of one step (ops.launches_between)


def _after_optimizer_load(ref):
    """An ``optimizer.load_state_dict`` post hook: the loaded state tensors
    are new, so the experiment's graph is dropped and its optimizer fitted
    to the graph's device again."""
    def hook(optimizer):
        exp = ref()
        if exp is not None:
            exp._graph = None
            exp._fit_optimizer()
    return hook


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
    writes the run directory; every rank loads a checkpoint.

    On one card the step runs as a CUDA graph (``train_step``): Adam is
    capturable there, its lr the device tensor ``_lr`` and, under a beta1
    schedule, its beta1 the device tensor ``_beta1``, both filled before
    every step; the state the graph updates in place (parameters, buffers,
    Adam's state, the scalers) is the experiment's own. A checkpoint keeps
    the eager format. ``optimizer.load_state_dict`` (so ``load``) drops the
    graph: the next step captures anew."""

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
        # one card: the step may run as a CUDA graph, so Adam reads lr and its
        # step counts on the device from the start, eager steps too
        graphable = self.device.type == "cuda" and not self.mesh.parallel
        (self.optimizer, self.lr_fn, self.beta1_fn, self.sched_mode,
         self.base_lr) = make_optimizer(hparams, self.params, capturable=graphable)
        self._lr = torch.tensor(self.base_lr, device=self.device) if graphable else None
        self._beta1 = (torch.tensor(0.9, device=self.device)
                       if graphable and self.beta1_fn is not None else None)
        self._graph: Optional[StepGraph] = None
        self._grads_bound = True  # whether p.grad is the graph's gradient, for every parameter
        self._fit_optimizer()
        self.optimizer.register_load_state_dict_post_hook(_after_optimizer_load(weakref.ref(self)))
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
        The gradients stay on the parameters until the next step.
        The dropout generator is seeded with ``step_seed(seed, step)`` unless
        ``dropout_seed`` says otherwise (an aux loader's step).

        The step replays the captured ``StepGraph`` where ``graph_refusal``
        allows, inside a ``train/graph_replay`` span (the first such step
        captures it first, inside ``train/graph_capture``), and runs eagerly
        otherwise. ``record_function`` spans name the eager step's stages in a
        ``torch.profiler`` trace: ``train/upload``, ``train/zero_grad``,
        ``train/forward_loss`` (holding the loss function's
        ``train/features``, ``train/model`` and ``train/loss_terms``),
        ``train/backward``, ``train/all_reduce`` under a data-parallel mesh,
        and ``train/clip_adam``; a replay has ``train/upload`` alone."""
        with record_function("train/upload"):
            batch = self.put_batch(batch)
        lr, b1 = self.current_lr()
        for group in self.optimizer.param_groups:
            if self._lr is None:
                group["lr"] = lr
            if self._beta1 is None:
                group["betas"] = (b1, group["betas"][1])
        if self._lr is not None:
            self._lr.fill_(lr)
        if self._beta1 is not None:
            self._beta1.fill_(b1)
        self.dropout_gen.manual_seed(step_seed(self.seed, self.step) if dropout_seed is None
                                     else dropout_seed)
        self.model.train()
        signature = step_signature(batch) if self._lr is not None else None
        reason = graph_refusal(self.device, self.mesh.parallel, signature, self._graph)
        if reason is None:
            metrics = self._graph_step(batch, signature)
        else:
            GRAPH_STEPS["eager:" + reason] += 1
            metrics = self._eager_step(batch)
        self.step += 1
        return {**metrics, "lr": lr}

    def _update(self, batch, scalers):
        """zero_grad, forward and loss, backward, the gradient norm, clipping
        and Adam, in their stage spans: (the scalers' new states, the loss
        scalars and terms, the gradient norm before clipping)."""
        with record_function("train/zero_grad"):
            self.optimizer.zero_grad(set_to_none=True)
        with record_function("train/forward_loss"):
            total, aux = self.loss_fn(scalers, batch, True)
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
        metrics = {k: v.detach() for k, v in {**aux["scalars"], **aux["loss_terms"]}.items()}
        return aux["new_scalers"], metrics, grad_norm

    def _eager_step(self, batch) -> Dict[str, torch.Tensor]:
        new_scalers, metrics, grad_norm = self._update(batch, self.scalers)
        self.scalers = new_scalers
        self._grads_bound = False
        if self.mesh.parallel:  # the global means, in one all-reduce
            keys = sorted(metrics)
            means = mesh_lib.mean_over_ranks(torch.stack([metrics[k] for k in keys]), self.mesh)
            metrics = dict(zip(keys, means))
        return {**metrics, "grad_norm": grad_norm}

    def _graph_body(self, inputs, scalers) -> Tuple[torch.Tensor, Tuple[str, ...]]:
        """The captured step: ``_update`` on the static inputs and scalers, the
        scalers' new states written into the static ones, the metrics and the
        gradient norm stacked into one tensor. Returns (that tensor, names)."""
        new_scalers, metrics, grad_norm = self._update(inputs, scalers)
        for name, state in new_scalers.items():
            if state is not scalers[name]:
                scalers[name].vt.copy_(state.vt)
                scalers[name].beta_t.copy_(state.beta_t)
        values = [*metrics.values(), grad_norm]
        return torch.stack([v.float() for v in values]), (*metrics, "grad_norm")

    def _graph_step(self, batch, signature) -> Dict[str, torch.Tensor]:
        g = self._graph
        if g is None:
            with record_function("train/graph_capture"):
                g = self._graph = self._capture(batch, signature)
            GRAPH_STEPS["capture"] += 1
            if g.graph is None:
                GRAPH_STEPS["eager:capture"] += 1
                return self._eager_step(batch)
        for key, value in batch.items():
            g.inputs[key].copy_(value)
        if self.scalers is not g.scalers:  # set by an eager step or from outside
            for name, state in self.scalers.items():
                g.scalers[name].vt.copy_(state.vt)
                g.scalers[name].beta_t.copy_(state.beta_t)
            self.scalers = g.scalers
        with record_function("train/graph_replay"):
            g.graph.replay()
        if not self._grads_bound:  # an eager step gave the parameters gradients of its own
            for p, grad in zip(self.params, g.grads):
                p.grad = grad
            self._grads_bound = True
        ops.credit_launches(g.launches)
        GRAPH_STEPS["replay"] += 1
        return dict(zip(g.keys, g.out.clone().unbind()))

    def _capture(self, batch, signature) -> StepGraph:
        """Warm up ``GRAPH_WARMUP`` steps on a side stream on ``batch``,
        capture one, then put back every tensor they changed (parameters,
        buffers, Adam's state, the scalers; Adam's state that the warm-up
        created is zeroed, which is a fresh Adam's), the dropout seed, the
        device's default generator and the launch counters: the warm-up and
        the capture are not steps, and the kernel launches of one captured
        step are credited at each replay.
        Where the capture raises, the step and later ones of its signature
        run eagerly (``StepGraph.graph`` None), and the reason is logged."""
        dev = self.device
        scalers = {n: L.ScalerState(*(t.clone() for t in s)) for n, s in self.scalers.items()}
        inputs = {k: v.clone() for k, v in batch.items()}
        state = list(self.model.state_dict().values()) + [t for s in scalers.values() for t in s]
        for slot in self.optimizer.state.values():
            state += [v for v in slot.values() if torch.is_tensor(v)]
        saved = [t.clone() for t in state]
        had_state = set(self.optimizer.state)
        seed, tally = self.dropout_gen.initial_seed(), ops.launch_tally()
        default_rng = torch.cuda.get_rng_state(dev)
        graph, out, keys, launches = torch.cuda.CUDAGraph(), None, (), {}
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    self._graph_body(inputs, scalers)
            torch.cuda.current_stream(dev).wait_stream(side)
            before = ops.launch_tally()
            self.optimizer.zero_grad(set_to_none=True)  # the gradients come from the graph's pool
            graph.register_generator_state(self.dropout_gen)
            with torch.cuda.graph(graph):
                out, keys = self._graph_body(inputs, scalers)
            launches = ops.launches_between(before, ops.launch_tally())
        except Exception:  # noqa: BLE001 - logged, and the step runs eagerly
            log.warning("the train step of signature %s could not be captured in a CUDA graph; "
                        "its steps run eagerly", signature, exc_info=True)
            graph = None
            # a generator that the aborted capture registered stays in capture mode and
            # refuses eager draws: give it a fresh state (its seed is put back below)
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            for gen in (self.dropout_gen, torch.cuda.default_generators[index]):
                gen.graphsafe_set_state(torch.Generator(device=dev).graphsafe_get_state())
        finally:
            ops.restore_launches(tally)
            with torch.no_grad():
                for t, v in zip(state, saved):
                    t.copy_(v)
                for p, slot in self.optimizer.state.items():
                    if p not in had_state:
                        for v in slot.values():
                            if torch.is_tensor(v):
                                v.zero_()
            self.dropout_gen.manual_seed(seed)
            torch.cuda.set_rng_state(default_rng, dev)
        if graph is not None:
            self.scalers, self._grads_bound = scalers, True
            log.info("train step captured in a CUDA graph: %s", signature[0])
        return StepGraph(signature, graph, inputs, scalers, out, keys,
                         [p.grad for p in self.params], launches)

    def _fit_optimizer(self):
        """On one card: every param group's lr is the device tensor ``_lr``,
        its beta1 ``_beta1`` under a beta1 schedule (through the per-parameter
        update), and Adam's step counts live on the device, where a
        capturable Adam reads them. Runs at construction and after every
        ``optimizer.load_state_dict`` (``Experiment.load`` among them)."""
        if self._lr is None:
            return
        for group in self.optimizer.param_groups:
            group["capturable"], group["lr"] = True, self._lr
            if self._beta1 is not None:
                group["betas"], group["foreach"] = (self._beta1, group["betas"][1]), False
        for slot in self.optimizer.state.values():
            if "step" in slot:
                slot["step"] = slot["step"].to(self.device)

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
        opt = self.optimizer.state_dict()
        if self._lr is not None:
            # the eager format: lr and betas numbers, Adam's step counts on the host
            for group in opt["param_groups"]:
                group["lr"], group["capturable"], group["foreach"] = float(group["lr"]), False, None
                group["betas"] = tuple(float(b) for b in group["betas"])
            opt["state"] = {i: {k: (v.cpu() if k == "step" else v) for k, v in slot.items()}
                            for i, slot in opt["state"].items()}
        return dict(epoch=self.epoch, global_step=self.step,
                    model=self.model.state_dict(), optimizer=opt,
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
                 "training core forward %d, backward %d; collectives by op %s, their bytes %s; "
                 "train steps by path %s",
                 exp.step, freq_lstm.LAUNCHES.total(), sum(bilstm2.LAUNCHES.values()),
                 bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES, dict(mesh_lib.CALLS),
                 dict(mesh_lib.BYTES), dict(GRAPH_STEPS))
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
