"""Top-level API (counterpart of ``sdfa_tpu/api.py``; reference
speech_anime/api.py:12-197):

- ``train_model``: configure → log dir → datasets → model → Experiment → Trainer;
- ``evaluate_model``: configure → restore → ``AnimationTask.evaluate``;
- ``load_task``: a checkpoint on disk → an ``AnimationTask`` that serves, from
  the port's own checkpoints and from the reference framework's;
- ``trace_model`` / ``load_traced``: a self-contained dump (``hparams.json`` +
  ``model.pt``, a port checkpoint) that ``load_task`` reads, checked at dump time
  by one forward through the kernels on the card. XLA's ``hlo.txt`` and cost
  analysis have no counterpart, and the dump is no TorchScript or
  ``torch.export`` program: the kernels are ctypes launches from Python
  wrappers, which neither can capture.

Every entry point runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import datetime
import logging
import os
import zipfile
from typing import Optional

import torch

from .compat import convert_state_dict, init_params, load_flax_variables
from .compat.torch_ckpt import reference_state
from .config import ConfigDict, configure
from .data import DatasetSlidingWindow
from .models import build_model
from .task import AnimationTask
from .train import Experiment, Trainer
from .utils import ArgumentParser
from .utils.filesystem import maybe_in_dirs

log = logging.getLogger(__name__)


def _resolve_log_dir(hp, log_dir: Optional[str]):
    if log_dir:
        return log_dir
    date = datetime.datetime.now().strftime("%Y%m%d")
    return os.path.join("experiments", "results", f"[{date}]{hp.get('tag', 'run')}")


class _Loader:
    """Re-iterable wrapper of a batch-generator factory: one epoch per ``iter``."""

    def __init__(self, fn):
        self.fn = fn

    def __iter__(self):
        return self.fn()


def train_model(
    custom_hparams: Optional[str] = None,
    log_dir: Optional[str] = None,
    load_from: Optional[str] = None,
    dataset_root: Optional[str] = None,
    overrides: Optional[dict] = None,
    max_steps: Optional[int] = None,
    device="cuda",
):
    """Train from the dataset under ``dataset_root`` (the layout of
    ``data/synthetic.py`` and the VOCASET preprocessing); returns the
    ``Experiment``. ``max_steps`` caps the whole run, not one epoch. The card
    unless ``device`` says otherwise; under a launcher, the card of the
    process's ``LOCAL_RANK``.

    With ``trainer.multihost`` the processes of the launch train one model on
    one global batch of ``anime_loader.batch_size`` pairs: each reads its own
    pairs of every global batch (the readers' ``shard=``), with the reader in
    process (no ``PrefetchLoader`` workers). Launch:
    ``python -m torch.distributed.run --standalone --nproc_per_node N -m
    sdfa_tpu_torch train ... --overrides '{"trainer": {"multihost": true}}'``."""
    hp = configure(custom_hparams, overrides=overrides, dataset_root=dataset_root)
    log_dir = _resolve_log_dir(hp, log_dir)
    load_path = maybe_in_dirs(
        load_from, possible_roots=[log_dir], possible_exts=[".ckpt"]
    ) if load_from else None

    train_set = DatasetSlidingWindow(hp, training=True)
    valid_set = DatasetSlidingWindow(hp, training=False)
    log.info("train windows: %d, valid windows: %d", len(train_set), len(valid_set))

    model = build_model(hp)  # PCA bases from the dataset's pca/ files
    exp = Experiment(hp, model, log_dir=log_dir, device=device, load_from=load_path)

    # the collated batch is 2·bs windows (adjacent-frame doubling); under
    # multihost every rank reads its bs / world pairs of each global batch
    bs = int(hp.trainer.anime_loader.batch_size)
    shard = (exp.mesh.rank, exp.mesh.world) if exp.multihost else None

    # raw mode (default): the host ships raw windows + augmentation knobs, the
    # mel pipeline runs on the device (data/device_features.py); set
    # trainer.host_features=true for the bit-exact host feature path instead
    raw_mode = not bool(hp.trainer.get("host_features", False))
    batches_fn = (lambda ds, **kw: ds.raw_batches(bs, shard=shard, **kw)) if raw_mode else (
        lambda ds, **kw: ds.batches(bs, shard=shard, **kw))

    if raw_mode:
        # augmentations the device frontend does not implement fail loudly
        # instead of training without them
        fc = hp.audio.feature
        for opt in ("random_mel_noise", "random_mel_tremolo"):
            if fc.get(opt):
                raise NotImplementedError(
                    f"audio.feature.{opt} is not implemented in raw mode "
                    "(device features) — set trainer.host_features=true")
        if hp.trainer.anime_loader.get("multiple_workers"):
            log.warning("raw mode ignores anime_loader.multiple_workers "
                        "(device frontend needs no worker pool); set "
                        "trainer.host_features=true to use PrefetchLoader")

    multiple_workers = bool(hp.trainer.anime_loader.get("multiple_workers", False))
    if multiple_workers and shard is not None and not raw_mode:
        log.warning("multihost: each rank reads its pairs in process; "
                    "anime_loader.multiple_workers is ignored")
    if multiple_workers and max_steps is None and not raw_mode and shard is None:
        from .data.prefetch import PrefetchLoader

        n_workers = max((os.cpu_count() or 2) // 2, 1)
        train_loader = PrefetchLoader(train_set, bs, num_workers=n_workers)
        valid_loader = PrefetchLoader(valid_set, bs, num_workers=max(n_workers // 2, 1),
                                      shuffle=False)
    else:
        steps_done = {"n": 0}  # max_steps caps the whole run, not per epoch

        def _train_gen():
            for b in batches_fn(train_set):
                if max_steps is not None and steps_done["n"] >= max_steps:
                    break
                steps_done["n"] += 1
                yield b

        train_loader = _Loader(_train_gen)
        valid_loader = _Loader(lambda: batches_fn(valid_set, shuffle=False))
        if raw_mode and hp.trainer.get("thread_prefetch", True):
            # a daemon thread keeps 2 batches ready while the device steps
            from .data.thread_prefetch import ThreadPrefetchIterable

            train_loader = ThreadPrefetchIterable(train_loader)
            valid_loader = ThreadPrefetchIterable(valid_loader)

    Trainer(exp, train_loader=train_loader, valid_loader=valid_loader).train()
    return exp


def load_weights(model, ckpt_path: str):
    """Fill ``model`` (on the host) from a checkpoint file, read with
    ``weights_only=True``: the port's own (``train/checkpoints.py``, a payload
    with ``"model"``) or the reference framework's ({epoch, global_step,
    state} with ``_model.``-prefixed names, through ``compat/torch_ckpt.py``).
    Both are ``torch.save`` zip files, so the payload's keys tell them apart.
    The JAX package's msgpack checkpoints are refused."""
    if not zipfile.is_zipfile(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is not a torch checkpoint: a JAX (flax msgpack) checkpoint cannot "
            "be read by the port; load it with sdfa_tpu and carry its variables over with "
            "compat.load_flax_variables")
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if "model" in payload:
        model.load_state_dict(payload["model"], strict=True)
    elif "state" in payload:
        state, meta = reference_state(payload)
        params, stats, constants = convert_state_dict(state)
        if meta:
            log.info("reference checkpoint: epoch %s step %s", meta.get("epoch"),
                     meta.get("global_step"))
        load_flax_variables(model, {"params": params, "batch_stats": stats,
                                    "constants": constants})
    else:
        raise ValueError(f"{ckpt_path}: neither a port checkpoint (\"model\") nor a reference "
                         f"one (\"state\"); keys {sorted(payload)}")
    return model


def _restored_model(hp, load_from: Optional[str], seed: int = 1234):
    """The configured model with ``load_from``'s weights, PCA bases included;
    without a checkpoint, seeded weights and the config's bases."""
    model = build_model(hp, load_pca=load_from is None)
    if load_from is None:
        return init_params(model, seed)
    return load_weights(model, load_from)


def evaluate_model(
    custom_hparams: Optional[str] = None,
    load_from: Optional[str] = None,
    eval_input: Optional[str] = None,
    eval_spk_cond: Optional[str] = None,
    output_dir: Optional[str] = None,
    dataset_root: Optional[str] = None,
    overrides: Optional[dict] = None,
    device="cuda",
    **eval_kwargs,
):
    """Evaluate ``eval_input`` (a wav or a dataset sentence directory; else the
    config's ``trainer.evaluate.test`` list) into ``output_dir``; see
    ``AnimationTask.evaluate`` for ``eval_kwargs``."""
    hp = configure(custom_hparams, overrides=overrides, dataset_root=dataset_root)
    if eval_input is not None:
        hp.trainer.evaluate.set_key("test", [(eval_input, f"speaker={eval_spk_cond or 'm1'}")])
    task = AnimationTask(hp, _restored_model(hp, load_from), device)
    sources = [ArgumentParser(*args) for args in hp.trainer.evaluate.test]
    return task.evaluate(sources, output_dir=output_dir or "evaluate_results", **eval_kwargs)


def trace_model(
    custom_hparams: Optional[str] = None,
    load_from: Optional[str] = None,
    traced_dump_path: Optional[str] = None,
    dataset_root: Optional[str] = None,
    overrides: Optional[dict] = None,
    device="cuda",
) -> str:
    """Dump ``hparams.json`` and ``model.pt`` (``{"model": state_dict}``, the
    port's checkpoint payload) into ``traced_dump_path``, then
    run the forward once on ``device`` on the JAX package's example input (one
    window of zeros, speaker 0): on a card that builds the kernels and
    launches them, so that a failure shows now rather than at the first
    request. Returns the dump directory."""
    hp = configure(custom_hparams, overrides=overrides, dataset_root=dataset_root)
    model = _restored_model(hp, load_from)
    out = traced_dump_path or "traced_model"
    os.makedirs(out, exist_ok=True)
    torch.save({"model": model.state_dict()}, os.path.join(out, "model.pt"))
    hp.dump(os.path.join(out, "hparams.json"))

    task = AnimationTask(hp, model, device)  # full float32, eval mode, on the device
    frames, n_mels = int(hp.audio.feature.sliding_window_frames), int(hp.audio.mel.n_mels)
    with torch.inference_mode():
        preds, _, _ = task.model.forward_latent(
            torch.zeros(1, frames, n_mels, 3, device=task.device),
            torch.zeros(1, dtype=torch.long, device=task.device))
        anime = task.model.decode_to_anime(preds)
    if not bool(torch.isfinite(anime).all()):
        raise RuntimeError("trace_model: the example forward gave non-finite values")
    log.info("traced artifacts dumped to %s", out)
    return out


def load_task(ckpt_path: str, custom_hparams: Optional[str] = None,
              dataset_root: Optional[str] = None, overrides: Optional[dict] = None,
              device="cuda", **task_kwargs) -> AnimationTask:
    """Checkpoint → an ``AnimationTask`` ready to serve on ``device``.

    The hparams come from the run directory's ``hparams.json`` (``Experiment``
    writes it beside every checkpoint) unless ``custom_hparams`` is given. A
    pure reader: it writes nothing, builds no optimizer and reads no dataset
    (the PCA bases come from the checkpoint), so a read-only mount serves."""
    hp_json = os.path.join(os.path.dirname(os.path.abspath(ckpt_path)), "hparams.json")
    if custom_hparams is not None:
        hp = configure(custom_hparams, overrides=overrides, dataset_root=dataset_root)
    elif os.path.exists(hp_json):
        hp = ConfigDict.parse_file(hp_json)
        if dataset_root is not None:
            hp.dataset_anime.set_key("root", dataset_root)
        if overrides:
            hp.overwrite_by(overrides)
    else:
        raise FileNotFoundError(
            f"no hparams.json next to {ckpt_path}: pass custom_hparams (the default config "
            "would build a model unrelated to this checkpoint)")
    model = load_weights(build_model(hp, load_pca=False), ckpt_path)
    return AnimationTask(hp, model, device, **task_kwargs)


def load_traced(dump_dir: str, device="cuda", **task_kwargs) -> AnimationTask:
    """Rebuild an ``AnimationTask`` from a ``trace_model`` dump: ``load_task``
    of its ``model.pt`` with the ``hparams.json`` beside it."""
    return load_task(os.path.join(dump_dir, "model.pt"), device=device, **task_kwargs)
