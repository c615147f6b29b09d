"""Top-level API: ``train_model`` (counterpart of ``sdfa_tpu/api.py``; the
evaluate, trace and load entry points are not ported).

Reference: speech_anime/api.py:12-197. ``train_model``:
configure → log dir → datasets → model → Experiment → Trainer.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

from .config import configure
from .data import DatasetSlidingWindow
from .models import build_model
from .train import Experiment, Trainer
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
    unless ``device`` says otherwise."""
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

    # the collated batch is 2·bs windows (adjacent-frame doubling); one card
    # takes it whole, so the JAX package's rounding to the device count is moot
    bs = int(hp.trainer.anime_loader.batch_size)

    # raw mode (default): the host ships raw windows + augmentation knobs, the
    # mel pipeline runs on the device (data/device_features.py); set
    # trainer.host_features=true for the bit-exact host feature path instead
    raw_mode = not bool(hp.trainer.get("host_features", False))
    batches_fn = (lambda ds, **kw: ds.raw_batches(bs, **kw)) if raw_mode else (
        lambda ds, **kw: ds.batches(bs, **kw))

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
    if multiple_workers and max_steps is None and not raw_mode:
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
