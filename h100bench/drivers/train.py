"""Training in the ``Trainer``'s loop shape: the raw-mode reader
(``DatasetSlidingWindow.raw_batches`` on a ``ThreadPrefetchIterable``, no
worker processes), ``Experiment.put_batch`` enqueued behind the previous step,
``Experiment.train_step`` with the ``Trainer``'s step seeds, a new epoch where
the reader's ends.

Set-up builds one ``Experiment`` over the corpus (``h100bench/dataset.py``),
loads the seeded weights, and drives its first ``check_steps`` steps through
the window's own loop and feed; the plain reference follows those steps from
the same weights and batches once the window has closed, after its reader
(``reference/reader.py``) has rebuilt those batches from the corpus files and
the reader's random stream. Windows count when their step has completed: the
window ends on a synchronize."""

from __future__ import annotations

import copy
import json
import os
import time
from contextlib import nullcontext
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import dataset, program


class Loop:
    """The Trainer's fetch-then-step loop over epochs of the reader."""

    def __init__(self, exp, loader):
        self.exp, self.loader = exp, loader
        self.it = iter(loader)
        self.wait_s = 0.0
        self.epochs = 1

    def fetch(self):
        """(host batch, its upload enqueued), a new epoch where one ends; the
        wait on the reader is counted."""
        t0 = time.perf_counter()
        with record_function("bench/next_batch"):
            host = next(self.it, None)
            if host is None:
                self.it = iter(self.loader)
                self.epochs += 1
                host = next(self.it)
        self.wait_s += time.perf_counter() - t0
        return host, self.exp.put_batch(host)


def corpus_pca(root: str, face_type: str) -> Dict[str, np.ndarray]:
    if face_type == "dgrad_3d":
        return {f"{n}_pca.{m}": np.load(os.path.join(root, "pca", f"{n}_{m}.npy"))
                for n in ("scale", "rotat") for m in ("compT", "means")}
    return {f"pca.{m}": np.load(os.path.join(root, "pca", f"{m}.npy")) for m in ("compT", "means")}


def inputs(env):
    """(hparams over the corpus, the seeded weights with the corpus's PCA
    bases, the trained parameters' names, the reader): what the program and
    the reference both start from."""
    from sdfa_tpu_torch.data import DatasetSlidingWindow

    mix = env.mix
    hp = program.hparams(env.cfg)
    face_type = hp.model.face_data_type
    c = mix["corpus"]
    root = dataset.corpus(os.path.join(env.root, "build", "h100bench_data"), face_type,
                          int(c["sentences"]), float(c["seconds"]))
    prefix = "{DATASET_ANIME_ROOT}/pca/"
    pca_paths = ({"pca_scale": [prefix + "scale_compT.npy", prefix + "scale_means.npy"],
                  "pca_rotat": [prefix + "rotat_compT.npy", prefix + "rotat_means.npy"]}
                 if face_type == "dgrad_3d" else {"pca": [prefix + "compT.npy", prefix + "means.npy"]})
    hp.overwrite_by({"seed": env.seed, "dataset_anime": {"root": root},
                     "trainer": {"pca_targets": True,
                                 "anime_loader": {"batch_size": int(mix["batch_pairs"])}},
                     "model": {"output": pca_paths}})
    hp.replace_variable("DATASET_ANIME_ROOT", root)
    model, state = program.model_and_state(hp, env.seed, env.device,
                                           pca=corpus_pca(root, face_type))
    params = [n for n, p in model.named_parameters() if p.requires_grad]
    return hp, model, state, params, DatasetSlidingWindow(hp, training=True)


def run(env) -> Dict:
    from sdfa_tpu_torch.data.thread_prefetch import ThreadPrefetchIterable
    from sdfa_tpu_torch.train.trainer import Experiment

    mix, dev = env.mix, env.device
    hp, model, state, params, train_set = inputs(env)
    pairs = int(mix["batch_pairs"])
    n_check = int(mix["check_steps"])
    drawn = record_items(train_set, pairs * n_check)
    log_dir = os.path.join(env.tmpdir, "h100bench_train")
    exp = Experiment(hp, model, log_dir=log_dir, device=dev, seed=env.seed)
    exp.model.load_state_dict(state)  # the seeded weights, over the program's own init

    class Epochs:
        def __iter__(self):
            return train_set.raw_batches(pairs)

    loop = Loop(exp, ThreadPrefetchIterable(Epochs()))

    # the first steps, through the window's own loop: what the reference follows
    before = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    batches, losses, first_grad = [], [], None
    pending = loop.fetch()
    for i in range(n_check):
        host, batch = pending
        batches.append(host)
        metrics = exp.train_step(batch)
        pending = loop.fetch()
        losses.append(metrics["total"].detach().clone())
        if i == 0:  # the first gradient as Adam holds it: m = (1 - beta1) g
            b1 = exp.optimizer.param_groups[0]["betas"][0]
            named = dict(exp.model.named_parameters())
            state_of = {k: exp.optimizer.state.get(named[k], {}) for k in params}
            first_grad = {k: (state_of[k]["exp_avg"].detach() / (1 - b1) if "exp_avg" in state_of[k]
                              else torch.zeros_like(named[k])) for k in params}
    after = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < float(mix["warm_s"]):
        exp.train_step(pending[1])
        pending = loop.fetch()
    env.sync()
    setup_s = env.setup_done()

    steps, windows = 0, 0
    wait0, epochs0 = loop.wait_s, loop.epochs
    prof = env.profiler()
    with prof if prof is not None else nullcontext():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < env.seconds:
            with record_function("bench/step"):
                exp.train_step(pending[1])
                windows += len(pending[0]["speaker_id"])
                steps += 1
                pending = loop.fetch()
        env.sync()
        window_s = time.perf_counter() - t0
    trace = env.reduce_trace(prof, "bench/step")
    memory_peak = env.memory_peak()
    loader_wait_s = loop.wait_s - wait0
    counts = {"steps": steps, "windows": windows, "epochs": loop.epochs - epochs0,
              "rows": len(batches[0]["speaker_id"])}
    losses = [float(v) for v in losses]
    del loop, exp, model, pending
    env.free()

    t_ref = time.perf_counter()
    from ..reference.training import Step

    hpd = json.loads(json.dumps(hp))
    ref = Step(hpd, before, params, dev, env.seed)
    checks = compare(ref, batches, losses, first_grad, before, after, params)
    from ..reference.reader import Reader, compare as compare_reader

    checks.update(compare_reader(Reader(hpd, hpd["dataset_anime"]["root"]), batches,
                                 [drawn[i * pairs:(i + 1) * pairs] for i in range(n_check)]))
    env.note(setup_s=setup_s, window_s=window_s, reference_s=time.perf_counter() - t_ref,
             loader_wait_s=loader_wait_s, losses=losses, reference_losses=ref.losses,
             worst_leaf=ref.worst, **counts)
    return dict(setup_s=setup_s, e2e={"train_windows_per_s": windows / window_s}, counts=counts,
                host={"loader_wait_s": loader_wait_s}, trace=trace, window_s=window_s,
                model_flops=model_flops(ref, batches[0]), memory_peak=memory_peak,
                checks=checks, attempted=n_check, failed=0)


def record_items(reader, n: int) -> list:
    """Has the reader note, for each of its first ``n`` items, the window it
    reads and the state of its random stream before it: all the reference's
    reader needs to rebuild the item from the corpus files."""
    drawn, read = [], reader.raw_item

    def item(index):
        if len(drawn) < n:
            drawn.append((int(index), copy.deepcopy(reader._rng.bit_generator.state)))
        return read(index)

    reader.raw_item = item
    return drawn


def _norms(tensors: Dict[str, torch.Tensor], keys):
    return {k: float(torch.linalg.vector_norm(tensors[k].double())) for k in keys}


def compare(ref, batches, losses, first_grad, before, after, params) -> Dict[str, float]:
    """The numbers that decide ``correct``, over the program's first steps
    and the reference's from the same weights and batches: the widest
    relative gap of the steps' losses (the first step's alone says nothing:
    the dynamic scalers divide each term by itself there); by leaf, the gap
    between the program's and the reference's norm of the first gradient and
    of the parameters' change over the steps, each over the larger of the
    reference leaf's norm and the median leaf's, for the worst leaf and the
    median leaf. Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change: Adam moves them by rounding
    alone."""
    ref_losses, ref_grad = [], None
    for i, batch in enumerate(batches):
        loss, grads = ref.step(batch, i)
        ref_losses.append(loss)
        if i == 0:
            ref_grad = grads
    ref.losses = ref_losses
    g_ref, g_got = _norms(ref_grad, params), _norms(first_grad, params)
    g_med = float(np.median(list(g_ref.values())))
    grad = {k: abs(g_got[k] - g_ref[k]) / max(g_ref[k], g_med) for k in params}
    moved = [k for k in params if g_ref[k] >= 1e-3 * g_med]
    d_got = {k: float(torch.linalg.vector_norm((after[k] - before[k]).double())) for k in moved}
    d_ref = {k: float(torch.linalg.vector_norm(ref.net.w[k].detach().double()
                                               - before[k].double())) for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    change = {k: abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med) for k in moved}
    ref.worst = {"grad": max(grad, key=grad.get), "change": max(change, key=change.get)}
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_norm_gap": max(grad.values()),
        "grad_norm_gap_median": float(np.median(list(grad.values()))),
        "change_norm_gap": max(change.values()),
        "change_norm_gap_median": float(np.median(list(change.values()))),
    }


def model_flops(ref, batch) -> Dict[str, float]:
    """FLOPs of one training step of the reference (forward and backward),
    by ``FlopCounterMode``, on the first batch."""
    from torch.utils.flop_counter import FlopCounterMode

    b = {k: torch.as_tensor(np.asarray(v), device=ref.device) for k, v in batch.items()}
    with FlopCounterMode(display=False) as fc:
        total = ref.loss(b, 0)
        torch.autograd.grad(total, [ref.net.w[k] for k in ref.params])
    return {"step": fc.get_total_flops()}
