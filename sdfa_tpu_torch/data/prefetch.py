"""Multiprocess batch prefetcher (counterpart of ``sdfa_tpu/data/prefetch.py``,
copied).

The reference feeds training from torch DataLoader worker processes
(api.py:45-54, num_workers=cpu/2 — the only multiprocess boundary in its
training stack, SURVEY.md §3.1).  This is the equivalent for our loader:
worker processes run the dataset's __getitem__+collate ahead of the
training step so host feature extraction overlaps device compute.

Design: forkserver workers each own a dataset replica (datasets are
picklable: config + manifest rows; the npz audio cache re-fills per
worker); worker w gets batches w, w + W, w + 2W, ... of the epoch as its
start argument, and a result queue returns collated numpy batches. Order is
not guaranteed (training shuffles anyway). The main process only reads the
result queue, so it runs no queue feeder thread that could outlive an epoch
cut short.

Why forkserver, not fork: the training process holds a CUDA context and
runs threads by the time the loader starts — fork() of a multithreaded
process can deadlock a child on an allocator/runtime lock (Python itself
warns), a forked child cannot use CUDA, and a child that dies this way
reports nothing. So workers only ever come from the forkserver, whose
server process starts FRESH (no CUDA, no threads); they run the numpy host
features only and never touch the card, and the dataset they unpickle holds
no tensor. Worker *preparation* imports the parent's ``__main__`` (CPython
runs ``spawn._main`` for forkserver workers too), so — exactly like torch's
DataLoader — entry scripts must guard loader iteration with
``if __name__ == "__main__":``; the all-workers-died error names this
remedy. A dataset class defined in a ``__main__`` that has no file (an
interactive session, ``python -c``) cannot reach a worker at all and is
refused before any worker starts. The server, and the resource tracker its
workers' queues register with, exit only after the process that started
them (each watches a pipe that process holds); ``stop_servers()`` stops
both and waits for them, for a program that must leave no process behind
when it returns. Worker exceptions travel
back as a (traceback text, repr) payload so the main process can re-raise
with the REAL failure site — a pickled exception alone loses its remote
traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import sys
import traceback
from typing import Iterator, Optional

import numpy as np

FORKSERVER_PRELOAD = ("sdfa_tpu_torch.data.sliding_window", "scipy.signal")

# workers start every epoch: the server imports the reader (torch) and scipy.signal
# (the Δ operators' fit) once, before its first fork, and each epoch's workers fork
# ready instead of paying those imports again
_CTX = mp.get_context("forkserver")
_CTX.set_forkserver_preload(list(FORKSERVER_PRELOAD))


class _WorkerFailure:
    """Picklable carrier for a worker-side exception + its traceback text."""

    def __init__(self, exc: BaseException):
        self.exc_repr = repr(exc)
        self.tb_text = traceback.format_exc()


def stop_servers():
    """Stops the forkserver the workers fork from and the resource tracker
    their queues register with, and waits until both have exited. Call it
    after the last loader; a later loader starts them again. CPython has no
    public call for this: these are the ones its own tests use."""
    import gc
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # a dropped epoch's queue unregisters its semaphores first
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _worker(dataset, work, result_q, seed: int):
    np.random.seed(seed)
    dataset._rng = np.random.default_rng(seed)
    for batch_id, indices in work:
        try:
            batch = dataset.collate([dataset[int(i)] for i in indices])
            result_q.put((batch_id, batch))
        except Exception as exc:  # surface worker errors to the main process
            result_q.put((batch_id, _WorkerFailure(exc)))


class PrefetchLoader:
    """Iterable over collated batches produced by worker processes."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 2,
                 shuffle: Optional[bool] = None, drop_last: bool = True,
                 prefetch_batches: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.num_workers = max(int(num_workers), 1)
        self.shuffle = dataset.training if shuffle is None else shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch_batches
        self._epoch = 0
        self._seed = seed
        self._workers = []

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def close(self):
        """Stops the workers of an epoch left unfinished (a loop that broke
        out early); an epoch run to its end stops its own."""
        for w in self._workers:
            w.terminate()
            w.join(timeout=2)
        self._workers = []

    def __iter__(self) -> Iterator[dict]:
        cls = type(self.dataset)
        if cls.__module__ == "__main__" and not hasattr(sys.modules["__main__"], "__file__"):
            raise RuntimeError(
                f"prefetch: the dataset class {cls.__name__} is defined in an interactive "
                f"__main__, which forkserver workers cannot import; define it in a module, "
                f"or in a script that iterates the loader under "
                f"`if __name__ == '__main__':`")
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(order)
        stop = len(order) - (self.batch_size - 1 if self.drop_last else 0)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, max(stop, 0), self.batch_size)
        ]
        work = list(enumerate(batches))
        result_q = _CTX.Queue(maxsize=self.prefetch * self.num_workers)
        workers = [
            _CTX.Process(
                target=_worker,
                args=(self.dataset, work[w::self.num_workers], result_q,
                      self._seed + self._epoch * 1000 + w),
                daemon=True,
            )
            for w in range(self.num_workers)
        ]
        self._epoch += 1
        self._workers = workers
        for w in workers:
            w.start()

        received = 0
        empty_after_exit = 0
        try:
            while received < len(batches):
                try:
                    bid, payload = result_q.get(timeout=5.0)
                except queue_mod.Empty:
                    # a worker can die without reporting (OOM-kill, _exit)
                    # — fail loudly instead of blocking forever. Workers
                    # that finished all their batches exit CLEANLY
                    # (exitcode 0) while their results may still be in the
                    # queue's feeder pipe on a loaded host, so a clean exit
                    # is NOT death (the round-3 full-suite flake was this
                    # false positive); only nonzero exitcodes are.
                    exited = [w for w in workers if not w.is_alive()]
                    abnormal = [w.pid for w in exited
                                if w.exitcode not in (0, None)]
                    if len(abnormal) == len(workers):
                        raise RuntimeError(
                            f"all {len(workers)} prefetch workers died "
                            f"(pids {abnormal}) with {len(batches) - received} "
                            f"batches outstanding. If they died at startup, "
                            f"the usual cause is an entry script without the "
                            f"`if __name__ == '__main__':` guard that "
                            f"forkserver workers require (see the worker "
                            f"stderr above)."
                        )
                    if len(exited) == len(workers):
                        # all exited (some cleanly) but batches are still
                        # outstanding: give the feeder pipes a generous
                        # grace window before declaring the data lost
                        empty_after_exit += 1
                        if empty_after_exit >= 6:  # ≥30 s of silence
                            raise RuntimeError(
                                f"all prefetch workers exited but "
                                f"{len(batches) - received} batches never "
                                f"arrived (abnormal exits: {abnormal or None})"
                            )
                    continue
                empty_after_exit = 0
                received += 1
                if isinstance(payload, _WorkerFailure):
                    raise RuntimeError(
                        f"prefetch worker failed on batch {bid}: "
                        f"{payload.exc_repr}\n--- worker traceback ---\n"
                        f"{payload.tb_text}"
                    )
                yield payload
        finally:
            self.close()
