"""The port's prefetchers: ``PrefetchLoader`` (forkserver workers running the
host features) and ``ThreadPrefetchIterable``. Mirrors
``tests/test_prefetch.py`` and ``tests/test_thread_prefetch.py``, with the
batches the workers send held to the in-process ones."""

import os
import sys
import threading
import time

import numpy as np
import pytest

from sdfa_tpu_torch.config import configure as tconfigure
from sdfa_tpu_torch.data import DatasetSlidingWindow as TReader
from sdfa_tpu_torch.data.prefetch import PrefetchLoader
from sdfa_tpu_torch.data.thread_prefetch import ThreadPrefetchIterable

from test_torch_data import N_TRIS, roots  # noqa: F401  (fixture)

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


def _port_reader(roots, training=False):  # noqa: F811
    return TReader(tconfigure("dgrad", dataset_root=roots[1]), training)


def _drain(loader, n):
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            break
    return out


def test_batches_arrive_and_match_schema(roots):  # noqa: F811
    ds = _port_reader(roots)
    batches = _drain(PrefetchLoader(ds, batch_size=4, num_workers=2, shuffle=False), 3)
    assert len(batches) == 3
    for b in batches:
        assert b["audio_feat"].shape == (8, 64, 128, 3)
        assert b["dgrad_3d_scale"].shape == (8, 1, N_TRIS, 6)
        assert b["speaker_id"].dtype == np.int32


def test_worker_batches_equal_in_process_ones(roots):  # noqa: F811
    """Eval mode has no randomness: the workers send exactly the in-process
    collations of the same index lists, bit for bit, each once (in any order);
    the in-process batches equal the JAX reader's (``tests/test_torch_data.py``)."""
    ds = _port_reader(roots)
    expected = [ds.collate([ds[int(j)] for j in range(i, i + 4)])
                for i in range(0, len(ds) - 3, 4)]
    got = list(PrefetchLoader(ds, batch_size=4, num_workers=2, shuffle=False))
    assert len(got) == len(expected)

    def index(batch):
        for k, want in enumerate(expected):
            if sorted(batch) == sorted(want) and all(np.array_equal(batch[key], want[key])
                                                     for key in want):
                return k
        raise AssertionError("a worker batch matches no in-process batch")

    assert sorted(map(index, got)) == list(range(len(expected)))


def test_workers_building_the_caches_at_once_read_them_whole(roots, tmp_path):  # noqa: F811
    """Four workers start on a dataset with no frame store yet and each builds
    it on its first item: every file is written whole, so every batch equals
    the in-process one and no temporary file is left."""
    import glob
    import shutil

    fresh = (roots[0], shutil.copytree(roots[1], str(tmp_path / "port")))
    for path in glob.glob(os.path.join(fresh[1], "data", "*", "*", "*_*.npy")):
        os.remove(path)  # the caches of the copied root
    ds = _port_reader(fresh)
    got = list(PrefetchLoader(ds, batch_size=1, num_workers=4, shuffle=False))
    ref = _port_reader(fresh)
    assert len(got) == len(ref)
    want = [ref.collate([ref[i]]) for i in range(len(ref))]
    for batch in got:
        assert any(all(np.array_equal(batch[k], w[k]) for k in w) for w in want)
    assert not glob.glob(os.path.join(fresh[1], "data", "*", "*", "*.tmp"))


def test_training_workers_draw_their_own_augmentation(roots):  # noqa: F811
    ds = _port_reader(roots, training=True)
    a, b = _drain(PrefetchLoader(ds, batch_size=2, num_workers=2, seed=3), 2)
    assert a["audio_feat"].shape == b["audio_feat"].shape == (4, 64, 128, 3)
    assert np.isfinite(a["audio_feat"]).all() and np.isfinite(b["audio_feat"]).all()


def test_len(roots):  # noqa: F811
    ds = _port_reader(roots)
    assert len(PrefetchLoader(ds, batch_size=7, num_workers=1)) == len(ds) // 7
    assert len(PrefetchLoader(ds, batch_size=7, num_workers=1, drop_last=False)) \
        == -(-len(ds) // 7)


class _SuicidalDataset:
    """Worker calls __getitem__ → os._exit: simulates a silently dying worker."""
    training = False
    _rng = None

    def __len__(self):
        return 8

    def __getitem__(self, i):
        os._exit(1)

    @staticmethod
    def collate(items):
        return items


class _FailingDataset:
    """__getitem__ raises: the original traceback must reach the caller."""
    training = False
    _rng = None

    def __len__(self):
        return 8

    def __getitem__(self, i):
        raise ValueError("synthetic failure inside __getitem__ marker-54321")

    @staticmethod
    def collate(items):
        return items


def test_worker_traceback_text_surfaces():
    with pytest.raises(RuntimeError) as err:
        for _ in PrefetchLoader(_FailingDataset(), batch_size=2, num_workers=1):
            pass
    msg = str(err.value)
    assert "marker-54321" in msg and "worker traceback" in msg and "__getitem__" in msg


def test_dead_workers_raise_instead_of_hanging():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="prefetch workers died"):
        for _ in PrefetchLoader(_SuicidalDataset(), batch_size=2, num_workers=2):
            pass
    assert time.time() - t0 < 60  # a liveness poll, not a hang


def test_dataset_of_an_interactive_main_is_refused(monkeypatch):
    """A class of a ``__main__`` without a file cannot reach a forkserver
    worker: refused before any worker starts, naming the guard."""
    import types

    monkeypatch.setitem(sys.modules, "__main__", types.ModuleType("__main__"))
    interactive = type("Interactive", (_FailingDataset,), {"__module__": "__main__"})
    loader = PrefetchLoader(interactive(), batch_size=2, num_workers=1)
    with pytest.raises(RuntimeError, match="if __name__ == '__main__'"):
        next(iter(loader))
    assert loader._workers == []


def test_close_stops_the_workers_of_an_unfinished_epoch(roots):  # noqa: F811
    loader = PrefetchLoader(_port_reader(roots), batch_size=2, num_workers=2, shuffle=False)
    it = iter(loader)
    next(it)
    workers = list(loader._workers)
    assert len(workers) == 2 and all(w.is_alive() for w in workers)
    loader.close()
    assert loader._workers == [] and not any(w.is_alive() for w in workers)
    it.close()


_STOP_SCRIPT = """
import os, sys
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.data import DatasetSlidingWindow
from sdfa_tpu_torch.data import prefetch


def children():
    me, found = os.getpid(), []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = open(f"/proc/{entry}/stat").read()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            found.append(int(entry))
    return found


if __name__ == "__main__":
    ds = DatasetSlidingWindow(configure("dgrad", dataset_root=sys.argv[1]), False)
    for _ in range(2):  # a loader after a stop starts the servers again
        for batch in prefetch.PrefetchLoader(ds, batch_size=2, num_workers=2, shuffle=False):
            break
        assert len(children()) == 2, children()  # the forkserver and the resource tracker
        prefetch.stop_servers()
        assert children() == [], children()
    print("no process left")
"""


def test_stop_servers_leaves_no_process(roots, tmp_path):  # noqa: F811
    """Without ``stop_servers`` the forkserver and the resource tracker exit
    only after the process that started them; with it, both are gone (and
    reaped) when it returns."""
    import subprocess

    script = tmp_path / "stop_servers.py"
    script.write_text(_STOP_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    run = subprocess.run([sys.executable, str(script), roots[1]], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith("no process left")


# -- ThreadPrefetchIterable ----------------------------------------------------------
class _Gen:
    def __init__(self, n, delay=0.0, fail_at=None):
        self.n, self.delay, self.fail_at = n, delay, fail_at

    def __iter__(self):
        for i in range(self.n):
            if self.fail_at is not None and i == self.fail_at:
                raise ValueError(f"worker boom at {i}")
            if self.delay:
                time.sleep(self.delay)
            yield {"i": i, "x": np.full((4,), i)}


def test_thread_order_and_completeness():
    out = list(ThreadPrefetchIterable(_Gen(20)))
    assert [b["i"] for b in out] == list(range(20))
    assert np.array_equal(out[7]["x"], np.full((4,), 7))


def test_thread_reiteration_gives_fresh_epochs():
    it = ThreadPrefetchIterable(_Gen(5))
    assert [b["i"] for b in it] == [0, 1, 2, 3, 4]
    assert [b["i"] for b in it] == [0, 1, 2, 3, 4]


def test_thread_overlaps_producer_with_consumer():
    n, d = 12, 0.03
    t0 = time.perf_counter()
    for _ in ThreadPrefetchIterable(_Gen(n, delay=d)):
        time.sleep(d)  # the consumer's work (the device step)
    assert time.perf_counter() - t0 < 1.6 * n * d  # serial would be about 2·n·d


def test_thread_worker_exception_propagates_with_message():
    with pytest.raises(ValueError, match="worker boom at 3"):
        list(ThreadPrefetchIterable(_Gen(10, fail_at=3)))


def test_thread_early_stop_does_not_hang():
    def alive():
        return [t for t in threading.enumerate()
                if t.name == "sdfa-thread-prefetch" and t.is_alive()]

    for k, _ in enumerate(ThreadPrefetchIterable(_Gen(1000))):
        if k == 2:
            break
    for _ in ThreadPrefetchIterable(_Gen(3)):  # the worker sits at its terminal put
        break
    deadline = time.time() + 3.0
    while alive() and time.time() < deadline:
        time.sleep(0.05)
    assert not alive(), alive()


def test_thread_prefetch_of_raw_batches_equals_direct(roots):  # noqa: F811
    """The thread hands over the reader's own batches, in order."""
    direct = list(_port_reader(roots, training=True).raw_batches(3))
    reader = _port_reader(roots, training=True)

    class _Epoch:
        def __iter__(self):
            return reader.raw_batches(3)

    threaded = list(ThreadPrefetchIterable(_Epoch()))
    assert len(threaded) == len(direct) > 0
    for a, b in zip(direct, threaded):
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
