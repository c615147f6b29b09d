"""The traffic generator: everything a mix file's parameters describe, drawn
from ``--seed``. Every seed gets the same set of sizes, in another order, so
that a seed changes the inputs and not the amount of work."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import frozen


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), *stream])


class StreamSchedule:
    """A closed-loop pool's streams, by the order in which they open.

    A bank of ``clip_bank`` formant-synthesized clips whose lengths are spread
    evenly over ``clip_s`` = [lo, hi] seconds; stream k takes the clips of its
    cycle of ``clip_bank`` streams in a seeded order, and a seeded speaker."""

    def __init__(self, mix: Dict, seed: int, sr: int):
        lo, hi = (float(v) for v in mix["clip_s"])
        self.m = int(mix["clip_bank"])
        self.seed, self.speakers = int(seed), int(mix["speakers"])
        lengths = [lo + (hi - lo) * (i + 0.5) / self.m for i in range(self.m)]
        self.clips = [frozen.rms_normalize(frozen.formant_utterance(_rng(seed, 1, i), sr, s),
                                           float(mix["audio_target_db"]))
                      for i, s in enumerate(lengths)]
        self._orders: Dict[int, np.ndarray] = {}

    def stream(self, k: int) -> Tuple[int, int]:
        """(clip index, speaker) of the k-th stream."""
        cycle, pos = divmod(int(k), self.m)
        if cycle not in self._orders:
            self._orders[cycle] = _rng(self.seed, 2, cycle).permutation(self.m)
        speaker = int(_rng(self.seed, 3, k).integers(self.speakers))
        return int(self._orders[cycle][pos]), speaker

    def check_set(self, first: int, span: int, count: int) -> List[int]:
        """The streams whose frames are compared: ``count`` of the streams
        ``first`` .. ``first + span`` - 1, drawn from the seed, the first one
        with the longest clip among them always in."""
        ks = list(range(first, first + span))
        longest = max(ks, key=lambda k: (len(self.clips[self.stream(k)[0]]), -k))
        rest = [k for k in ks if k != longest]
        pick = _rng(self.seed, 4).choice(len(rest), size=min(count - 1, len(rest)), replace=False)
        return sorted([longest] + [rest[i] for i in pick])
