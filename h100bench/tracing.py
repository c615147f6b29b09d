"""The reduction from a ``torch.profiler`` trace of the measured window to what
the per-layer readers and the result line need: the device's operations (kernels,
copies, sets) as intervals, the busy time as their union, sums by kernel name,
and the longest idle gaps by the host span (``record_function``, the
driver's or the program's) that was open over them."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Events of one traced window, times in microseconds."""

    def __init__(self, events: List[dict], span: str):
        """``span``: the host span the driver records around each unit of
        the window's work; the window runs from the first one's start to the
        last one's end."""
        marks = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                 if e.get("ph") == "X" and e.get("name") == span
                 and e.get("cat") == "user_annotation"]
        t0_us, t1_us = min(m[0] for m in marks), max(m[1] for m in marks)
        self.t0, self.t1 = t0_us, t1_us
        self.device = [(e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0.0)))
                       for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                       and t0_us <= float(e["ts"]) <= t1_us]
        self.host = [(e["name"], e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0)))
                     for e in events if e.get("ph") == "X" and e.get("cat") not in DEVICE_CATS
                     and t0_us <= float(e["ts"]) <= t1_us]

    @classmethod
    def from_profile(cls, prof, tmpdir: str, span: str) -> "Trace":
        path = os.path.join(tmpdir, "h100bench_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fp:
            data = json.load(fp)
        os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, span)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which any operation ran on the device: the union of the
        intervals."""
        total, end = 0.0, -1.0
        for _, _, ts, dur in sorted(self.device, key=lambda e: e[2]):
            lo, hi = max(ts, end), ts + dur
            if hi > lo:
                total += hi - lo
            end = max(end, hi)
        return total * 1e-6

    def kernel_s(self, names: Iterable[str]) -> float:
        """Summed seconds of the kernels whose name holds one of ``names``."""
        names = tuple(names)
        return 1e-6 * sum(dur for name, cat, _, dur in self.device
                          if cat == "kernel" and any(n in name for n in names))

    def copy_s(self, kind: str) -> float:
        """Summed seconds of the copies whose name holds ``kind`` ("DtoH")."""
        return 1e-6 * sum(dur for name, cat, _, dur in self.device
                          if cat == "gpu_memcpy" and kind in name)

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        sums: Dict[str, float] = {}
        for name, _, _, dur in self.device:
            sums[name] = sums.get(name, 0.0) + dur * 1e-6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """The longest gaps with nothing on the device, each named after the
        innermost host span that covers most of it (the shortest of those
        covering more than half; else the one covering most)."""
        gaps, end = [], self.t0
        for _, _, ts, dur in sorted(self.device, key=lambda e: e[2]):
            if ts > end:
                gaps.append((end, ts))
            end = max(end, ts + dur)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = [h for h in self.host if h[1] == "user_annotation"]
        out = []
        for lo, hi in gaps[:k]:
            best, best_cover = "host", 0.0
            inner, inner_dur = None, float("inf")
            for name, _, ts, dur in spans:
                cover = min(hi, ts + dur) - max(lo, ts)
                if cover > best_cover:
                    best, best_cover = name, cover
                if cover > 0.5 * (hi - lo) and dur < inner_dur:
                    inner, inner_dur = name, dur
            out.append((inner or best, (hi - lo) * 1e-6))
        return out
