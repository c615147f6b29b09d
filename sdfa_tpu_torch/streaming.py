"""Live serving: push audio chunks → mesh frames out (counterpart of
``sdfa_tpu/streaming.py``).

``StreamingSession`` serves one stream, ``StreamingServer`` multiplexes a
fixed pool of streams into one block round and one suffix call per tick, and
``CoefDecoder`` is the client's CPU decoder of the coefficient wire. All
three reuse the offline overlap path's machinery:

- per block, one device call (``task._get_stream_fns`` /
  ``task._get_ring_fns``) runs the mel frontend, the band-structured
  Savitzky-Golay Δ / Δ² (the interior 9-tap kernel of the offline
  ``dsp.delta_matrix``; edge columns that do not depend on T for frames 0..3)
  and the per-frame encoder prefix, carrying an 8-frame mel tail between
  calls on the device;
- the biLSTM / attention suffix and, on the vertex wires, decode + solve run
  per ``emit_batch`` windows through the same function as
  ``AnimationTask.generate_vertices`` (``task._get_verts_fn``), gathering
  from the encoded frames, which stay on the device.

Offline equivalence: pushing a clip in chunks of any size and flushing gives
the timeline of ``generate_vertices(clip)`` exactly and its vertices up to
float32 reassociation (the band against the whole-clip Δ product) plus the
wire's quantization step.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.sdfa import _interleave_perm
from .task import WIRE_LSB, WIRE_LSB8, HostBuffer
from .viewer import frame as frame_mod

SERVER_WIRES = ("f32", "i16", "i8d", "coef", "coef16")


def _block_samples(spec, block_frames: int) -> int:
    """Signal samples one mel block consumes."""
    return spec.win_size + (block_frames - 1) * spec.hop_size


def _take_block(sig: np.ndarray, sig_off: int, t_mel: int, spec, block_frames: int) -> np.ndarray:
    """Slice and preemphasize the next mel block (shared by the session and
    the server; preemphasis carries the previous raw sample across block
    boundaries exactly like the whole-clip filter)."""
    lo_abs = t_mel * spec.hop_size
    lo = lo_abs - sig_off
    block = sig[lo:lo + _block_samples(spec, block_frames)]
    if spec.preemph:
        prev = sig[lo - 1] if lo_abs else np.float32(0.0)
        first = block[0] if lo_abs == 0 else block[0] - spec.preemph * prev
        block = np.concatenate([[first], block[1:] - spec.preemph * block[:-1]]).astype(np.float32)
    return block


def _snapped_window_geom(spec, pad: int, w: int):
    """Window w's first frame index and emission timestamp: the hop-snapped
    geometry of ``WindowSpec.frame_grid`` (``np.round`` on float64 rounds half
    to even), shared by the session and the server so that the snap
    arithmetic the parity rests on has exactly one copy."""
    start, ts = spec.window_geom(w)
    snapped = int(np.round(np.float64(start) / spec.hop_size)) * spec.hop_size
    return (snapped + pad) // spec.hop_size, ts


def _emit_slice_len(spec, emit_batch: int) -> int:
    """Encoded frames one emit batch can span, padded to a multiple of 64."""
    span = spec.frames + int(math.ceil(
        (emit_batch - 1) * spec.sr / spec.fps / spec.hop_size)) + 2
    return -(-span // 64) * 64


def _check_streamable(task, block_frames: int):
    if not task.overlap_frontend:
        raise ValueError("streaming rides the overlap path: the task needs "
                         "overlap_frontend on and an encoder with a per-frame prefix")
    if block_frames < 9:
        raise ValueError("block_frames must be >= 9 (the left-edge Δ fit needs the first 9 "
                         "mel frames inside the first block)")


def _check_samples(samples) -> np.ndarray:
    samples = np.asarray(samples, np.float32).flatten()
    if samples.size and (samples.min() < -1 or samples.max() > 1):
        raise ValueError("samples must be normalized to [-1, 1]")
    return samples


class StreamingSession:
    """Created by ``AnimationTask.stream(speaker)``.

    push(samples) → the list of (ts_ms, verts (V, 3)) frames ready so far;
    flush() → the remaining frames (right-pads like the offline path).
    """

    _DCTX = 4  # Δ context: a Savitzky-Golay width of 9 needs 4 future frames

    def __init__(self, task, speaker, emit_batch: int = 16, block_frames: int = 16):
        _check_streamable(task, int(block_frames))
        self.task = task
        self.speaker = task._speaker(speaker)
        self.spec = s = task.wspec
        self.emit_batch = int(emit_batch)
        self.BLOCK = int(block_frames)  # frames per block call; 16 frames ≈ 0.13 s
        self._pad = s.sliding  # the left zero-pad of frame_grid
        # rolling buffers with absolute offsets: consumed history is trimmed, so
        # an indefinite session keeps O(lookahead) memory (``buffer_samples``)
        self._sig = np.zeros(self._pad, np.float32)
        self._sig_off = 0        # absolute sample index of _sig[0]
        self._n_real = 0
        self._t_mel = 0          # mel frames computed
        self._mel_tail = torch.zeros(8, s.n_mels, device=task.device)
        self._zbuf = None        # rolling encoded frames (n, D), on the device
        self._z_off = 0          # absolute frame index of _zbuf[0]
        self._z_done = 0         # encoded (Δ-finalized) frames
        self._w_done = 0         # windows emitted
        self._flushed = False
        self._fused_first, self._fused_steady = task._get_stream_fns(self.BLOCK)
        self._verts_fn = task._get_verts_fn()

    @property
    def lookahead_s(self) -> float:
        """Worst-case audio lookahead before a frame can be emitted."""
        s = self.spec
        return (s.sliding / 2 + self._DCTX * s.hop_size) / s.sr

    def _window_geom(self, w: int):
        return _snapped_window_geom(self.spec, self._pad, w)

    def _n_windows(self, n_samples: int) -> int:
        return self.spec.n_windows(n_samples)

    def _ingest(self):
        """One block call per complete block: mel, Δ / Δ² and the encoder
        prefix. z lags the mel cursor by the 4-frame Δ context (the first block
        gives B − 4 frames with the offline edge fits, later ones B)."""
        s, B = self.spec, self.BLOCK
        while True:
            t0 = self._t_mel
            if self._sig_off + len(self._sig) < t0 * s.hop_size + _block_samples(s, B):
                break
            block = torch.from_numpy(_take_block(self._sig, self._sig_off, t0, s, B))
            fn = self._fused_first if t0 == 0 else self._fused_steady
            self._mel_tail, z = fn(block.to(self.task.device), self._mel_tail)
            self._zbuf = z if self._zbuf is None else torch.cat([self._zbuf, z])
            self._z_done += len(z)
            self._t_mel += B
            # trim the consumed signal (one sample stays for the preemphasis carry)
            cut = max(0, self._t_mel * s.hop_size - 1 - self._sig_off)
            if cut:
                self._sig = self._sig[cut:]
                self._sig_off += cut

    def _emit_ready(self, limit_w: int) -> List[Tuple[float, np.ndarray]]:
        """Emit the complete windows below limit_w whose frames are encoded."""
        s = self.spec
        out = []
        while self._w_done < limit_w:
            batch = []
            w = self._w_done
            while len(batch) < self.emit_batch and w < limit_w:
                f0, ts = self._window_geom(w)
                if f0 + s.frames > self._z_done:
                    break
                batch.append((f0, ts))
                w += 1
            if not batch:
                break
            out.extend(self._run_batch(batch))
            self._w_done = w
            # trim the z every window before the next unemitted one has read
            cut = self._window_geom(self._w_done)[0] - self._z_off
            if cut > 0:
                self._zbuf = self._zbuf[cut:]
                self._z_off += cut
        return out

    def buffer_samples(self) -> dict:
        """Retained buffer sizes, bounded however long the session runs (the
        mel state is only the 8-frame tail on the device)."""
        return dict(sig=len(self._sig), mel=int(self._mel_tail.shape[0]),
                    z=0 if self._zbuf is None else len(self._zbuf))

    @torch.inference_mode()
    def _run_batch(self, batch):
        task, s = self.task, self.spec
        rows = torch.tensor([f0 - self._z_off for f0, _ in batch], dtype=torch.long)
        idx = (rows[:, None] + torch.arange(s.frames)[None, :]).to(task.device)
        flat = self._verts_fn(self._zbuf, idx, task._spk(self.speaker, len(batch)))
        verts = task._host.download(flat).reshape(len(batch), -1, 3)
        return [(ts, verts[i]) for i, (_, ts) in enumerate(batch)]

    def push(self, samples: np.ndarray) -> List[Tuple[float, np.ndarray]]:
        """Feed more audio; returns the frames that became ready as a list of
        (ts_ms, verts (V, 3))."""
        if self._flushed:
            raise RuntimeError("session already flushed")
        samples = _check_samples(samples)
        self._sig = np.concatenate([self._sig, samples])
        self._n_real += len(samples)
        self._ingest()
        return self._emit_ready(self._n_windows(self._n_real))

    def flush(self) -> List[Tuple[float, np.ndarray]]:
        """End of stream: zero-pad (exactly the offline right pad) and emit
        every remaining window."""
        if self._flushed:
            raise RuntimeError("session already flushed")
        self._flushed = True
        s = self.spec
        n_w = self._n_windows(self._n_real)
        if n_w == 0:
            return []
        last_f0, _ = self._window_geom(n_w - 1)
        # grow in block-sized zero chunks until every frame the last window
        # gathers is encoded (ingestion advances in whole blocks, so one pad of
        # the exact size can stall a block short)
        while self._z_done < last_f0 + s.frames:
            self._sig = np.concatenate([self._sig, np.zeros(self.BLOCK * s.hop_size, np.float32)])
            self._ingest()
        return self._emit_ready(n_w)


class _ServerSlot:
    """Host-side state of one multiplexed stream: counters only. The encoded
    frames live in the server's ring on the device. ``inflight`` counts frames
    dispatched but not collected (pipelined ticks); a stream is done when it
    is flushed, every window is dispatched and nothing is in flight."""

    def __init__(self, speaker: int, pad: int):
        self.speaker = int(speaker)
        self.sig = np.zeros(pad, np.float32)
        self.sig_off = 0
        self.n_real = 0
        self.t_mel = 0
        self.z_done = 0
        self.w_done = 0
        self.inflight = 0
        self.flushing = False


class StreamingServer:
    """A fixed pool of live streams sharing one device pipeline: up to
    ``capacity`` streams in two device calls per tick.

    - **The ring of encoded frames stays on the device**: a flat
      (capacity·ring_frames, D) table. One batched block call per tick round
      (mel, band Δ / Δ², the encoder prefix on the flattened pool batch)
      writes each live slot's new frames at slot·R + frame mod R.
    - **One suffix call per tick** covers every ready window of the pool:
      the window rows gather straight from the ring (wrapped indices are just
      indices), then decode + solve on the vertex wires.
    - **Wires**: ``"i16"`` (default) quantizes on the device to
      ``task.WIRE_LSB`` before the download; ``"i8d"`` downloads clamped int8
      steps of an integer state carried on the device (``WIRE_LSB8``), which
      the host mirrors with the identical recurrence, both ends re-based on
      the template at ``open()``; ``"coef"`` / ``"coef16"`` download the raw
      (85 + 180,) PCA coefficients in float32 / float16 and run no inversion
      and no solve on the device: the client reconstructs with
      ``CoefDecoder``, and frames are ``(ts_ms, coeffs (K,))``; ``"f32"``
      downloads float32 vertices.
    - **Downloads** go through two pinned buffers that take turns: a
      non-blocking copy and a recorded event at dispatch, waited for at
      collect. With ``pipeline=True`` ``tick()`` dispatches this round and
      returns the previous round's frames, so round k − 1's copy overlaps
      round k's compute (one tick of latency more).

    The ring, the mel carries and the i8d carry are tensors updated in place.
    That is safe, also for a round in flight, only because every block
    write, gather and download is enqueued on one CUDA stream in tick order:
    a later block write cannot overtake an earlier gather.

    A slot's first block runs through the per-stream edge-fit Δ variant
    (``first_ring``); every later block rides the batched call. Per slot the
    emission order, the timestamps and the values match a dedicated
    ``StreamingSession`` and offline ``generate_vertices`` to the wire's step.

        srv = StreamingServer(task, capacity=8)
        sid = srv.open(speaker)
        srv.push(sid, chunk)             # buffers audio (host only)
        frames = srv.tick()              # {sid: [(ts_ms, verts), ...]}
        srv.flush(sid)                   # end of stream (zero-pads)
        while not srv.is_done(sid): frames = srv.tick()
        srv.close(sid)                   # frees the slot
    """

    def __init__(self, task, capacity: int = 8, emit_batch: int = 16, block_frames: int = 16,
                 wire: str = "i16", pipeline: bool = False, ring_frames: Optional[int] = None):
        _check_streamable(task, int(block_frames))
        if wire not in SERVER_WIRES:
            raise ValueError(f"unknown wire format {wire!r}")
        self.task = task
        self.N = int(capacity)
        self.emit_batch = int(emit_batch)
        self.BLOCK = int(block_frames)
        self._wire = wire
        self._lsb = np.float32(WIRE_LSB8 if wire == "i8d" else WIRE_LSB)
        self.pipeline = bool(pipeline)
        self._inflight_call = None  # the round dispatched last, when pipelined
        s = self.spec = task.wspec
        self._pad = s.sliding
        dev = task.device

        # ring length: an emit batch's gather span and two blocks of slack,
        # rounded up to a power of two. Ingestion is bounded so that frames a
        # window not yet dispatched still needs are never overwritten.
        need = _emit_slice_len(s, self.emit_batch) + 2 * self.BLOCK + 8
        self.R = int(ring_frames) if ring_frames else 1 << (need - 1).bit_length()

        self._first_ring, self._batched_ring = task._get_ring_fns(self.BLOCK)
        if wire == "i8d":
            self._verts_fn, self._template_q = task._get_verts_fn_i8d()
            template_q = torch.from_numpy(self._template_q).to(dev)
            self._lastq = template_q.repeat(self.N, 1)       # the device's carry per slot
            self._template_q_dev = template_q
            self._mirror = np.tile(self._template_q[None], (self.N, 1))  # the host's
            self._reset = np.zeros((self.N,), bool)
        else:
            self._verts_fn = task._get_verts_fn(wire=wire)

        # the ring's row shape is the prefix's output for one block
        fused_first, _ = task._get_stream_fns(self.BLOCK)
        _, z = fused_first(torch.zeros(_block_samples(s, self.BLOCK), device=dev),
                           torch.zeros(8, s.n_mels, device=dev))
        self._ring = torch.zeros((self.N * self.R,) + tuple(z.shape[1:]), dtype=z.dtype,
                                 device=dev)
        self._carries = torch.zeros(self.N, 8, s.n_mels, device=dev)
        self._slots: List[Optional[_ServerSlot]] = [None] * self.N
        self._buffers = (HostBuffer(), HostBuffer())
        self._round = 0

    # -- lifecycle ---------------------------------------------------------
    def open(self, speaker) -> int:
        speaker = self.task._speaker(speaker)
        for sid in range(self.N):
            if self._slots[sid] is None:
                # no device state to reset: the first block writes the mel carry
                # and its ring rows before anything reads them
                self._slots[sid] = _ServerSlot(speaker, self._pad)
                if self._wire == "i8d":
                    # both ends re-base the delta carry on the template; the
                    # device does so at the next dispatch, before this slot's
                    # first frames can exist
                    self._reset[sid] = True
                    self._mirror[sid] = self._template_q
                return sid
        raise RuntimeError(f"server full ({self.N} live streams)")

    def push(self, sid: int, samples: np.ndarray) -> None:
        slot = self._slot(sid)
        if slot.flushing:
            raise RuntimeError("stream already flushed")
        samples = _check_samples(samples)
        slot.sig = np.concatenate([slot.sig, samples])
        slot.n_real += len(samples)

    def flush(self, sid: int) -> None:
        """Mark the end of a stream: the slot zero-pads (the offline right
        pad) and the following ticks emit its remaining windows."""
        slot = self._slot(sid)
        if slot.flushing:
            raise RuntimeError("stream already flushed")
        slot.flushing = True
        s = self.spec
        n_w = s.n_windows(slot.n_real)
        if n_w == 0:
            return
        last_f0, _ = self._window_geom(n_w - 1)
        need_frames = last_f0 + s.frames
        # zeros until whole-block ingestion will have encoded every frame the
        # last window gathers: z lags the mel cursor by the 4-frame Δ context
        blocks_total = -(-(need_frames + 4) // self.BLOCK)
        need_samples = ((blocks_total - 1) * self.BLOCK * s.hop_size
                        + _block_samples(s, self.BLOCK))
        cur = slot.sig_off + len(slot.sig)
        if need_samples > cur:
            slot.sig = np.concatenate([slot.sig, np.zeros(need_samples - cur, np.float32)])

    def is_done(self, sid: int) -> bool:
        slot = self._slot(sid)
        return (slot.flushing and slot.inflight == 0
                and slot.w_done >= self.spec.n_windows(slot.n_real))

    def close(self, sid: int) -> None:
        self._slots[sid] = None

    def live(self) -> List[int]:
        return [i for i, sl in enumerate(self._slots) if sl is not None]

    def _slot(self, sid: int) -> _ServerSlot:
        slot = self._slots[sid]
        if slot is None:
            raise KeyError(f"no live stream in slot {sid}")
        return slot

    def _window_geom(self, w: int):
        return _snapped_window_geom(self.spec, self._pad, w)

    def _ring_rows(self, sid: int, first_frame: int, count: int) -> np.ndarray:
        return sid * self.R + (first_frame + np.arange(count, dtype=np.int64)) % self.R

    # -- pipeline ----------------------------------------------------------
    def _advance_blocks(self):
        s, B, R, dev = self.spec, self.BLOCK, self.R, self.task.device
        blk_n = _block_samples(s, B)

        def pending(slot):
            if slot.flushing and slot.w_done >= s.n_windows(slot.n_real):
                return False  # every window is dispatched: stop ingesting
            if slot.sig_off + len(slot.sig) < slot.t_mel * s.hop_size + blk_n:
                return False
            # ring bound: the new rows [z_done, z_done + n_out) must not lap
            # frames the next window not yet dispatched still gathers
            n_out = (B - 4) if slot.t_mel == 0 else B
            keep_f0 = self._window_geom(slot.w_done)[0]
            return slot.z_done + n_out - keep_f0 <= R

        def consume(slot, n_out):
            slot.z_done += n_out
            slot.t_mel += B
            cut = max(0, slot.t_mel * s.hop_size - 1 - slot.sig_off)
            if cut:
                slot.sig = slot.sig[cut:]
                slot.sig_off += cut

        while True:
            live = [(i, sl) for i, sl in enumerate(self._slots)
                    if sl is not None and pending(sl)]
            if not live:
                break
            firsts = [(i, sl) for i, sl in live if sl.t_mel == 0]
            steadies = [(i, sl) for i, sl in live if sl.t_mel > 0]
            for i, sl in firsts:  # once per stream: the edge-fit Δ variant
                block = torch.from_numpy(_take_block(sl.sig, sl.sig_off, 0, s, B)).to(dev)
                rows = torch.from_numpy(self._ring_rows(i, sl.z_done, B - 4)).to(dev)
                self._first_ring(block, self._carries, i, self._ring, rows)
                consume(sl, B - 4)
            if steadies:
                # only the live slots are computed and written: their ids and
                # ring rows are known here, on the host, and ride one upload
                blocks = np.stack([_take_block(sl.sig, sl.sig_off, sl.t_mel, s, B)
                                   for _, sl in steadies])
                index = np.concatenate([np.asarray([i for i, _ in steadies], np.int64)]
                                       + [self._ring_rows(i, sl.z_done, B) for i, sl in steadies])
                index = torch.from_numpy(index).to(dev)
                self._batched_ring(torch.from_numpy(blocks).to(dev), self._carries,
                                   index[:len(steadies)], self._ring, index[len(steadies):])
                for _, sl in steadies:
                    consume(sl, B)

    def _ready_windows(self, slot: _ServerSlot):
        """Up to emit_batch next windows whose frames are encoded."""
        s = self.spec
        limit = s.n_windows(slot.n_real)
        out = []
        w = slot.w_done
        while len(out) < self.emit_batch and w < limit:
            f0, ts = self._window_geom(w)
            if f0 + s.frames > slot.z_done:
                break
            out.append((w, f0, ts))
            w += 1
        return out

    @torch.inference_mode()
    def _dispatch(self):
        """Plan this round's ready windows, enqueue the suffix call and the
        download of its payload. ``w_done`` and ``inflight`` advance at once:
        the gather is already ahead of any later block write on the stream, so
        ingestion is free to reuse those ring rows."""
        s, dev, E = self.spec, self.task.device, self.emit_batch
        plan = []
        for sid, slot in enumerate(self._slots):
            if slot is None:
                continue
            batch = self._ready_windows(slot)
            if batch:
                plan.append((sid, slot, batch))
        if not plan:
            return None
        ar = np.arange(s.frames + 1, dtype=np.int64)  # a window's frames, then its speaker
        table = []
        delta = self._wire == "i8d"
        for sid, slot, batch in plan:
            rows = [sid * self.R + (f0 + ar) % self.R for _, f0, _ in batch]
            for row in rows:
                row[-1] = slot.speaker
            if delta:
                # the delta recurrence is per slot, so a slot's consecutive
                # frames fill its own group of E rows; padding rows repeat the
                # last window and carry valid = 0, so that neither the device
                # carry nor the host mirror advances on them
                rows += [rows[-1]] * (E - len(batch))
            table.extend(rows)
            slot.w_done = batch[-1][0] + 1
            slot.inflight += len(batch)
        table = torch.from_numpy(np.stack(table)).to(dev)  # one upload for both
        idx, spk = table[:, :-1], table[:, -1]
        if delta:
            sids = [sid for sid, _, _ in plan]
            # one upload: the plan's slot ids, then each slot's valid flags
            meta = np.zeros((len(plan), 1 + E), np.int64)
            meta[:, 0] = sids
            for k, (_, _, batch) in enumerate(plan):
                meta[k, 1:1 + len(batch)] = 1
            meta = torch.from_numpy(meta).to(dev)
            reset = np.flatnonzero(self._reset)
            if len(reset):
                self._lastq[torch.from_numpy(reset).to(dev)] = self._template_q_dev
                self._reset[:] = False
            payload, lastq = self._verts_fn(self._ring, idx, spk, self._lastq[meta[:, 0]],
                                            meta[:, 1:].to(torch.int32))
            self._lastq.index_copy_(0, meta[:, 0], lastq)
        else:
            payload = self._verts_fn(self._ring, idx, spk)
        # the copy goes out now, on the compute stream, behind this round's
        # kernels and ahead of the next round's: requested only at collect
        # time it would queue behind the next round's compute
        pending = self._buffers[self._round % 2].start(payload)
        self._round += 1
        return plan, pending

    def _collect(self, plan, pending):
        flat = HostBuffer.finish(pending)
        emitted: Dict[int, List[Tuple[float, np.ndarray]]] = {}
        if self._wire == "i8d":
            for k, (sid, slot, batch) in enumerate(plan):
                m = self._mirror[sid]
                frames = []
                for j, (_, _, ts) in enumerate(batch):
                    m = m + flat[k, j].astype(np.int32)
                    frames.append((ts, (m.astype(np.float32) * self._lsb).reshape(-1, 3)))
                slot.inflight -= len(batch)
                if self._slots[sid] is slot:  # dropped if closed in flight: the device
                    self._mirror[sid] = m     # advanced either way, and a slot opened
                    emitted.setdefault(sid, []).extend(frames)  # again re-bases both ends
            return emitted
        if self._wire == "i16":
            flat = flat.astype(np.float32) * self._lsb
        # "coef" frames are (K,) float32 coefficient vectors, not meshes, and
        # "coef16" stays float16 end to end: an upcast here would throw the
        # wire's byte saving away on every link past this host
        coef = self._wire in ("coef", "coef16")
        row = 0
        for sid, slot, batch in plan:
            frames = [(ts, flat[row + j] if coef else flat[row + j].reshape(-1, 3))
                      for j, (_, _, ts) in enumerate(batch)]
            row += len(batch)
            slot.inflight -= len(batch)
            if self._slots[sid] is slot:  # dropped if closed in flight
                emitted.setdefault(sid, []).extend(frames)
        return emitted

    def tick_dispatch(self):
        """First half of a tick: ingest the ready blocks and enqueue the
        suffix call and its download, nothing blocking. Returns an opaque
        token for ``tick_collect``. Split out so that a serving wrapper holds
        its client lock across this half only."""
        self._advance_blocks()
        pending = self._dispatch()
        if not self.pipeline:
            return pending
        prev, self._inflight_call = self._inflight_call, pending
        return prev

    def tick_collect(self, pending) -> Dict[int, List[Tuple[float, np.ndarray]]]:
        """Second half: wait for the download and route the frames. Safe
        without the caller's client lock: it touches the plan's slot objects
        (one tick thread) and reads ``_slots`` for the closed-in-flight guard."""
        return self._collect(*pending) if pending else {}

    def tick(self) -> Dict[int, List[Tuple[float, np.ndarray]]]:
        """Advance every live stream: one batched block round and one batched
        suffix call. Returns this round's frames, or, pipelined, the previous
        round's."""
        return self.tick_collect(self.tick_dispatch())


class CoefDecoder:
    """The client's decoder of the coefficient wire
    (``StreamingServer(task, wire="coef")`` / ``"coef16"``).

    That wire ships (K,) = scale + rotat PCA coefficients per frame (85 + 180
    values) instead of (V, 3) vertices, and drops the PCA inversion and the
    deformation solve from the device's tick. This class is the wire's other
    end and by design runs on the client's CPU: it reconstructs meshes from a
    one-time constants package (the two PCA bases and the prefactorized
    deformation system of the template mesh).

    ``decode(coeffs)`` is fully batched: one PCA product per basis, the
    Rodrigues rotations written out elementwise, the right-hand sides
    assembled at once, and one SuperLU back-substitution for all frames. The
    math is ``DeformationSolver.solve_host``, the float64 oracle the device
    path is held to, so coefficient-wire frames are more accurate than any
    quantized vertex wire.
    """

    def __init__(self, task):
        model = task.model
        if not task._has_coef_heads():
            raise ValueError("CoefDecoder matches the coefficient wire: dgrad_3d PCA heads")

        def host64(t):
            return t.detach().cpu().numpy().astype(np.float64)

        # the PCA inversion: x = c @ compT.T + means
        self._sc_basis = host64(model.scale_pca.compT).T  # (Ks, T·6)
        self._sc_mean = host64(model.scale_pca.means)
        self._rc_basis = host64(model.rotat_pca.compT).T  # (Kr, T·3)
        self._rc_mean = host64(model.rotat_pca.means)
        self.n_scale = self._sc_basis.shape[0]
        self.n_rotat = self._rc_basis.shape[0]
        self.n_coefs = self.n_scale + self.n_rotat

        solver = frame_mod.get_solver()
        self._solver = solver
        self._at32 = solver._at.astype(np.float32)  # Aᵀ of the default path
        self.n_tris = solver.n_tris
        if self._sc_mean.shape[-1] != self.n_tris * 6:
            raise ValueError(f"PCA basis of {self._sc_mean.shape[-1] // 6} triangles, "
                             f"template of {self.n_tris}")
        self._perm = _interleave_perm(self.n_tris)  # [6 scale | 3 rotat] per triangle
        # the equation gather: row block k of the right-hand side is Tᵀ of
        # triangle eq_src[k], or an appended identity where eq_src[k] < 0
        # (a target triangle with no source); None for the identity table
        self._eq_idx = None if solver.spec.identity_eq else np.where(
            solver._eq_src < 0, self.n_tris, solver._eq_src)
        if solver.n_cnsts > 0:
            self._cnst = solver.template_verts[solver.cnst_indices]
            self._arc = np.asarray(solver._ar @ self._cnst)  # (3·n_eqs, 3)
        else:
            self._cnst = self._arc = None
        self._front = None  # the default path's float32 constants, made on first use

    def fingerprint(self) -> dict:
        """Identity of the decode system this client reconstructs with.

        The decoder builds from the process-global template and constraints
        (``viewer.frame.get_solver()``); a client whose template differs from
        the server's would decode against another prefactorized system
        without a sign. The server announces its fingerprint in the open-ok
        reply and ``check_fingerprint`` holds the two together before any
        frame decodes."""
        sol = self._solver
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(sol.template_verts.astype(np.float32)).tobytes())
        h.update(np.ascontiguousarray(np.asarray(sol._eq_src, np.int64)).tobytes())
        if sol.n_cnsts > 0:
            h.update(np.ascontiguousarray(np.asarray(sol.cnst_indices, np.int64)).tobytes())
        return {"n_tris": int(self.n_tris), "n_coefs": int(self.n_coefs),
                "n_cnsts": int(sol.n_cnsts), "system_sha1": h.hexdigest()[:16]}

    def check_fingerprint(self, fp: Optional[dict]) -> None:
        """Assert that this decoder matches the fingerprint the server
        announced (nothing to check when there is none)."""
        if not fp:
            return
        mine = self.fingerprint()
        if mine != dict(fp):
            raise AssertionError(
                f"coef-wire decode system mismatch: client {mine} vs server {dict(fp)}; the "
                "client process must install the server's template and constraints")

    @staticmethod
    def _transforms_t(d, xp):
        """(exp(skew(r))·S)ᵀ = S·Rᵀ (S is symmetric) per triangle, with the
        Rodrigues matrix and the product written out elementwise: d (..., 9) →
        (..., 3, 3). ``xp`` is numpy (float64, the precise path) or torch
        (float32, the default path): one formula for both."""
        s00, s01, s02 = d[..., 0] + 1.0, d[..., 1], d[..., 2]
        s11, s12, s22 = d[..., 3] + 1.0, d[..., 4], d[..., 5] + 1.0
        wx, wy, wz = -d[..., 8], d[..., 7], -d[..., 6]
        angle = xp.sqrt(wx * wx + wy * wy + wz * wz)
        small = angle < 1e-6  # the oracle's cutoff: R = I
        one, zero = xp.ones_like(angle), xp.zeros_like(angle)
        inv = xp.where(small, zero, 1.0 / xp.where(small, one, angle))
        x, y, z = wx * inv, wy * inv, wz * inv
        co = xp.where(small, one, xp.cos(angle))
        si = xp.where(small, zero, xp.sin(angle))
        cc = 1.0 - co
        r00, r01, r02 = co + x * x * cc, x * y * cc - z * si, x * z * cc + y * si
        r10, r11, r12 = x * y * cc + z * si, co + y * y * cc, y * z * cc - x * si
        r20, r21, r22 = x * z * cc - y * si, y * z * cc + x * si, co + z * z * cc
        out = xp.stack([
            s00 * r00 + s01 * r01 + s02 * r02,
            s00 * r10 + s01 * r11 + s02 * r12,
            s00 * r20 + s01 * r21 + s02 * r22,
            s01 * r00 + s11 * r01 + s12 * r02,
            s01 * r10 + s11 * r11 + s12 * r12,
            s01 * r20 + s11 * r21 + s12 * r22,
            s02 * r00 + s12 * r01 + s22 * r02,
            s02 * r10 + s12 * r11 + s22 * r12,
            s02 * r20 + s12 * r21 + s22 * r22], -1)
        return out.reshape(tuple(out.shape[:-1]) + (3, 3))

    @classmethod
    def _transforms_t_fast(cls, dgrad: np.ndarray) -> np.ndarray:
        """``deform_solver.transforms_t_np`` without its (n, 3, 3) batched tiny
        products: float64 numpy, (n, 9) → (n, 3, 3)."""
        return cls._transforms_t(np.asarray(dgrad, np.float64), np)

    def _rhs_layout(self, tt, arc, xp):
        """Tᵀ (F, T, 3, 3) → the back-substitution's right-hand side before
        Aᵀ, (3·n_eqs, F·3): each equation's Tᵀ (the equation gather), less the
        constraint term, the frames side by side."""
        if self._eq_idx is not None:
            eye = xp.zeros_like(tt[:, :1])
            for i in range(3):
                eye[:, :, i, i] = 1.0
            tt = xp.concatenate([tt, eye], 1)[:, self._eq_idx]
        d = tt.reshape(tt.shape[0], -1, 3)
        if arc is not None:
            d = d - arc
        return xp.swapaxes(d, 0, 1).reshape(d.shape[1], -1)

    def _front_half(self, c: np.ndarray) -> np.ndarray:
        """The default path's front half as float32 torch ops pinned to the
        CPU (a process with a card attached still decodes on the client's
        side): PCA expansion, Rodrigues, constraint term."""
        if self._front is None:
            cpu = torch.device("cpu")
            self._front = {k: torch.as_tensor(np.asarray(v, np.float32), device=cpu) for k, v in (
                ("sc_basis", self._sc_basis), ("sc_mean", self._sc_mean),
                ("rc_basis", self._rc_basis), ("rc_mean", self._rc_mean))}
            self._front["arc"] = None if self._arc is None else torch.as_tensor(
                np.asarray(self._arc, np.float32), device=cpu)
        f = self._front
        with torch.inference_mode():
            c = torch.as_tensor(c.astype(np.float32), device=torch.device("cpu"))
            scale = (c[:, :self.n_scale] @ f["sc_basis"] + f["sc_mean"]).reshape(
                len(c), self.n_tris, 6)
            rotat = (c[:, self.n_scale:] @ f["rc_basis"] + f["rc_mean"]).reshape(
                len(c), self.n_tris, 3)
            tt = self._transforms_t(torch.cat([scale, rotat], dim=-1), torch)
            return self._rhs_layout(tt, f["arc"], torch).numpy()

    def decode(self, coeffs: np.ndarray, precise: bool = False) -> np.ndarray:
        """(F, K) or (K,) wire coefficients → (F, V, 3) / (V, 3) metres.

        Default: the float32 front half on the CPU and the float64 SuperLU
        back-substitution. ``precise=True`` runs everything in float64 numpy:
        the exact ``DeformationSolver.solve_host`` values, the parity tests'
        reference."""
        c = np.asarray(coeffs, np.float64)
        single = c.ndim == 1
        if single:
            c = c[None]
        if c.shape[-1] != self.n_coefs:
            raise ValueError(f"coefficients {c.shape}, this decoder takes {self.n_coefs}")
        fr = len(c)
        sol = self._solver
        if precise:
            scale = c[:, :self.n_scale] @ self._sc_basis + self._sc_mean
            rotat = c[:, self.n_scale:] @ self._rc_basis + self._rc_mean
            flat = np.concatenate([scale, rotat], axis=-1)[:, self._perm]
            tt = self._transforms_t_fast(flat.reshape(-1, 9)).reshape(fr, self.n_tris, 3, 3)
            rhs = sol._at @ self._rhs_layout(tt, self._arc, np)
        else:
            rhs = (self._at32 @ self._front_half(c)).astype(np.float64)
        x = sol._lu.solve(rhs)  # one back-substitution, F·3 right-hand sides
        out = np.zeros((fr, sol.n_verts, 3))
        out[:, sol.free_ids] = x.reshape(-1, fr, 3).transpose(1, 0, 2)
        if self._cnst is not None:
            out[:, sol.cnst_indices] = self._cnst
        out = out.astype(np.float32)
        return out[0] if single else out
