"""The per-step learner feed: packed records of every env at every step.

Port of ``eldorado_tpu/stream.py``. A learner conditions on, and trains
off, what the reference's observation views show after every step
(include/pybind/vectorized.h:60-150). The state lives on the card, so the
feed is one packed record per env per step, written by K1 itself inside
its chunk loop (``ops.step_kernel.fused_step(record=...)``; the plain
version packs with `pack_step` / `pack_step_full` after each step):

    word0  action (5 sub-actions x 5 bits) | done<<25 | agent<<26
           | phase<<28
    word1  rewards (4 players x 4-bit two's complement; zero-sum values
           lie in [-4, 4]) | machete<<16 (3b) | paddle<<19 (3b)
           | round(2*coins)<<22 (10b, clamped)
    word2..4  the selected-action mask's 3 packed words
           (engine.pack_mask layout; index 92 bits via engine.unpack_mask)

All fields are the POST-step state (what the next action sees); ``action``
and ``rewards`` belong to the step itself. The full record (`record="full"`,
`RECORD_WORDS_FULL` words) adds what else ObsData carries
(include/api.h:84-129), so that a consumer can mirror the observation
surface of every env at every step (`ObsReconstructor`):

    word5..31   the acting player's post-step (5, 21) pile counts, one
                full u8 each, 4 to a word: the reference's u8 arithmetic
                makes wrapped counts (255 = -1) observable state
    word32      shop stock slots 0..15, 2 bits each (stock <= 3)
    word33      shop slots 16, 17 (bits 0..3) | actor<<4 | shop_overflow<<7
                | machete<<8 (5b) | paddle<<13 (5b) | round(2*coins)<<18
                (12b) | res_overflow<<30
    word34..36  the actor's post-step storage-mask row
    word37..39  the post-step agent's storage-mask row (a step writes at
                most these two rows)

The actor is the agent at step entry. The map changes only at reset, so
the feed ships each chunk boundary's reset-queue result as a keyframe
(`parse_reset_buffer`). Records go card -> pinned host memory (a side
stream, overlapped with the next chunk's K1) -> the native `TrajectoryRing`
-> a `RingConsumer` thread; or stay on the card for a consumer there
(``deliver="device"``); or travel delta-compressed (`compress_chunk`).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .core import engine as E
from .devices import resolve

RECORD_WORDS = 5
RECORD_WORDS_FULL = 40
RECORD_WIDTH = {"compact": RECORD_WORDS, "full": RECORD_WORDS_FULL}

_i32 = torch.int32
_PILE_WORDS = 27                 # 105 u8 counts, 4 to a word
_MAPW = E.GRIDSIZE * E.GRIDSIZE


# ---------------------------------------------------------------- records
def pack_step(act, done, rew, agent, sel, res, phase):
    """One step's post-step fields, env-major -> (n, RECORD_WORDS) int32.

    ``act`` (n, 5) i32, ``done`` (n,) bool, ``rew`` (n, 4) f32, ``agent``
    and ``phase`` (n,) i32, ``sel`` (n, 3) i32, ``res`` (n, 3) f32.
    Rounding is half to even (as jnp.round)."""
    w0 = (done.to(_i32) << 25) | (agent << 26) | (phase << 28)
    for i in range(5):
        w0 = w0 | (act[:, i] << (5 * i))
    r = torch.round(rew).to(_i32)
    w1 = torch.zeros_like(w0)
    for i in range(4):
        w1 = w1 | ((r[:, i] & 0xF) << (4 * i))
    mach = torch.round(res[:, 0]).to(_i32).clamp(0, 7)
    padd = torch.round(res[:, 1]).to(_i32).clamp(0, 7)
    coin2 = torch.round(res[:, 2] * 2.0).to(_i32).clamp(0, 1023)
    w1 = w1 | (mach << 16) | (padd << 19) | (coin2 << 22)
    return torch.cat([w0[:, None], w1[:, None], sel], 1)


def pack_step_full(base5, piles, shop, storage, res, p_pre, agent):
    """Widen one step's compact records ``base5`` (n, 5) to the full
    observation surface, (n, RECORD_WORDS_FULL) int32. ``piles``
    (n, 4, 5, 21), ``shop`` (n, 18), ``storage`` (n, 4, 3) i32 and ``res``
    (n, 3) f32 are post-step; ``p_pre`` (n,) is the agent at step entry
    (the actor), ``agent`` the post-step agent."""
    n = piles.shape[0]
    ar = torch.arange(n, device=piles.device)
    pp = piles.reshape(n, 4, -1)[ar, p_pre]                    # (n, 105)
    pad = torch.zeros((n, 4 * _PILE_WORDS - pp.shape[1]), dtype=_i32,
                      device=pp.device)
    b = (torch.cat([pp, pad], 1) & 255).reshape(n, _PILE_WORDS, 4)
    pw = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    w32 = torch.zeros_like(p_pre)
    for k in range(16):
        w32 = w32 | ((shop[:, k] & 3) << (2 * k))
    over_s = shop.amax(1) > 3
    mach = torch.round(res[:, 0]).to(_i32)
    padd = torch.round(res[:, 1]).to(_i32)
    coin2 = torch.round(res[:, 2] * 2.0).to(_i32)
    over_r = (mach > 31) | (padd > 31) | (coin2 > 4095)
    w33 = ((shop[:, 16] & 3) | ((shop[:, 17] & 3) << 2) | (p_pre << 4)
           | (over_s.to(_i32) << 7) | (mach.clamp(0, 31) << 8)
           | (padd.clamp(0, 31) << 13) | (coin2.clamp(0, 4095) << 18)
           | (over_r.to(_i32) << 30))
    return torch.cat([base5, pw, w32[:, None], w33[:, None],
                      storage[ar, p_pre], storage[ar, agent]], 1)


def unpack_full(buf):
    """(..., RECORD_WORDS_FULL) i32 full records -> planar fields (numpy):
    the compact fields plus actor (...,), actor_piles (..., 5, 21) u8,
    shop (..., 18) u8, storage_row_p / storage_row_r (..., 3) i32, exact
    resources and the overflow flags."""
    buf = np.asarray(buf)
    out = unpack_records(buf[..., :RECORD_WORDS])
    w33 = buf[..., 33]
    counts = np.stack([(buf[..., 5 + j // 4] >> (8 * (j % 4))) & 255
                       for j in range(105)], axis=-1)
    out["actor"] = ((w33 >> 4) & 3).astype(np.uint8)
    out["actor_piles"] = counts.astype(np.uint8).reshape(
        buf.shape[:-1] + (5, 21))
    shop = [(buf[..., 32] >> (2 * k)) & 3 for k in range(16)]
    shop += [w33 & 3, (w33 >> 2) & 3]
    out["shop"] = np.stack(shop, axis=-1).astype(np.uint8)
    out["shop_overflow"] = ((w33 >> 7) & 1).astype(bool)
    # exact current_resources (supersedes word1's 3-bit fields)
    out["resources"] = np.stack(
        [((w33 >> 8) & 31).astype(np.float32),
         ((w33 >> 13) & 31).astype(np.float32),
         ((w33 >> 18) & 0xFFF).astype(np.float32) * 0.5], axis=-1)
    out["res_overflow"] = ((w33 >> 30) & 1).astype(bool)
    out["storage_row_p"] = buf[..., 34:37]
    out["storage_row_r"] = buf[..., 37:40]
    return out


def unpack_records(buf):
    """(..., RECORD_WORDS) i32 records -> dict of planar fields (numpy):
    actions (..., 5) u8, done bool, agent u8, phase u8, rewards (..., 4)
    i8, resources (..., 3) f32, sel_words (..., 3) i32."""
    buf = np.asarray(buf)
    w0 = buf[..., 0]
    w1 = buf[..., 1]
    actions = np.stack([(w0 >> (5 * i)) & 31 for i in range(5)],
                       axis=-1).astype(np.uint8)
    rew4 = np.stack([(w1 >> (4 * i)) & 0xF for i in range(4)], axis=-1)
    return {"actions": actions,
            "done": ((w0 >> 25) & 1).astype(bool),
            "agent": ((w0 >> 26) & 3).astype(np.uint8),
            "phase": ((w0 >> 28) & 3).astype(np.uint8),
            "rewards": rew4.astype(np.int8) << 4 >> 4,   # sign-extend
            "resources": np.stack(
                [((w1 >> 16) & 7).astype(np.float32),
                 ((w1 >> 19) & 7).astype(np.float32),
                 ((w1 >> 22) & 0x3FF).astype(np.float32) * 0.5], axis=-1),
            "sel_words": buf[..., 2:5]}


# ------------------------------------------------------------- consumers
class RingConsumer(threading.Thread):
    """Consumer thread draining a TrajectoryRing of packed records.

    Pops blocks of ``steps_per_push`` steps x n_envs x ``record_words``
    words, calls ``fn(records)`` on each (viewed int32, shape
    (steps_per_push, n, record_words)), counts the records and keeps a
    rolling xor checksum, so a run can show that the data moved. If
    ``fn`` raises, the thread stops and keeps the error in ``.error``."""

    def __init__(self, ring, steps_per_push: int, n_envs: int, fn=None,
                 record_words: int = RECORD_WORDS):
        super().__init__(daemon=True)
        self.ring = ring
        self.spp = steps_per_push
        self.n = n_envs
        self.fn = fn
        self.words = record_words
        self.records = 0
        self.checksum = np.int64(0)
        self.error = None
        self._stopping = threading.Event()

    def run(self):
        try:
            self._drain()
        except Exception as e:   # raised again by finish(), in the caller
            self.error = e

    def _drain(self):
        while True:
            # the stop flag is read before the pop: every block was pushed
            # before the flag was set, so a pop that finds the ring empty
            # after the flag was seen has taken the last block
            stopping = self._stopping.is_set()
            buf = self.ring.pop()
            if buf is None:
                if stopping:
                    return
                time.sleep(0.0005)
                continue
            rec = buf.view(np.int32).reshape(self.spp, self.n, self.words)
            self.records += self.spp * self.n
            flat = rec.reshape(-1)
            self.checksum ^= np.bitwise_xor.reduce(
                flat.view(np.int64) if flat.size % 2 == 0
                else flat.astype(np.int64))
            if self.fn is not None:
                self.fn(rec)

    def finish(self):
        """Stop once the ring is empty, join, and raise what ``fn``
        raised, if anything."""
        self._stopping.set()
        self.join()
        if self.error is not None:
            raise RuntimeError("the ring's consumer failed") from self.error


def parse_reset_buffer(buf, q_cap, n_envs):
    """Parse one reset keyframe (the reset queue's result at a chunk
    boundary, laid out as the JAX package's ``_reset_q`` result) into
    fields: idxs / valid / ok / overflow / min_xy / map_ids and
    dyn[name] of shape (q_cap, ...) in the engine's dtypes, fields in
    `engine.DYN_LAYOUT` order. Padding slots (idx >= n_envs) are dropped
    via ``valid``."""
    buf = np.asarray(buf)
    Q = q_cap
    idxs = buf[:Q]
    off = Q
    ok, over = int(buf[off]), int(buf[off + 1])
    off += 2
    min_xy = buf[off:off + 2 * Q].reshape(Q, 2)
    off += 2 * Q
    map_ids = buf[off:off + Q * _MAPW].reshape(Q, _MAPW)
    off += Q * _MAPW
    dyn = {}
    for name, shape, dt, _, size in E.DYN_LAYOUT:
        seg = buf[off:off + Q * size]
        off += Q * size
        if dt == torch.float32:
            seg = seg.view(np.float32)
        elif dt == torch.bool:
            seg = seg != 0
        dyn[name] = seg.reshape((Q,) + tuple(shape))
    if off != buf.size:
        raise ValueError(f"keyframe of {buf.size} words, expected {off} "
                         f"for q_cap={Q}")
    return {"idxs": idxs, "valid": idxs < n_envs, "ok": ok,
            "overflow": over, "min_xy": min_xy, "map_ids": map_ids,
            "dyn": dyn}


class ObsReconstructor:
    """Host mirror of the full observation surface, driven by the
    ``record="full"`` feed: each step's records update the acting
    player's piles, the shop, the two written storage-mask rows, the sel
    mask and the scalars; each reset keyframe refreshes every mirrored
    field of the envs reset at that chunk boundary, the map included.
    The port's analogue of the reference's per-step ObsData views
    (include/pybind/vectorized.h:60-150)."""

    def __init__(self, states, q_cap=None):
        def get(f, dt):
            return np.array(getattr(states, f).cpu().numpy(), dt)
        self.n = int(states.rng.shape[0])
        self.q_cap = q_cap
        self.piles = get("piles", np.uint8)
        self.shop = get("shop_stock", np.uint8)
        self.storage = get("storage_masks", np.int32)   # packed rows
        self.sel = get("sel_mask", np.int32)
        self.map_ids = get("map_ids", np.int32)
        self.min_xy = get("min_xy", np.int32)
        self.agent = get("agent", np.int32)
        self.phase = get("phase", np.int32)
        self.resources = get("resources", np.float32)
        self.done = get("done", bool)
        self._ar = np.arange(self.n)

    def apply_step(self, rec):
        """One step's (n, RECORD_WORDS_FULL) env-major full records."""
        d = unpack_full(rec)
        actor = d["actor"].astype(np.int64)
        ragent = d["agent"].astype(np.int64)
        self.piles[self._ar, actor] = d["actor_piles"]
        self.shop[:] = d["shop"]
        self.storage[self._ar, actor] = d["storage_row_p"]
        self.storage[self._ar, ragent] = d["storage_row_r"]
        self.sel[:] = rec[..., 2:5]
        self.agent[:] = ragent
        self.phase[:] = d["phase"]
        self.resources[:] = d["resources"]
        self.done[:] = d["done"]

    def apply_reset(self, buf):
        """One keyframe (raw buffer or `parse_reset_buffer` dict)."""
        if not isinstance(buf, dict):
            buf = parse_reset_buffer(buf, self.q_cap, self.n)
        v = buf["valid"]
        rows = buf["idxs"][v].astype(np.int64)
        self.map_ids[rows] = buf["map_ids"][v]
        self.min_xy[rows] = buf["min_xy"][v]
        dyn = buf["dyn"]
        self.piles[rows] = dyn["piles"][v]
        self.shop[rows] = dyn["shop_stock"][v]
        self.storage[rows] = dyn["storage_masks"][v]
        self.sel[rows] = dyn["sel_mask"][v]
        self.agent[rows] = dyn["agent"][v]
        self.phase[rows] = dyn["phase"][v]
        self.resources[rows] = dyn["resources"][v]
        self.done[rows] = dyn["done"][v]

    def observations(self):
        """The reference ObsData surface (include/api.h:84-129) of every
        env: map (n, 48, 48, 7) u8, phase, current_resources, shop, piles
        (n, 4, 5, 21), action_masks (n, 4, 92) from the storage rows,
        selected_action_masks (n, 92)."""
        from .core.cells import expand_obs_np
        return {
            "map": expand_obs_np(self.map_ids),
            "phase": self.phase.astype(np.uint8),
            "current_resources": self.resources,
            "shop": self.shop,
            "piles": self.piles,
            "action_masks": E.unpack_mask(
                torch.from_numpy(self.storage)).numpy(),
            "selected_action_masks": E.unpack_mask(
                torch.from_numpy(self.sel)).numpy(),
        }


def device_stats_init(device="cuda"):
    """Carry of the demo on-device consumer, on ``device``: (steps,
    done_steps, return_sum, action_histogram (5, 22)). done_steps counts
    per-step done flags (a finished env stays done while it dead-steps to
    its reset boundary, so this exceeds the episode count); return_sum is
    zero on full batches (the game is zero-sum)."""
    device = resolve(device)
    return (torch.zeros((), dtype=_i32, device=device),
            torch.zeros((), dtype=_i32, device=device),
            torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((5, 22), dtype=_i32, device=device))


def device_stats_fn(carry, traj):
    """Demo on-device consumer: folds one chunk's env-major (T, n,
    RECORD_WORDS or more) records into running statistics on the records'
    device, the pattern a co-located learner uses to train off the feed
    without the data leaving device memory."""
    steps, eps, ret, hist = carry
    w0 = traj[..., 0]
    w1 = traj[..., 1]
    done = (w0 >> 25) & 1
    steps = steps + traj.shape[0] * traj.shape[1]
    eps = eps + done.sum(dtype=_i32)
    for i in range(4):   # sign-extended 4-bit rewards where done
        r = (w1 >> (4 * i)) & 0xF
        r = torch.where(r >= 8, r - 16, r)
        ret = ret + torch.where(done != 0, r, 0).to(torch.float32).sum()
    rows = [torch.bincount(((w0 >> (5 * h)) & 31).reshape(-1),
                           minlength=32)[:22] for h in range(5)]
    hist = hist + torch.stack(rows).to(_i32)
    return (steps, eps, ret, hist)


# --------------------------------------------------------------- the feed
def stream_rollout(states, sampler_rngs, n_steps: int, chunk: int = 1500,
                   mask_src: str = "storage", ring=None,
                   steps_per_push: int = 100, consume=None,
                   deliver: str = "ring", device_fn=None,
                   device_carry=None, exact: bool = False,
                   record: str = "compact", compress: bool = False):
    """Chunked self-play (`vec.rollout_chunked`'s queued sync auto-reset)
    that delivers every step's records. K1 writes each chunk's (chunk, n,
    W) records on the card (W = `RECORD_WIDTH[record]`); then:

    * ``deliver="ring"``: each chunk's records are copied to pinned host
      memory on a side stream and pushed into ``ring`` (a native
      `TrajectoryRing`, made here when None) in blocks of
      ``steps_per_push`` steps while the card runs the next chunk; a
      `RingConsumer` (wrapping ``consume``) drains it concurrently.
      Returns (states, rngs, episodes, consumer), the consumer finished
      with ``.records`` and ``.checksum`` filled. With ``compress`` the
      records are delta-encoded on the card (`compress_chunk`), only the
      header and the used payload cross to the host, and they are
      decoded there (`decompress_chunk`) before the ring;
      ``consumer.tunnel_bytes`` counts what crossed.
    * ``deliver="device"``: no host transfer: ``device_fn(carry, records)``
      (default `device_stats_fn` from `device_stats_init`) folds each
      chunk's records on the card. Returns (states, rngs, episodes,
      device_carry). ``compress`` is refused here: nothing is fetched.

    ``exact=True`` freezes finished envs (K1's gate_dead): a dead step
    repeats the frozen record with done=1 and draws nothing, and the
    returned tuple gains the dead-step count.

    ``record="full"`` widens the records to the full observation surface
    and, on the ring path, collects each boundary's reset keyframe: the
    consumer gains ``.keyframes`` (ordered ``(chunk_index, buffer)``;
    keyframe k applies after chunk k's records), ``.q_cap`` and ``.feat``
    (the keyframe's dynamic fields as (name, shape, dtype)), so that
    `ObsReconstructor` can mirror ObsData field for field."""
    from .native import TrajectoryRing
    from .vec import _q_cap, _rollout_chunks
    if record not in RECORD_WIDTH:
        raise ValueError(f"record must be 'compact' or 'full', not {record!r}")
    words = RECORD_WIDTH[record]
    n = int(states.rng.shape[0])
    dev = states.rng.device
    if deliver == "device":
        if compress:
            raise ValueError("compress=True compresses what crosses to the "
                             "host; deliver='device' fetches nothing")
        if device_fn is None:
            device_fn, device_carry = device_stats_fn, device_stats_init(dev)

        def on_chunk(_, rec):
            nonlocal device_carry
            device_carry = device_fn(device_carry, rec)

        out = _rollout_chunks(states, sampler_rngs, max(1, n_steps // chunk),
                              chunk, mask_src, exact, record, on_chunk)
        result = out[:3] + (device_carry,)
        return result + (out[3],) if exact else result
    if deliver != "ring":
        raise ValueError(f"deliver must be 'ring' or 'device', not {deliver!r}")
    if chunk % steps_per_push:
        raise ValueError(f"chunk {chunk} is not a multiple of "
                         f"steps_per_push {steps_per_push}")
    if compress and record != "compact":
        raise ValueError("compress rides the compact record")
    if ring is None:
        ring = TrajectoryRing(steps_per_push * n * words * 4,
                              max(4, 4 * chunk // steps_per_push))
    consumer = RingConsumer(ring, steps_per_push, n, consume, words)
    feed = _RingFeed(ring, steps_per_push, consumer, dev, compress)
    consumer.start()
    try:
        out = _rollout_chunks(states, sampler_rngs, max(1, n_steps // chunk),
                              chunk, mask_src, exact, record, feed.chunk,
                              keyframes=record == "full")
        feed.finish()
    finally:
        consumer.finish()
    consumer.keyframes = [(ci, kf.cpu().numpy()) for ci, kf in out[4]]
    consumer.feat = [(f, shape, dt) for f, shape, dt, _, _ in E.DYN_LAYOUT]
    consumer.q_cap = _q_cap(n)
    result = out[:3] + (consumer,)
    return result + (out[3],) if exact else result


class _RingFeed:
    """Moves each chunk's records from the card into the ring.

    `chunk(ci, rec)` runs right after chunk ci's K1 launch: it starts the
    copy of chunk ci to pinned host memory on a side stream (after an
    event on the compute stream), then pushes chunk ci-1, whose copy was
    started a chunk earlier, while K1 runs chunk ci. The chunk loop
    (`vec._rollout_chunks`) double-buffers the device records; the host
    waits for chunk ci-1's copy here, in `chunk(ci)`, before it launches
    chunk ci+1, which reuses that buffer. The loop's boundaries read
    nothing back but the keyframes' queue count (``record="full"``), so
    this wait is what keeps the host at most a chunk ahead of the card on
    this path. CPU tensors need no copy: the records are read in place."""

    def __init__(self, ring, steps_per_push, consumer, device, compress):
        self.ring, self.spp, self.consumer = ring, steps_per_push, consumer
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.pinned = {}
        self.pending = None
        self.compress = compress
        self.cprev = self.hprev = None
        if compress:
            consumer.tunnel_bytes = 0

    def _host(self, key, t, after_compute=True):
        """Start copying ``t`` into the pinned buffer ``key`` (kept and
        grown as needed); returns a handle for `_wait`. The side stream
        first waits for the work queued so far on the compute stream,
        unless ``after_compute`` is False (``t`` is known ready on it)."""
        if not self.cuda:
            return t.numpy(), None
        buf = self.pinned.get(key)
        if buf is None or buf.numel() < t.numel():
            buf = self.pinned[key] = torch.empty(t.numel(), dtype=t.dtype,
                                                 pin_memory=True)
        dst = buf[:t.numel()].view(t.shape)
        if after_compute:
            self.side.wait_stream(torch.cuda.current_stream(t.device))
        t.record_stream(self.side)   # not reused before the copy is done
        ev = torch.cuda.Event()
        with torch.cuda.stream(self.side):
            dst.copy_(t, non_blocking=True)
            ev.record()
        return dst.numpy(), ev

    @staticmethod
    def _wait(handle):
        arr, ev = handle
        if ev is not None:
            ev.synchronize()
        return arr

    def chunk(self, ci, rec):
        if self.compress:
            if self.cprev is None:
                n = rec.shape[1]
                self.cprev = torch.zeros((n, 4), dtype=_i32,
                                         device=rec.device)
                self.hprev = np.zeros((n, 4), np.int32)
            hdr, payload, used, self.cprev = compress_chunk(rec, self.cprev)
            fetch = (self._host(("hdr", ci % 2), hdr),
                     self._host(("used", ci % 2), used), payload)
        else:
            fetch = self._host(("rec", ci % 2), rec)
        if self.pending is not None:
            self._drain(self.pending)
        self.pending = fetch

    def finish(self):
        if self.pending is not None:
            self._drain(self.pending)
            self.pending = None

    def _drain(self, fetch):
        if self.compress:
            hdr_h, used_h, payload = fetch
            hdr = self._wait(hdr_h)
            used = int(self._wait(used_h))
            # the side stream copied the header after the compression, so
            # the payload is ready there without waiting for the compute
            # stream, which runs the next chunk by now
            pay = self._wait(self._host("payload", payload[:used],
                                        after_compute=False))
            self.consumer.tunnel_bytes += hdr.nbytes + pay.nbytes + 4
            rec, self.hprev = decompress_chunk(hdr, pay, self.hprev)
        else:
            rec = self._wait(fetch)
        for t0 in range(0, rec.shape[0], self.spp):
            block = rec[t0:t0 + self.spp]
            while not self.ring.push(block):   # full: the consumer drains
                if not self.consumer.is_alive():
                    raise RuntimeError("the ring's consumer stopped") \
                        from self.consumer.error
                time.sleep(0.0005)


# ------------------------------------------------------------ compression
# The records change little from step to step: word0 (the action and the
# flags) always, words 1..4 only sometimes. compress_chunk delta-encodes a
# chunk on the card before the copy:
#
#   header (T, n) i32 — word0 repacked to exactly 32 bits: action (23b:
#     the five heads are 5/5/5/3/5-bit by their legal ranges) | done<<23
#     | agent<<24 | phase<<26 | chg<<28 (4 bits flagging which of words
#     1..4 changed against the previous step)
#   payload — the changed words' new values, compacted in flat (t, env,
#     word) order by a cumsum and a scatter; only payload[:used] crosses
#     to the host.
#
# Decompression is a forward fill on the host, bit-exact.
def compress_chunk(rec, prev):
    """(T, n, 5) i32 records + (n, 4) previous words 1..4 -> (header
    (T, n), payload (T*n*4,), used (0-d), new prev), on ``rec``'s device."""
    w0 = rec[..., 0]
    w = rec[..., 1:5]                                   # (T, n, 4)
    wprev = torch.cat([prev[None], w[:-1]], 0)
    chg = w != wprev
    hdr = ((w0 & 31) | (((w0 >> 5) & 31) << 5) | (((w0 >> 10) & 31) << 10)
           | (((w0 >> 15) & 7) << 15)                   # move head: <= 6
           | (((w0 >> 20) & 31) << 18)
           | (((w0 >> 25) & 1) << 23)                   # done
           | (((w0 >> 26) & 3) << 24)                   # agent
           | (((w0 >> 28) & 3) << 26))                  # phase
    for k in range(4):
        hdr = hdr | (chg[..., k].to(_i32) << (28 + k))
    flags = chg.reshape(-1)
    total = flags.shape[0]
    pos = torch.cumsum(flags.to(_i32), 0, dtype=_i32) - 1
    used = pos[-1] + 1
    idx = torch.where(flags, pos.long(), total)       # total: dropped
    payload = torch.zeros(total + 1, dtype=_i32, device=rec.device)
    payload.scatter_(0, idx, w.reshape(-1))
    return hdr, payload[:total], used, w[-1].clone()


def decompress_chunk(hdr, payload, prev):
    """Inverse of compress_chunk (numpy): -> ((T, n, 5) records, new
    prev). ``payload`` may be any prefix that covers the used words."""
    hdr = np.asarray(hdr)
    T, n = hdr.shape
    # heads 0-2 and the 3-bit move head keep their bits; head 4 and the
    # flags move back up
    w0 = ((hdr & 0x3FFFF) | (((hdr >> 18) & 31) << 20)
          | (((hdr >> 23) & 0x1F) << 25))
    chg = ((hdr[..., None] >> np.arange(28, 32, dtype=np.int32)) & 1
           ).astype(bool)                               # (T, n, 4)
    # row 0 is the carried prev; row t+1 holds step t's changed words
    table = np.empty((T + 1, n, 4), np.int32)
    table[0] = prev
    table[1:][chg] = np.asarray(payload)[:int(chg.sum())]
    # forward fill: each slot takes its value at its last change <= t
    last = np.where(chg, np.arange(1, T + 1, dtype=np.int32)[:, None, None],
                    0)
    np.maximum.accumulate(last, axis=0, out=last)
    w = np.take_along_axis(table, last, axis=0)         # (T, n, 4)
    rec = np.empty((T, n, 5), np.int32)
    rec[..., 0] = w0
    rec[..., 1:] = w
    return rec, w[-1].copy()
