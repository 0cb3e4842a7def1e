"""Vectorised environments: lockstep batches with auto-reset.

Port of ``eldorado_tpu/vec.py``. The env batch is the leading axis of every
`EnvState` field. Self-play runs as K1 (`ops.step_kernel.fused_step`: the
sample and the step fused, a whole chunk per launch); a learner's own
actions step as K1-act (`ops.step_kernel.step_actions`, one step a
launch) and its sampler is K1-sample (`ops.step_kernel.sample`; VecEnv's
reads the masks from the carry, `ops.step_kernel.sample_carry`). Every
reset runs K3 (map generation and its prelude, `core.mapgen.launch`) then
K2 (`ops.step_kernel.fused_reset`), both on the batch's own rows and
columns; self-play's chunk boundaries choose and settle their queues on
the card around them (`ops.queue`: select and settle), so that the host
reads nothing between chunks. The device of the input tensors decides
where everything runs: CUDA tensors take the kernels, CPU tensors the
kernels' plain versions.

Auto-reset follows vec_cog_env::step_single
(include/vec_environment.h:53-61): a done env resets with the same
parameters and its engine stream is not reseeded, so the observations
after the step that ended a game belong to the new episode.
"""
from __future__ import annotations

import torch

from .core import engine as E
from .core import mapgen as MG
from .core.cells import expand_obs
from .devices import resolve
from .errors import GenerateMapFailure, MapCapacityError
from .ops import queue as Q
from .ops import rng as R
from .ops import step_kernel as K
from .ops.step_kernel import (fused_reset, fused_step, sample, sample_carry,
                              step_actions)
from .spans import span

__all__ = ["VecEnv", "vec_reset", "vec_reset_varied", "vec_step",
           "vec_sample", "rollout", "rollout_chunked", "kernel_rollout",
           "sampler_init", "reset_done", "reset_done_bucketed",
           "check_map_generation", "queue_work"]

_i32 = torch.int32
_OFF = {f: off for f, _, _, off, _ in E.DYN_LAYOUT}
# the chunk loops' queued resets in this process and K3's work on them
# (`queue_work`), added at each loop's end from its one tally read
_QUEUE_WORK = dict.fromkeys(("resets", "trips", "slowest_lane_trips"), 0)


def _seeds(seed, n, device):
    """seed + i for i < n, as uint32 values (vec_environment.h:38-44)."""
    return (torch.arange(n, dtype=torch.int64, device=device)
            + int(seed)) & 0xFFFFFFFF


def sampler_init(seed, n_envs, device="cuda"):
    """Sampler i's engine seeded with seed + i (include/vec_sampler.h),
    on ``device``."""
    device = resolve(device)
    return R.seed(_seeds(seed, n_envs, device), device=device)


def check_map_generation(states):
    """Raise if any env's last map generation failed (the analogue of the
    reference throwing generate_map_failure out of reset,
    src/map.cpp:736-740)."""
    _raise_map_failures(bool(states.map_overflow.any()),
                        not bool(states.map_ok.all()))
    return states


def _raise_map_failures(overflow, failed):
    """`check_map_generation`'s errors, the capacity one first."""
    if overflow:
        raise MapCapacityError(
            "map generation overflowed a fixed capacity (MAX_PLACED); "
            "raise MAX_PLACED in core/mapgen.py for these reset parameters")
    if failed:
        raise GenerateMapFailure(
            "map generation failed more than MAX_FAILURES times "
            "(reference: generate_map_failure)")


def queue_work() -> dict:
    """K3's work on the chunk loops' reset queues (`rollout_chunked`,
    `stream.stream_rollout`, `parallel.runner`) in this process so far:
    ``resets`` (envs reset by a queue; the end-of-call sweep's are not
    counted), ``trips`` (their generator trips), ``slowest_lane_trips``
    (over each queue, its count times its most trips: the lanes' time a
    launch holds while it waits for its slowest env). Totals as ints, read
    from each loop's tally at its end; nothing is read at a boundary."""
    return dict(_QUEUE_WORK)


def _q_cap(n: int) -> int:
    """Reset-queue capacity per chunk boundary (the JAX package's Q)."""
    return min(n, 1024, max(128, n // 32))


_MAP_FIELDS = ("map_ids", "min_xy", "map_ok", "map_overflow")


def _reset_columns(carry, static, idx):
    """cog_env::reset for the envs ``idx`` ((q,) int32, unique) of a carry,
    in place: map generation and the prelude from each env's engine state
    (K3 on the card), which write the map fields of ``static`` (a dict) at
    those rows, each env its own map flags, then K2 on the carry's
    columns. On the card the queue's columns go through no torch op
    between or around the two kernels. Span ``ed.reset``."""
    with span("ed.reset"):
        n_players = static["n_players"]
        pxy, (req, nr, end) = E.reset_map_prelude_rows(
            carry[_OFF["rng"]], static["n_pieces"], static["difficulty"],
            n_players, idx, tuple(static[f] for f in _MAP_FIELDS))
        fused_reset(carry, n_players, pxy, req, nr, end, idx=idx)


def _keyframe(idx, ok, over, static, carry, q_cap):
    """One reset queue's result as one int32 buffer, in the layout of the
    JAX package's reset-queue result (vec.py:_reset_q): [idxs (Q), ok,
    overflow, min_xy (Q, 2), map ids (Q, 2304), then each DYN field as
    (Q, size) in DYN_LAYOUT order], f32 as bits, bools as 0/1, read from
    the batch after the queue's reset. Padding slots have idx = n and
    zeros elsewhere."""
    k, dev, n = idx.numel(), carry.device, carry.shape[1]
    rows = idx.long()
    cols = carry[:, rows]

    def slots(x, width):
        out = torch.zeros((q_cap, width), dtype=_i32, device=dev)
        out[:k] = x.reshape(k, width)
        return out.reshape(-1)

    idxs = torch.full((q_cap,), n, dtype=_i32, device=dev)
    idxs[:k] = idx
    parts = [idxs, ok.to(_i32)[None], over.to(_i32)[None],
             slots(static["min_xy"][rows], 2),
             slots(static["map_ids"][rows], E.GRIDSIZE * E.GRIDSIZE)]
    parts += [slots(cols[off:off + size].t(), size)
              for _, _, _, off, size in E.DYN_LAYOUT]
    return torch.cat(parts)


def _split(states: E.EnvState):
    """(static fields as a dict of copies, the (W, n) carry)."""
    return ({f: getattr(states, f).clone() for f in E.STATIC_FIELDS},
            E.pack_dyn(E.split_state(states)[1]))


def _merge(static, carry) -> E.EnvState:
    return E.merge_state(tuple(static[f] for f in E.STATIC_FIELDS),
                         E.unpack_dyn(carry))


def _reset_all(states: E.EnvState) -> E.EnvState:
    static, carry = _split(states)
    idx = torch.arange(carry.shape[1], dtype=_i32, device=carry.device)
    _reset_columns(carry, static, idx)
    return _merge(static, carry)


def vec_reset(seed, n_envs, n_players=4, n_pieces=3, difficulty=0,
              max_steps=100000, check_maps=True, device="cuda"):
    """vec_cog_env::reset(seed, ...): env i is seeded with seed + i
    (include/vec_environment.h:38-44). K3 (map generation), then K2 at full
    width, on ``device``. Unless ``check_maps=False``, raises
    `GenerateMapFailure` / `MapCapacityError` when any env's procgen
    failed."""
    device = resolve(device)
    states = _reset_all(E.make_state(_seeds(seed, n_envs, device),
                                     n_players, n_pieces, difficulty,
                                     max_steps, device=device))
    return check_map_generation(states) if check_maps else states


def vec_reset_varied(seeds, n_players=4, n_pieces=3, difficulty=0,
                     max_steps=100000, check_maps=True, device="cuda"):
    """Heterogeneous lockstep batch on ``device``: every argument may be a
    scalar or an (n_envs,) sequence, and env i resets with its own
    parameters."""
    device = resolve(device)
    seeds = torch.as_tensor(seeds, device=device).to(torch.int64)
    states = _reset_all(E.make_state(seeds, n_players, n_pieces, difficulty,
                                     max_steps, device=device))
    return check_map_generation(states) if check_maps else states


def _step_columns(carry, static, actions):
    """`vec_step` on a carry and its static fields (a dict, whose map rows
    the resets write in place): K1-act, then the envs done after it reset
    (K3, then K2). Returns (the new carry, done after the step and before
    the reset). Span ``ed.step``."""
    with span("ed.step"):
        carry, n_done = step_actions(carry, actions, static["map_ids"],
                                     static["min_xy"], static["n_players"],
                                     static["max_steps"])
        done = carry[_OFF["done"]] != 0
        if n_done:
            n = carry.shape[1]
            key = torch.where(done, torch.arange(n, device=carry.device), n)
            idx = torch.sort(key).values[:n_done].to(_i32)
            _reset_columns(carry, static, idx)
        return carry, done


def _actions(actions, device):
    return torch.as_tensor(actions, device=device).to(_i32).contiguous()


def vec_step(states, actions):
    """Step every env with ``actions`` ((n, 5) int32: play, play_special,
    remove, move, get_from_shop) and auto-reset the envs that finished
    (same parameters, same engine stream). K1-act, then K3 and K2 on the
    done envs' rows and columns. Returns (states, done): ``done`` is the
    flag after the step, before the reset. Raises ValueError when an
    action lies outside its head (`ops.step_kernel.HEAD_WIDTHS`)."""
    static, carry = _split(states)
    carry, done = _step_columns(carry, static,
                                _actions(actions, carry.device))
    return _merge(static, carry), done


def vec_sample(rngs, masks):
    """The batched masked-uniform sampler: sampler i has its own engine
    (include/vec_sampler.h:7-28 seeds it with seed + i), ``masks`` (n, 92)
    bool. Returns (actions (n, 5), rngs', tainted (n,)): ``tainted`` flags
    the once-per-1e16-draws double-rejection deviation from the exact
    libstdc++ stream. K1-sample on the card."""
    words = E.pack_mask(torch.as_tensor(masks, device=rngs.device))
    return sample(rngs.to(_i32).contiguous(), words.contiguous())


def reset_done(states):
    """Auto-reset every done env (same parameters, same engine stream)."""
    return reset_done_bucketed(states, check_maps=False)[0]


def reset_done_bucketed(states, done=None, check_maps=True):
    """Reset exactly the done envs (or those that ``done``, an (n,) bool,
    names), in place on the batch's rows and columns (K3, then K2). The
    JAX package pads the envs to a bucket of sizes (vec.py:227) only to
    bound XLA's compiled shapes; the port resets the envs themselves.
    Unless ``check_maps=False``, raises when a map generation failed.
    Returns (states, n_episodes)."""
    if done is None:
        done = states.done
    done = torch.as_tensor(done, device=states.rng.device)
    idx = torch.nonzero(done).flatten().to(_i32)
    if idx.numel() == 0:
        return states, 0
    static, carry = _split(states)
    _reset_columns(carry, static, idx)
    states = _merge(static, carry)
    if check_maps:
        check_map_generation(states)
    return states, int(idx.numel())


def rollout(states, sampler_rngs, n_steps: int, mask_src: str = "storage",
            auto_reset: str = "none"):
    """Self-play over ``n_steps`` sample + step rounds (the reference's
    runner.sample(); runner.step_sync() loop). Returns (states, srngs,
    traj): traj is the per-step (actions, done, rewards, agent, sel_mask
    words, resources, phase), each (n_steps, n, ...), which K1 writes as
    its trajectory record (`ops.step_kernel.pack_traj`).

    ``auto_reset``:
      * "none": one K1 launch runs every step; done envs dead-step
        (cog_env::step's early-out, src/environment.cpp:92-95) and every
        field is the state after the step.
      * "step": one K1 launch per step, then the envs that step finished
        reset (K3, then K2), as vec_cog_env does inside its step. As in the
        JAX package, ``actions`` and ``done`` are the step's own and the
        other fields the state after the reset.
    """
    if auto_reset not in ("none", "step"):
        raise ValueError(f"auto_reset must be 'none' or 'step', not "
                         f"{auto_reset!r}")
    static, carry = _split(states)
    srng = sampler_rngs.to(_i32).contiguous()
    n = carry.shape[1]
    recs = torch.empty((n_steps, n, K.TRAJ_WORDS), dtype=_i32,
                       device=carry.device)
    if auto_reset == "none" and n_steps:
        carry, srng, _ = fused_step(carry, srng, *_params(static), n_steps,
                                    mask_src, record="traj", records=recs)
    elif auto_reset == "step":
        rows = torch.tensor(K.TRAJ_ROWS, device=carry.device)
        for t in range(n_steps):
            carry, srng, _ = fused_step(carry, srng, *_params(static), 1,
                                        mask_src, record="traj",
                                        records=recs[t:t + 1])
            idx = _reset_done_columns(carry, static)
            if idx.numel():
                # the reset envs' record: their state after the reset
                rec = recs[t]
                rec[idx, 1:] = carry[rows][:, idx].t()
                rec[idx, 0] = ((rec[idx, 0] & ((1 << 26) - 1))
                               | (carry[_OFF["agent"], idx] << 26)
                               | (carry[_OFF["phase"], idx] << 28))
    return _merge(static, carry), srng, K.unpack_traj(recs)


def kernel_rollout(states, sampler_rngs, n_steps: int,
                   mask_src: str = "storage"):
    """`rollout` with ``auto_reset="none"``, returning the first four
    per-step fields (actions, done, rewards, agent), as the JAX package's
    Pallas-driven kernel_rollout does. Its ``block`` and ``interpret``
    arguments are the TPU build's and are gone."""
    states, srng, traj = rollout(states, sampler_rngs, n_steps, mask_src)
    return states, srng, traj[:4]


def rollout_chunked(states, sampler_rngs, n_steps: int, chunk: int = 100,
                    mask_src: str = "storage", exact: bool = False,
                    reset_mode: str = "sync"):
    """Chunked self-play with queued auto-reset (the JAX package's
    ``rollout_chunked(backend="kernel")``). The port has no backend, block
    or interpret choice, so those arguments are gone: the tensors' device
    picks the kernels (CUDA) or their plain versions (CPU).

    Per chunk: one K1 launch runs ``chunk`` steps (done envs dead-step);
    then a reset queue takes up to Q = min(n, 1024, max(128, n // 32))
    newly finished envs, lowest index first; extra finishers dead-step to
    a later boundary. The queue is chosen, sized, reset and settled on the
    card (`_ChunkLoop`): the host reads nothing until the call's end.
    Envs still done after the last chunk are reset by a final sweep.

    ``reset_mode``:
      * "sync" (default): each boundary's queue is regenerated in place
        before the next chunk starts (K3, then K2).
      * "async": each boundary's queue is reset one boundary later, after
        the next chunk's K1 launch (K3, then K2). A queued env
        stays done and frozen meanwhile, so its reset has the values an
        immediate one would, one chunk later; an in-flight mask keeps it
        out of the next queue. This is the JAX package's async mode, whose
        queue ran on the host CPU backend only to overlap the TPU's scan
        (vec.py:758-764); on the card K3 and K2 queue behind K1 on the
        same stream, so the delay is the mode's only effect.

    ``exact``: finished envs consume no sampler draws while they wait, so
    each env's steps with dead steps excluded equal the reference's
    continuous same-step auto-reset trajectory
    (include/vec_environment.h:53-61). Returns (states, srngs, episodes),
    plus dead_steps when ``exact``."""
    if reset_mode not in ("sync", "async"):
        raise ValueError(f"reset_mode must be 'sync' or 'async', not "
                         f"{reset_mode!r}")
    states, srng, episodes, dead, _ = _rollout_chunks(
        states, sampler_rngs, max(1, n_steps // chunk), chunk, mask_src,
        exact, deferred=reset_mode == "async")
    if exact:
        return states, srng, episodes, dead
    return states, srng, episodes


def _params(static):
    """K1's and K1-act's per-env inputs among the static fields."""
    return (static["map_ids"], static["min_xy"], static["n_players"],
            static["max_steps"])


def _reset_done_columns(carry, static):
    """Reset the envs done in ``carry`` (K3, then K2), each recording its
    own map flags; returns their rows ((k,) int64). One host read."""
    idx = torch.nonzero(carry[_OFF["done"]]).flatten()
    if idx.numel():
        _reset_columns(carry, static, idx.to(_i32))
    return idx


def _rollout_chunks(states, sampler_rngs, n_chunks: int, chunk: int,
                    mask_src: str, exact: bool, record=None, on_chunk=None,
                    keyframes: bool = False, deferred: bool = False):
    """The chunk loop of `rollout_chunked` and `stream.stream_rollout`: one
    `_ChunkLoop` driven by `_run_chunks`. Returns (states, srng, episodes,
    dead_steps, keyframes)."""
    loop = _ChunkLoop(states, sampler_rngs, chunk, mask_src, exact, record,
                      on_chunk, keyframes, deferred)
    [(states, srng, frames)], episodes, dead = _run_chunks([loop], n_chunks)
    return states, srng, episodes, dead, frames


class _ChunkLoop:
    """One batch's chunk loop, in the steps `_run_chunks` interleaves across
    batches: `launch` (chunk ci's K1), `boundary` (its reset queue), `flush`
    (async's last queue) and `sweep`. The batch is a whole
    `rollout_chunked` batch or one shard of `parallel.runner`'s, with its
    own queue capacity `_q_cap(n)`.

    A boundary chooses, sizes, resets and settles its queue on the device
    in stream order, and the host reads nothing back: `ops.queue.select`
    takes the lowest-indexed done envs (not in flight), up to the capacity,
    into the loop's queue buffer and writes their count to the device; K3
    and K2 run at the queue's capacity, their slots past the count empty;
    `ops.queue.settle` writes the queue's map flags and adds the queue to
    the loop's tally (episodes, failed, overflow; K1 adds the dead steps
    beside them; then K3's trips and slowest-lane trips, from the per-slot
    counts K3 writes into the loop's work buffer), which
    `_end_chunks` reads once. The loop allocates its buffers and checks
    every launch's tensors once, here; the launches at the boundaries go
    unchecked (CPU tensors take the plain versions). K1 writes out of
    place into two carries and two engine rows taken in turn.

    With ``record`` ("compact" or "full") K1 writes each chunk's records
    into one of two (chunk, n, W) device buffers, alternating, and
    ``on_chunk(ci, records)`` is called right after chunk ci's K1 launch,
    before that boundary's reset queue (so the caller may read chunk ci-1's
    buffer while the card runs chunk ci). With ``keyframes`` every
    boundary that reset envs gives ``(ci, keyframe)`` (`_keyframe`) in
    ``frames``, for which it reads the queue's count back. With
    ``deferred`` (the async reset mode) each boundary's queue is taken
    from the done envs not in flight and reset at the next boundary, and
    the last one after the last chunk (the JAX package's
    _rollout_chunked_q with reset_mode="async", vec.py:806-852).

    Counters (the launch counters' kind, over every loop of the process):
    ``_ChunkLoop.boundaries`` and ``_ChunkLoop.boundary_reads``, the host
    reads among them. Spans: ``ed.rollout.begin`` (the set-up, whole) and
    ``ed.reset`` (a queue's K3, K2 and settle)."""

    boundaries = 0
    boundary_reads = 0

    def __init__(self, states, sampler_rngs, chunk: int, mask_src: str,
                 exact: bool, record=None, on_chunk=None,
                 keyframes: bool = False, deferred: bool = False):
        with span("ed.rollout.begin"):
            dev = states.rng.device
            self.cuda = dev.type == "cuda"
            n = states.rng.shape[0]
            self.q_cap = q_cap = _q_cap(n)
            self.chunk, self.mask_src, self.exact = chunk, mask_src, exact
            self.record, self.on_chunk, self.keyframes = record, on_chunk, \
                keyframes
            self.static, carry = _split(states)
            self.maps = tuple(self.static[f] for f in _MAP_FIELDS)
            self.srng = sampler_rngs.to(_i32).contiguous()
            # (carry, sampler engines, its done row, its rng row) x 2: K1
            # reads one and writes the other; the caller's engines are only
            # read
            self.slots = [(c, torch.empty_like(self.srng), c[_OFF["done"]],
                           c[_OFF["rng"]])
                          for c in (carry, torch.empty_like(carry))]
            self.cur = 0
            self.act = torch.empty((n, 5), dtype=_i32, device=dev)
            # episodes, failed, overflow (settle's), dead steps (K1's),
            # trips, slowest-lane trips (settle's, from K3's per-slot
            # counts in `work`)
            self.tally = torch.zeros(6, dtype=torch.int64, device=dev)
            self.settled, self.dead = self.tally[:3], self.tally[3:4]
            self.counters = (torch.empty((q_cap, 2), dtype=_i32, device=dev),
                             self.tally[4:])
            self.bufs = ([torch.empty((chunk, n, K.RECORD_WORDS[record]),
                                      dtype=_i32, device=dev)
                          for _ in range(2)] if record else None)
            self.frames = []
            # a queue: idx (q_cap,) and its count (1,), one buffer; async
            # holds two, the queue taken and the queue pending its reset
            bufs = torch.empty((2 if deferred else 1, q_cap + 1), dtype=_i32,
                               device=dev)
            self.queues = [(b[:q_cap], b[q_cap:]) for b in bufs]
            self.prelude = E._prelude_out(q_cap, dev)
            self.inflight = torch.zeros(n, dtype=torch.bool, device=dev) \
                if deferred else None
            self.pending = None
            self._check()

    def _check(self):
        """Every launch's checks, once."""
        st = self.static
        carry, srng, done, rng = self.slots[0]
        K.check_fused_step(carry, srng, *_params(st), self.chunk,
                           self.mask_src, self.dead, record=self.record,
                           records=self.bufs[0] if self.record else None)
        for idx, count in self.queues:
            Q.check(done, self.inflight, idx, count, st["map_ok"],
                    st["map_overflow"], self.settled, self.counters)
            K.check_fused_reset(carry, st["n_players"], *self.prelude, idx,
                                count)
            if self.cuda:
                MG.check_launch(rng, st["n_pieces"], st["difficulty"],
                                self.maps, idx, n_players=st["n_players"],
                                prelude=self.prelude, count=count,
                                work=self.counters[0])

    @property
    def carry(self):
        return self.slots[self.cur][0]

    def launch(self, ci):
        recs = self.bufs[ci % 2] if self.record else None
        carry, dst = self.carry, self.slots[1 - self.cur]
        if self.cuda:
            K.launch_fused_step(carry, self.srng, *_params(self.static),
                                self.chunk, self.mask_src, self.exact,
                                self.dead, self.record, recs, dst[0], dst[1],
                                self.act)
        else:
            out, srng, _ = K.fused_step_plain(
                carry, self.srng, *_params(self.static), self.chunk,
                self.mask_src, self.exact, self.dead, record=self.record,
                records=recs)
            dst[0].copy_(out)
            dst[1].copy_(srng)
        self.cur, self.srng = 1 - self.cur, dst[1]
        if self.on_chunk is not None:
            self.on_chunk(ci, recs)

    def boundary(self, ci):
        _ChunkLoop.boundaries += 1
        queue = self.queues[ci % len(self.queues)]
        done = self.slots[self.cur][2]
        if self.cuda:
            Q.launch_select(done, self.inflight, *queue)
        else:
            Q.select_plain(done, self.inflight, *queue)
        if self.inflight is not None:
            queue, self.pending = self.pending, queue
        if queue is not None:
            self._reset(ci, queue)

    def _reset(self, ci, queue):
        """A queue's reset in stream order: K3, K2 at the queue's capacity
        with its device count, then settle. Span ``ed.reset``."""
        idx, count = queue
        carry, _, _, rng = self.slots[self.cur]
        st, pre, work = self.static, self.prelude, self.counters[0]
        with span("ed.reset"):
            if self.cuda:
                MG.launch_generate_map(
                    rng, st["n_pieces"], st["difficulty"], self.maps, idx,
                    n_players=st["n_players"], prelude=pre, count=count,
                    work=work)
                K.launch_fused_reset(carry, carry, st["n_players"], *pre,
                                     idx, count)
                Q.launch_settle(idx, count, st["map_ok"], st["map_overflow"],
                                self.inflight, self.settled, self.counters)
            else:
                E.reset_map_prelude_rows_plain(
                    rng, st["n_pieces"], st["difficulty"], st["n_players"],
                    idx, self.maps, count, pre, work)
                K.fused_reset_plain(carry, st["n_players"], *pre, idx, count)
                Q.settle_plain(idx, count, st["map_ok"], st["map_overflow"],
                               self.inflight, self.settled, self.counters)
        if self.keyframes:
            _ChunkLoop.boundary_reads += 1
            k = int(count)
            if k:
                rows = idx[:k]
                self.frames.append((ci, _keyframe(
                    rows, st["map_ok"][rows.long()].all(),
                    st["map_overflow"][rows.long()].any(), st, carry,
                    self.q_cap)))

    def flush(self, n_chunks):
        if self.pending is not None:
            self._reset(n_chunks, self.pending)

    def sweep(self):
        """Reset the envs still done after the last queue, keeping the
        auto-reset contract. Returns (states, how many were reset)."""
        left = _reset_done_columns(self.carry, self.static).numel()
        return _merge(self.static, self.carry), left


def _run_chunks(loops, n_chunks: int, total=None):
    """Drive ``loops`` (`_ChunkLoop`s, each on its own device or sharing
    one) through ``n_chunks`` chunks: every loop's K1 launch of a chunk,
    then every loop's boundary, none of which reads the device. Then
    async's last queues, the loops' tallies (one read each), the queued
    resets' map failures (over every loop, MapCapacityError before
    GenerateMapFailure, as the JAX package's sharded runner orders them),
    the sweeps, and their map failures. ``total`` sums a list of ints over
    the processes of a group (`parallel.bootstrap.total`); none: this
    process alone. Returns ([(states, srng, keyframes)] by loop, episodes,
    dead_steps), summed over the loops and the processes. Spans:
    ``ed.rollout`` (the whole) and ``ed.rollout.end`` (all after the last
    boundary)."""
    total = total or (lambda values: values)
    with span("ed.rollout"):
        for ci in range(n_chunks):
            for loop in loops:
                loop.launch(ci)
            for loop in loops:
                loop.boundary(ci)
        with span("ed.rollout.end"):
            return _end_chunks(loops, n_chunks, total)


def _end_chunks(loops, n_chunks: int, total):
    """`_run_chunks` after the last boundary: async's last queues, the
    tallies (K3's work into `queue_work`), the map failures, the sweeps and
    the merges."""
    for loop in loops:
        loop.flush(n_chunks)
    # episodes, failed, overflow, dead steps, trips, slowest-lane trips:
    # one read a loop
    tallies = [loop.tally.tolist() for loop in loops]
    for key, col in (("resets", 0), ("trips", 4), ("slowest_lane_trips", 5)):
        _QUEUE_WORK[key] += sum(t[col] for t in tallies)
    overflow, failed = total([sum(t[2] for t in tallies),
                              sum(t[1] for t in tallies)])
    if overflow:
        raise MapCapacityError(
            "queued reset: map generation overflowed a fixed capacity")
    if failed:
        raise GenerateMapFailure(
            "queued reset: map generation failed > MAX_FAILURES times")
    swept = [loop.sweep() for loop in loops]
    episodes, dead, overflow, failed = total([
        sum(t[0] + left for t, (_, left) in zip(tallies, swept)),
        sum(t[3] for t in tallies),
        sum(int(left > 0 and bool(st.map_overflow.any()))
            for st, left in swept),
        sum(int(left > 0 and not bool(st.map_ok.all()))
            for st, left in swept)])
    _raise_map_failures(overflow, failed)
    return ([(st, lp.srng, lp.frames) for lp, (st, _) in zip(loops, swept)],
            episodes, dead)


class VecEnv:
    """Stateful wrapper in the shape of the reference's Python API
    (src/pybind/vectorized.cpp): ``reset``, then ``sample`` / ``step`` in
    a loop, and the observation surface as properties. The batch stays in
    K1's carry layout with its static fields between calls; an `EnvState`
    is built only when a property asks for one. ``device``: where the
    batch lives (the entry points' default, the card)."""

    def __init__(self, n_envs: int, mask_src: str = "storage",
                 device="cuda"):
        if mask_src not in ("storage", "sel"):
            raise ValueError(f"mask_src must be 'storage' or 'sel', not "
                             f"{mask_src!r}")
        self.n_envs = n_envs
        self.mask_src = mask_src
        self.device = resolve(device)
        self.sampler_rngs = None
        self._static = self._carry = None

    def reset(self, seed=0, n_players=4, n_pieces=3, difficulty=0,
              max_steps=100000, sampler_seed=42):
        self._attach(vec_reset(seed, self.n_envs, n_players, n_pieces,
                               difficulty, max_steps, device=self.device),
                     sampler_init(sampler_seed, self.n_envs,
                                  device=self.device))
        return self.observations

    def _attach(self, states, sampler_rngs):
        """Adopt a batch (an `EnvState` on this env's device) and its
        sampler engines."""
        self._static, self._carry = _split(states)
        self.sampler_rngs = sampler_rngs

    def step(self, actions):
        """`vec_step` on the batch; returns the done flags (n,)."""
        self._carry, done = _step_columns(self._carry, self._static,
                                          _actions(actions, self.device))
        return done

    def sample(self):
        """K1-sample on each env's active mask (its agent's storage row, or
        the sel mask), read from the carry; the tainted flags OR into
        ``rng_tainted``. One launch on the card (`sample_carry`)."""
        actions, self.sampler_rngs = sample_carry(
            self.sampler_rngs, self._carry, self.mask_src)
        return actions

    @property
    def states(self) -> E.EnvState:
        """The batch as an `EnvState` (copies)."""
        return _merge({f: t.clone() for f, t in self._static.items()},
                      self._carry)

    # -- reference observation surface ------------------------------------
    @property
    def observations(self):
        s = self.states
        return {
            "map": expand_obs(s.map_ids), "phase": s.phase,
            "current_resources": s.resources, "shop": s.shop_stock,
            "piles": s.piles,
            "action_masks": E.unpack_mask(s.storage_masks),
        }

    @property
    def selected_action_masks(self):
        return E.unpack_mask(self._field("sel_mask"))

    @property
    def agent_selection(self):
        return self._field("agent")

    @property
    def dones(self):
        return self._field("done")

    @property
    def rewards(self):
        return self._field("rewards")

    @property
    def infos(self):
        s = self.states
        return {
            "total_length": s.info_total, "steps_taken": s.info_steps,
            "returns": s.info_returns, "travelled_hexes": s.info_travelled,
            "cards_added": s.info_added, "cards_removed": s.info_removed,
            "n_machete_uses": torch.zeros_like(s.info_travelled),
            "n_paddle_uses": torch.zeros_like(s.info_travelled),
            "n_coin_uses": torch.zeros_like(s.info_travelled),
            "n_card_uses": s.info_card_uses,
        }

    def _field(self, name):
        """One DYN field of the batch, env-major."""
        return E.unpack_dyn(self._carry)[E.DYN_FIELDS.index(name)]
