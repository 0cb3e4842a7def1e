"""Vectorised environments: lockstep batches with auto-reset.

Port of ``eldorado_tpu/vec.py``. The env batch is the leading axis of every
`EnvState` field. Self-play runs as K1 (`ops.step_kernel.fused_step`: the
sample and the step fused, a whole chunk per launch); a learner's own
actions step as K1-act (`ops.step_kernel.step_actions`, one step a
launch) and its sampler is K1-sample (`ops.step_kernel.sample`; VecEnv's
reads the masks from the carry, `ops.step_kernel.sample_carry`). Every
reset runs K3 (map generation and its prelude, `core.mapgen.launch`) then
K2 (`ops.step_kernel.fused_reset`), both on the batch's own rows and
columns. The device of the input tensors decides where everything runs:
CUDA tensors take the kernels, CPU tensors the kernels' plain versions.

Auto-reset follows vec_cog_env::step_single
(include/vec_environment.h:53-61): a done env resets with the same
parameters and its engine stream is not reseeded, so the observations
after the step that ended a game belong to the new episode.
"""
from __future__ import annotations

import torch

from .core import engine as E
from .core.cells import expand_obs
from .devices import resolve
from .errors import GenerateMapFailure, MapCapacityError
from .ops import rng as R
from .ops import step_kernel as K
from .ops.step_kernel import (fused_reset, fused_step, sample, sample_carry,
                              step_actions)

__all__ = ["VecEnv", "vec_reset", "vec_reset_varied", "vec_step",
           "vec_sample", "rollout", "rollout_chunked", "kernel_rollout",
           "sampler_init", "reset_done", "reset_done_bucketed",
           "check_map_generation"]

_i32 = torch.int32
_OFF = {f: off for f, _, _, off, _ in E.DYN_LAYOUT}


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
    if bool(states.map_overflow.any()):
        raise MapCapacityError(
            "map generation overflowed a fixed capacity (MAX_PLACED); "
            "raise MAX_PLACED in core/mapgen.py for these reset parameters")
    if not bool(states.map_ok.all()):
        raise GenerateMapFailure(
            "map generation failed more than MAX_FAILURES times "
            "(reference: generate_map_failure)")
    return states


def _q_cap(n: int) -> int:
    """Reset-queue capacity per chunk boundary (the JAX package's Q)."""
    return min(n, 1024, max(128, n // 32))


_MAP_FIELDS = ("map_ids", "min_xy", "map_ok", "map_overflow")


def _reset_columns(carry, static, idx, queue_flags: bool):
    """cog_env::reset for the envs ``idx`` ((q,) int32, unique) of a carry,
    in place: map generation and the prelude from each env's engine state
    (K3 on the card), which write the map fields of ``static`` (a dict) at
    those rows, then K2 on the carry's columns. On the card the queue's
    columns go through no torch op between or around the two kernels. With
    ``queue_flags`` every reset env records the whole queue's ok /
    overflow outcome, as the JAX package's reset queue does
    (vec.py:_apply_q); otherwise each env records its own. Returns the
    queue's (ok, overflow) as device bools."""
    n_players = static["n_players"]
    pxy, (req, nr, end) = E.reset_map_prelude_rows(
        carry[_OFF["rng"]], static["n_pieces"], static["difficulty"],
        n_players, idx, tuple(static[f] for f in _MAP_FIELDS))
    fused_reset(carry, n_players, pxy, req, nr, end, idx=idx)
    rows = idx.long()
    ok = static["map_ok"][rows].all()
    over = static["map_overflow"][rows].any()
    if queue_flags:
        static["map_ok"][rows] = ok
        static["map_overflow"][rows] = over
    return ok, over


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
    _reset_columns(carry, static, idx, queue_flags=False)
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
    the reset)."""
    carry, n_done = step_actions(carry, actions, static["map_ids"],
                                 static["min_xy"], static["n_players"],
                                 static["max_steps"])
    done = carry[_OFF["done"]] != 0
    if n_done:
        n = carry.shape[1]
        key = torch.where(done, torch.arange(n, device=carry.device), n)
        idx = torch.sort(key).values[:n_done].to(_i32)
        _reset_columns(carry, static, idx, queue_flags=False)
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
    _reset_columns(carry, static, idx, queue_flags=False)
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
    par = (static["map_ids"], static["min_xy"], static["n_players"],
           static["max_steps"])
    if auto_reset == "none" and n_steps:
        carry, srng, _ = fused_step(carry, srng, *par, n_steps, mask_src,
                                    record="traj", records=recs)
    elif auto_reset == "step":
        rows = torch.tensor(K.TRAJ_ROWS, device=carry.device)
        for t in range(n_steps):
            carry, srng, _ = fused_step(carry, srng, *par, 1, mask_src,
                                        record="traj", records=recs[t:t + 1])
            idx = torch.nonzero(carry[_OFF["done"]]).flatten()
            if idx.numel():
                _reset_columns(carry, static, idx.to(_i32),
                               queue_flags=False)
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
    a later boundary. Envs still done after the last chunk are reset by a
    final sweep.

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


def _rollout_chunks(states, sampler_rngs, n_chunks: int, chunk: int,
                    mask_src: str, exact: bool, record=None, on_chunk=None,
                    keyframes: bool = False, deferred: bool = False):
    """The chunk loop of `rollout_chunked` and `stream.stream_rollout`.

    With ``record`` ("compact" or "full") K1 writes each chunk's records
    into one of two (chunk, n, W) device buffers, alternating, and
    ``on_chunk(ci, records)`` is called right after chunk ci's K1 launch,
    before that boundary's reset queue (so the caller may read chunk ci-1's
    buffer while the card runs chunk ci). With ``keyframes`` every
    boundary that reset envs gives ``(ci, keyframe)`` (`_keyframe`). With
    ``deferred`` (the async reset mode) each boundary's queue is taken
    from the done envs not in flight and reset at the next boundary, and
    the last one after the last chunk (the JAX package's
    _rollout_chunked_q with reset_mode="async", vec.py:806-852).
    Returns (states, srng, episodes, dead_steps, keyframes)."""
    dev = states.rng.device
    n = states.rng.shape[0]
    q_cap = _q_cap(n)
    static, carry = _split(states)
    srng = sampler_rngs.to(_i32).contiguous()
    dead = torch.zeros(1, dtype=torch.int64, device=dev)
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    env_ids = torch.arange(n, device=dev)
    bufs = ([torch.empty((chunk, n, K.RECORD_WORDS[record]), dtype=_i32,
                         device=dev) for _ in range(2)] if record else None)
    frames = []
    # the queued envs awaiting their deferred reset (sync mode resets
    # every queue at the boundary that took it)
    inflight = torch.zeros(n, dtype=torch.bool, device=dev) if deferred \
        else None
    pending = None

    def reset(ci, idx):
        nonlocal failed, overflow
        ok, over = _reset_columns(carry, static, idx, queue_flags=True)
        if keyframes:
            frames.append((ci, _keyframe(idx, ok, over, static, carry,
                                         q_cap)))
        failed |= ~ok
        overflow |= over

    for ci in range(n_chunks):
        recs = bufs[ci % 2] if record else None
        carry, srng, _ = fused_step(
            carry, srng, static["map_ids"], static["min_xy"],
            static["n_players"], static["max_steps"], chunk, mask_src,
            gate_dead=exact, dead=dead, record=record, records=recs)
        if on_chunk is not None:
            on_chunk(ci, recs)
        done = carry[_OFF["done"]] != 0
        if deferred:
            done &= ~inflight
        key = torch.where(done, env_ids, n)
        idx = torch.sort(key).values[:q_cap].to(_i32)
        count = int((idx < n).sum())
        queue = idx[:count] if count else None
        if deferred:
            if pending is not None:
                reset(ci, pending)
                inflight[pending.long()] = False
            if queue is not None:
                inflight[queue.long()] = True
            queue, pending = None, queue
        if queue is not None:
            reset(ci, queue)
        if count:
            episodes += count
    if pending is not None:
        reset(n_chunks, pending)
    if bool(overflow):
        raise MapCapacityError(
            "queued reset: map generation overflowed a fixed capacity")
    if bool(failed):
        raise GenerateMapFailure(
            "queued reset: map generation failed > MAX_FAILURES times")
    # envs beyond the last queue get the sweep, keeping the auto-reset
    # contract
    left = torch.nonzero(carry[_OFF["done"]] != 0).flatten().to(_i32)
    if left.numel():
        _reset_columns(carry, static, left, queue_flags=False)
        episodes += left.numel()
    states = _merge(static, carry)
    if left.numel():
        check_map_generation(states)
    return states, srng, int(episodes), int(dead), frames


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
        states = vec_reset(seed, self.n_envs, n_players, n_pieces,
                           difficulty, max_steps, device=self.device)
        self._static, self._carry = _split(states)
        self.sampler_rngs = sampler_init(sampler_seed, self.n_envs,
                                         device=self.device)
        return self.observations

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
