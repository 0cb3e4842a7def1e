"""Vectorised environments: lockstep batches with queued auto-reset.

Port of ``eldorado_tpu/vec.py``'s reset and chunked-rollout surface. The env
batch is the leading axis of every `EnvState` field; the step runs as K1
(`ops.step_kernel.fused_step`, one launch per chunk) and every reset runs
map generation (plain torch) then K2 (`ops.step_kernel.fused_reset`). The
device of the input tensors decides where everything runs: CUDA tensors
take the kernels, CPU tensors the kernels' plain versions.
"""
from __future__ import annotations

import torch

from .core import engine as E
from .devices import resolve
from .errors import GenerateMapFailure, MapCapacityError
from .ops import rng as R
from .ops.step_kernel import fused_reset, fused_step
from .stream import RECORD_WIDTH

__all__ = ["vec_reset", "vec_reset_varied", "sampler_init",
           "check_map_generation", "rollout_chunked"]

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


def _reset_columns(carry, static, idx, queue_flags: bool, q_cap=None):
    """cog_env::reset for the envs ``idx`` of a carry: map generation from
    each env's engine state, then K2 on their gathered columns. Writes the
    carry columns and the map fields of ``static`` (a dict, in place).
    With ``queue_flags`` every reset env records the whole queue's ok /
    overflow outcome, as the JAX package's reset queue does
    (vec.py:_apply_q); otherwise each env records its own. Returns the
    queue's (ok, overflow) as device bools and, with ``q_cap``, its
    keyframe (`_keyframe`; else None)."""
    cols = carry[:, idx]
    n_players = static["n_players"][idx]
    gen, pxy, (req, nr, end) = E.reset_map_prelude(
        cols[_OFF["rng"]], static["n_pieces"][idx],
        static["difficulty"][idx], n_players)
    new = fused_reset(cols.contiguous(), n_players, pxy, req, nr, end)
    carry[:, idx] = new
    ok, over = gen.ok.all(), gen.overflow.any()
    static["map_ids"][idx] = gen.ids
    static["min_xy"][idx] = gen.min_xy
    static["map_ok"][idx] = ok if queue_flags else gen.ok
    static["map_overflow"][idx] = over if queue_flags else gen.overflow
    frame = (None if q_cap is None else
             _keyframe(idx, ok, over, gen, new, q_cap, carry.shape[1]))
    return ok, over, frame


def _keyframe(idx, ok, over, gen, cols, q_cap, n):
    """One reset queue's result as one int32 buffer, in the layout of the
    JAX package's reset-queue result (vec.py:_reset_q): [idxs (Q), ok,
    overflow, min_xy (Q, 2), map ids (Q, 2304), then each DYN field as
    (Q, size) in DYN_LAYOUT order], f32 as bits, bools as 0/1. Padding
    slots have idx = n and zeros elsewhere."""
    k, dev = idx.numel(), cols.device

    def slots(x, width):
        out = torch.zeros((q_cap, width), dtype=_i32, device=dev)
        out[:k] = x.reshape(k, width)
        return out.reshape(-1)

    idxs = torch.full((q_cap,), n, dtype=_i32, device=dev)
    idxs[:k] = idx
    parts = [idxs, ok.to(_i32)[None], over.to(_i32)[None],
             slots(gen.min_xy, 2), slots(gen.ids, E.GRIDSIZE * E.GRIDSIZE)]
    parts += [slots(cols[off:off + size].t(), size)
              for _, _, _, off, size in E.DYN_LAYOUT]
    return torch.cat(parts)


def _reset_all(states: E.EnvState) -> E.EnvState:
    static = {f: getattr(states, f).clone() for f in E.STATIC_FIELDS}
    carry = E.pack_dyn(E.split_state(states)[1])
    idx = torch.arange(carry.shape[1], device=carry.device)
    _reset_columns(carry, static, idx, queue_flags=False)
    return E.merge_state(tuple(static[f] for f in E.STATIC_FIELDS),
                         E.unpack_dyn(carry))


def vec_reset(seed, n_envs, n_players=4, n_pieces=3, difficulty=0,
              max_steps=100000, check_maps=True, device="cuda"):
    """vec_cog_env::reset(seed, ...): env i is seeded with seed + i
    (include/vec_environment.h:38-44). Map generation, then K2 at full
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


def rollout_chunked(states, sampler_rngs, n_steps: int, chunk: int = 100,
                    mask_src: str = "storage", exact: bool = False):
    """Chunked self-play with queued auto-reset (the JAX package's
    ``rollout_chunked(backend="kernel", reset_mode="sync")``). The reset
    queue is synchronous: each boundary's queue is regenerated before the
    next chunk starts (the JAX package's async mode is not ported, so
    there is no ``reset_mode``). The port has no backend, block or
    interpret choice either, so those arguments are gone: the tensors'
    device picks the kernels (CUDA) or their plain versions (CPU).

    Per chunk: one K1 launch runs ``chunk`` steps (done envs dead-step);
    then up to Q = min(n, 1024, max(128, n // 32)) finished envs, lowest
    index first, are regenerated (map generation + K2) and written back;
    extra finishers dead-step to the next boundary. Envs still done after
    the last chunk are reset by a final sweep.

    ``exact``: finished envs consume no sampler draws while they wait, so
    each env's steps with dead steps excluded equal the reference's
    continuous same-step auto-reset trajectory
    (include/vec_environment.h:53-61). Returns (states, srngs, episodes),
    plus dead_steps when ``exact``."""
    states, srng, episodes, dead, _ = _rollout_chunks(
        states, sampler_rngs, max(1, n_steps // chunk), chunk, mask_src,
        exact)
    if exact:
        return states, srng, episodes, dead
    return states, srng, episodes


def _rollout_chunks(states, sampler_rngs, n_chunks: int, chunk: int,
                    mask_src: str, exact: bool, record=None, on_chunk=None,
                    keyframes: bool = False):
    """The chunk loop of `rollout_chunked` and `stream.stream_rollout`.

    With ``record`` ("compact" or "full") K1 writes each chunk's records
    into one of two (chunk, n, W) device buffers, alternating, and
    ``on_chunk(ci, records)`` is called right after chunk ci's K1 launch,
    before that boundary's reset queue (so the caller may read chunk ci-1's
    buffer while the card runs chunk ci). With ``keyframes`` every
    boundary that reset envs gives ``(ci, keyframe)`` (`_keyframe`).
    Returns (states, srng, episodes, dead_steps, keyframes)."""
    dev = states.rng.device
    n = states.rng.shape[0]
    q_cap = _q_cap(n)
    static = {f: getattr(states, f).clone() for f in E.STATIC_FIELDS}
    carry = E.pack_dyn(E.split_state(states)[1])
    srng = sampler_rngs.to(_i32).contiguous()
    dead = torch.zeros(1, dtype=torch.int64, device=dev)
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    env_ids = torch.arange(n, device=dev)
    bufs = ([torch.empty((chunk, n, RECORD_WIDTH[record]), dtype=_i32,
                         device=dev) for _ in range(2)] if record else None)
    frames = []
    for ci in range(n_chunks):
        recs = bufs[ci % 2] if record else None
        carry, srng, _ = fused_step(
            carry, srng, static["map_ids"], static["min_xy"],
            static["n_players"], static["max_steps"], chunk, mask_src,
            gate_dead=exact, dead=dead, record=record, records=recs)
        if on_chunk is not None:
            on_chunk(ci, recs)
        # sync mode resets every queued env at the boundary that queued
        # it, so the JAX path's in-flight mask is empty here: every done
        # env is newly done
        done = carry[_OFF["done"]] != 0
        key = torch.where(done, env_ids, n)
        idx = torch.sort(key).values[:q_cap]
        count = int((idx < n).sum())
        if count:
            ok, over, frame = _reset_columns(
                carry, static, idx[:count], queue_flags=True,
                q_cap=q_cap if keyframes else None)
            if frame is not None:
                frames.append((ci, frame))
            episodes += count
            failed |= ~ok
            overflow |= over
    if bool(overflow):
        raise MapCapacityError(
            "queued reset: map generation overflowed a fixed capacity")
    if bool(failed):
        raise GenerateMapFailure(
            "queued reset: map generation failed > MAX_FAILURES times")
    # envs beyond the last queue get the sweep, keeping the auto-reset
    # contract
    left = torch.nonzero(carry[_OFF["done"]] != 0).flatten()
    if left.numel():
        _reset_columns(carry, static, left, queue_flags=False)
        episodes += left.numel()
    states = E.merge_state(tuple(static[f] for f in E.STATIC_FIELDS),
                           E.unpack_dyn(carry))
    if left.numel():
        check_map_generation(states)
    return states, srng, int(episodes), int(dead), frames
