"""The two kernels of the rollout: K1 `fused_step` and K2 `fused_reset`.

Port of ``eldorado_tpu/ops/step_kernel.py`` (``make_fused_step`` and
``make_fused_reset``, the Pallas programs of the TPU build). Both operate on
the field-major, env-minor carry of `engine.pack_dyn` ((W, n) int32).

Each wrapper dispatches on the device of its tensors: CPU tensors take the
plain torch version (`fused_step_plain`, `fused_reset_plain`, i.e. the
vmapped single-env engine); CUDA tensors launch the hand-written kernel of
``csrc/`` or raise. There is no fallback between the two. Each wrapper
counts its kernel launches in a plain int attribute, ``launches`` (and
``fused_step.null_launches`` for K1-null, K1's cost probe;
``fused_step.record_launches[record]`` for the launches that also wrote the
learner feed's records, which ``launches`` counts too).
"""
from __future__ import annotations

import ctypes

import torch

from .. import stream as S
from ..core import engine as E
from . import build

_i32 = torch.int32
_MASK_SRC = {"storage": 0, "sel": 1}


def _check(t, name, shape, dtype=_i32):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                         f"expected {tuple(shape)} {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ------------------------------------------------------------------- K1
_I = {f: i for i, f in enumerate(E.DYN_FIELDS)}
_RECORD_SEL = {None: 0, **S.RECORD_WIDTH}


def _pack_records(dyn, act, p_pre, record):
    """The plain version of what K1 writes per step: the post-step
    records of ``dyn`` (env-major DYN fields), (n, W)."""
    def f(name):
        return dyn[_I[name]]
    rec = S.pack_step(act, f("done"), f("rewards"), f("agent"),
                      f("sel_mask"), f("resources"), f("phase"))
    if record == "full":
        rec = S.pack_step_full(rec, f("piles"), f("shop_stock"),
                               f("storage_masks"), f("resources"), p_pre,
                               f("agent"))
    return rec


def fused_step_plain(carry, srng, map_ids, min_xy, n_players, max_steps,
                     n_steps: int, mask_src: str = "storage",
                     gate_dead: bool = False, dead=None,
                     null_body: bool = False, record=None, records=None):
    """Plain version of K1: ``n_steps`` sample+step rounds of
    `engine.fused_sample_step` on the carry. Adds the number of dead
    steps (env done at entry) to ``dead`` in place when given, and with
    ``record`` writes step t's records into ``records[t]`` (`stream.pack_step`
    / `stream.pack_step_full`). Returns (carry', srng', actions of the last
    step (n, 5)). With ``null_body`` (K1-null) it runs no step: copies of
    the carry and srng, zero actions, ``dead`` untouched."""
    act = torch.zeros((carry.shape[1], 5), dtype=_i32, device=carry.device)
    if null_body:
        return carry.clone(), srng.clone(), act
    dyn = E.unpack_dyn(carry)
    for t in range(n_steps):
        if dead is not None:
            dead += dyn[_I["done"]].sum()
        p_pre = dyn[_I["agent"]]
        dyn, srng, act = E.vstep(dyn, srng, map_ids, min_xy, n_players,
                                 max_steps, mask_src, gate_dead)
        if record is not None:
            records[t] = _pack_records(dyn, act, p_pre, record)
    return E.pack_dyn(dyn), srng, act


def fused_step(carry, srng, map_ids, min_xy, n_players, max_steps,
               n_steps: int, mask_src: str = "storage",
               gate_dead: bool = False, dead=None, null_body: bool = False,
               record=None, records=None):
    """K1: ``n_steps`` fused sample+step rounds over every env in one
    launch (csrc/step_kernel.cu). ``carry`` (W, n) int32 dyn state,
    ``srng`` (n,) sampler engines, ``map_ids`` (n, 2304), ``min_xy``
    (n, 2), ``n_players``/``max_steps`` (n,), all int32; ``dead`` an
    optional (1,) int64 counter of dead steps, incremented in place.
    ``gate_dead`` freezes done envs' sampler streams. Returns new
    (carry, srng, actions of the last step (n, 5)).

    ``record`` ("compact" or "full") also writes the learner feed: step
    t's post-step record of env e into ``records[t, e]``, a caller-given
    (n_steps, n, `stream.RECORD_WIDTH[record]`) int32 tensor (the layout
    of stream.py's module docstring).

    ``null_body`` launches K1-null instead, the cost probe of
    make_fused_step(null_body=True): the same launch and per-env staging
    with no step, counted in ``fused_step.null_launches``."""
    n = carry.shape[1]
    _check(carry, "carry", (E.CARRY_WORDS, n))
    _check(srng, "srng", (n,))
    _check(map_ids, "map_ids", (n, E.GRIDSIZE * E.GRIDSIZE))
    _check(min_xy, "min_xy", (n, 2))
    _check(n_players, "n_players", (n,))
    _check(max_steps, "max_steps", (n,))
    if mask_src not in _MASK_SRC:
        raise ValueError(f"mask_src must be 'storage' or 'sel', not {mask_src}")
    args = [carry, srng, map_ids, min_xy, n_players, max_steps]
    if dead is not None:
        _check(dead, "dead", (1,), torch.int64)
        args.append(dead)
    if record not in _RECORD_SEL:
        raise ValueError(f"record must be None, 'compact' or 'full', "
                         f"not {record!r}")
    if record is not None:
        if null_body:
            raise ValueError("K1-null writes no records")
        if records is None:
            raise ValueError(f"record={record!r} needs a records tensor")
        _check(records, "records", (n_steps, n, _RECORD_SEL[record]))
        args.append(records)
    dev = _device_of(args)
    if dev.type == "cpu":
        return fused_step_plain(carry, srng, map_ids, min_xy, n_players,
                                max_steps, n_steps, mask_src, gate_dead, dead,
                                null_body, record, records)
    lib = build.load()
    out = torch.empty_like(carry)
    srng_out = torch.empty_like(srng)
    act = torch.zeros((n, 5), dtype=_i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ed_fused_step(
        carry.data_ptr(), out.data_ptr(), srng.data_ptr(),
        srng_out.data_ptr(), map_ids.data_ptr(), min_xy.data_ptr(),
        n_players.data_ptr(), max_steps.data_ptr(), act.data_ptr(),
        dead.data_ptr() if dead is not None else None,
        records.data_ptr() if record is not None else None,
        n, int(n_steps), _MASK_SRC[mask_src], int(gate_dead),
        int(null_body), _RECORD_SEL[record], stream)
    build.check(err, "fused_step")
    if null_body:
        fused_step.null_launches += 1
    else:
        fused_step.launches += 1
        if record is not None:
            fused_step.record_launches[record] += 1
    return out, srng_out, act


fused_step.launches = 0
fused_step.null_launches = 0
fused_step.record_launches = {"compact": 0, "full": 0}


def fused_step_shape(n: int) -> dict:
    """K1's launch on the card at ``n`` envs: threads per block, blocks,
    shared-memory bytes per block, and blocks resident per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Launches nothing;
    needs the CUDA build."""
    out = (ctypes.c_int * 3)()
    build.check(build.load().ed_fused_step_occupancy(out), "fused_step_shape")
    threads, smem, per_sm = out
    return {"threads": threads, "blocks": -(-n // threads),
            "smem_bytes": smem, "blocks_per_sm": per_sm}


# ------------------------------------------------------------------- K2
def fused_reset_plain(carry, n_players, player_xy, req, nr, end):
    """Plain version of K2: `engine.reset_body` on every carry column."""
    dyn = E.vreset_body(E.unpack_dyn(carry), n_players, player_xy,
                        req, nr, end)
    return E.pack_dyn(dyn)


def fused_reset(carry, n_players, player_xy, req, nr, end):
    """K2: the reset body after map generation (csrc/reset_kernel.cu) for
    the q envs of ``carry`` (W, q): ``n_players`` (q,), the add_players
    positions ``player_xy`` (q, 4, 2) and the pregathered ball rows
    ``req``/``nr``/``end`` (q, 4, 19), all int32. Returns the new carry."""
    q = carry.shape[1]
    _check(carry, "carry", (E.CARRY_WORDS, q))
    _check(n_players, "n_players", (q,))
    _check(player_xy, "player_xy", (q, 4, 2))
    for name, t in (("req", req), ("nr", nr), ("end", end)):
        _check(t, name, (q, 4, E.N_BALL))
    dev = _device_of([carry, n_players, player_xy, req, nr, end])
    if dev.type == "cpu":
        return fused_reset_plain(carry, n_players, player_xy, req, nr, end)
    lib = build.load()
    out = torch.empty_like(carry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ed_fused_reset(
        carry.data_ptr(), out.data_ptr(), n_players.data_ptr(),
        player_xy.data_ptr(), req.data_ptr(), nr.data_ptr(), end.data_ptr(),
        q, stream)
    build.check(err, "fused_reset")
    fused_reset.launches += 1
    return out


fused_reset.launches = 0
