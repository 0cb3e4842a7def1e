"""The kernels of the rollout: K1 `fused_step`, K2 `fused_reset`, and the
learner's step and sampler, K1-act `step_actions` and K1-sample `sample`.

Port of ``eldorado_tpu/ops/step_kernel.py`` (``make_fused_step`` and
``make_fused_reset``, the Pallas programs of the TPU build) and of the
vmapped ``step_env`` / ``sample_action`` of ``eldorado_tpu/vec.py``
(``vec_step``, ``vec_sample``), which the TPU build left to XLA. The step
kernels operate on the field-major, env-minor carry of `engine.pack_dyn`
((W, n) int32); `sample_carry` reads its masks from that carry too.

Each wrapper dispatches on the device of its tensors: CPU tensors take the
plain torch version (`fused_step_plain`, `fused_reset_plain`,
`step_actions_plain`, `sample_plain`, i.e. the vmapped single-env engine);
CUDA tensors launch the hand-written kernel of ``csrc/`` or raise. There is
no fallback between the two. A launch goes to its tensors' device, made
current for the call, on that device's current stream, so a caller on any
card needs no device guard of its own. Each wrapper counts its kernel launches in a
plain int attribute, ``launches`` (and ``fused_step.null_launches`` for
K1-null, K1's cost probe; ``fused_step.record_launches[record]`` for the
launches that also wrote per-step records, which ``launches`` counts too;
``sample.carry_launches`` for K1-sample's launches from the carry).
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
_OFF = {f: off for f, _, _, off, _ in E.DYN_LAYOUT}
# The trajectory record (csrc/engine.cuh kRecordTraj): rollout's per-step
# fields exactly. Word 0 as the compact record's (actions, done, agent,
# phase), words 1-4 the rewards and 5-7 the resources as f32 bits, 8-10 the
# sel mask words: the carry's own words at these rows.
TRAJ_WORDS = 11
TRAJ_ROWS = (tuple(range(_OFF["rewards"], _OFF["rewards"] + 4))
             + tuple(range(_OFF["resources"], _OFF["resources"] + 3))
             + tuple(range(_OFF["sel_mask"], _OFF["sel_mask"] + 3)))
# record name -> words per env per step
RECORD_WORDS = {**S.RECORD_WIDTH, "traj": TRAJ_WORDS}
_RECORD_SEL = {None: 0, **RECORD_WORDS}


def pack_traj(act, done, rewards, agent, sel, resources, phase):
    """rollout's per-step fields, env-major -> (n, TRAJ_WORDS) int32."""
    w0 = (done.to(_i32) << 25) | (agent << 26) | (phase << 28)
    for i in range(5):
        w0 = w0 | (act[:, i] << (5 * i))
    return torch.cat([w0[:, None], rewards.contiguous().view(_i32),
                      resources.contiguous().view(_i32), sel], 1)


def unpack_traj(recs):
    """(..., TRAJ_WORDS) int32 records -> (actions (..., 5) i32, done bool,
    rewards (..., 4) f32, agent i32, sel_mask (..., 3) i32, resources
    (..., 3) f32, phase i32): the JAX package's rollout outputs."""
    w0 = recs[..., 0]
    acts = torch.stack([(w0 >> (5 * h)) & 31 for h in range(5)], -1)
    return (acts, ((w0 >> 25) & 1) != 0,
            recs[..., 1:5].contiguous().view(torch.float32), (w0 >> 26) & 3,
            recs[..., 8:11].contiguous(),
            recs[..., 5:8].contiguous().view(torch.float32), (w0 >> 28) & 3)


def _pack_records(dyn, act, p_pre, record):
    """The plain version of what K1 writes per step: the post-step
    records of ``dyn`` (env-major DYN fields), (n, W)."""
    def f(name):
        return dyn[_I[name]]
    if record == "traj":
        return pack_traj(act, f("done"), f("rewards"), f("agent"),
                         f("sel_mask"), f("resources"), f("phase"))
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
    (n_steps, n, `RECORD_WORDS[record]`) int32 tensor (the layout of
    stream.py's module docstring); ``record="traj"`` writes rollout's
    per-step fields (`pack_traj`) the same way.

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
        raise ValueError(f"record must be None, 'compact', 'full' or "
                         f"'traj', not {record!r}")
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
    with torch.cuda.device(dev):
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
fused_step.record_launches = dict.fromkeys(RECORD_WORDS, 0)


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


# ---------------------------------------------------- K1-act, K1-sample
# the five heads' widths (engine._HEAD_DEFS): an action lies in [0, width)
HEAD_WIDTHS = tuple(w for _, w in E._HEAD_DEFS)


def step_actions_plain(carry, actions, map_ids, min_xy, n_players,
                       max_steps):
    """Plain version of K1-act: `engine.vstep_actions` on the carry; an env
    whose actions do not all lie in their heads is left as it was.
    Returns (carry', counts): counts (2,) int32 holds the number of such
    envs and the number of envs done after the step."""
    widths = torch.tensor(HEAD_WIDTHS, dtype=_i32, device=actions.device)
    bad = ((actions < 0) | (actions >= widths)).any(1)
    dyn = E.unpack_dyn(carry)
    new = E.vstep_actions(dyn, torch.where(bad[:, None], 0, actions),
                          map_ids, min_xy, n_players, max_steps)
    out = E.pack_dyn(new)
    out = torch.where(bad, carry, out)
    done = out[_OFF["done"]] != 0
    return out, torch.stack([bad.sum(), done.sum()]).to(_i32)


# K1-act's block (csrc/engine.cuh kActEnvs, kActWarps, kActUnits): envs
# and warps a block, 16-byte units a staging thread loads in its pass
ACT_ENVS, ACT_WARPS, ACT_UNITS = 16, 8, 9
# K2's block into a new carry (csrc/engine.cuh kResetEnvs, kResetUnits):
# envs a block, a warp each; words each thread writes out a pass. In place
# K2 runs a warp a block.
RESET_ENVS, RESET_UNITS = 16, 6


def step_actions(carry, actions, map_ids, min_xy, n_players, max_steps):
    """K1-act: one step of every env of ``carry`` ((W, n) int32) with the
    given ``actions`` ((n, 5) int32), done envs dead-stepping
    (csrc/step_actions.cu); the map and parameters as for `fused_step`.
    Returns (new carry, number of envs done after the step), read from the
    device in one copy with the check of the actions. Raises ValueError,
    and returns no step, when an action lies outside its head
    (`HEAD_WIDTHS`): the JAX package steps such actions into states the
    game cannot reach. In-range actions the mask forbids are stepped as
    the JAX package steps them. On the card ``step_actions.last_path``
    says how the last launch staged the carry: "16-byte" or "word"."""
    n = carry.shape[1]
    _check(carry, "carry", (E.CARRY_WORDS, n))
    _check(actions, "actions", (n, 5))
    _check(map_ids, "map_ids", (n, E.GRIDSIZE * E.GRIDSIZE))
    _check(min_xy, "min_xy", (n, 2))
    _check(n_players, "n_players", (n,))
    _check(max_steps, "max_steps", (n,))
    dev = _device_of([carry, actions, map_ids, min_xy, n_players, max_steps])
    if dev.type == "cpu":
        out, counts = step_actions_plain(carry, actions, map_ids, min_xy,
                                         n_players, max_steps)
        bad, n_done = counts.tolist()
    else:
        out = torch.empty_like(carry)
        counts = torch.zeros(3, dtype=_i32, device=dev)
        launch_step_actions(carry, actions, map_ids, min_xy, n_players,
                            max_steps, out, counts)
        bad, n_done, vec = counts.tolist()
        step_actions.last_path = ("word", "16-byte")[vec]
    if bad:
        raise ValueError(f"{bad} envs have an action outside its head's "
                         f"width {HEAD_WIDTHS} (or below 0)")
    return out, n_done


step_actions.launches = 0
step_actions.last_path = None


def launch_step_actions(carry, actions, map_ids, min_xy, n_players,
                        max_steps, out, counts):
    """K1-act's launch alone, on CUDA tensors that `step_actions` has
    checked: the new carry into ``out``, the two counts added to
    ``counts[:2]`` and the staging path written to ``counts[2]`` ((3,)
    int32), nothing read back (so that a CUDA graph can hold it, to time
    it)."""
    with torch.cuda.device(carry.device):
        err = build.load().ed_step_actions(
            carry.data_ptr(), out.data_ptr(), actions.data_ptr(),
            map_ids.data_ptr(), min_xy.data_ptr(), n_players.data_ptr(),
            max_steps.data_ptr(), counts.data_ptr(), carry.shape[1],
            torch.cuda.current_stream(carry.device).cuda_stream)
    build.check(err, "step_actions")
    step_actions.launches += 1


def mask_words(carry, mask_src: str):
    """Each env's active mask as (n, 3) int32 words, read from the carry:
    its agent's storage row, or its sel mask (torch ops, on either
    device: the plain route of `sample_carry`, and `vec_sample`'s feed)."""
    if mask_src == "sel":
        words = carry[_OFF["sel_mask"]:_OFF["sel_mask"] + E.MASK_WORDS]
    else:
        rows = (_OFF["storage_masks"] + E.MASK_WORDS * carry[_OFF["agent"]]
                + torch.arange(E.MASK_WORDS, device=carry.device)[:, None])
        words = torch.gather(carry, 0, rows.long())
    return words.t().contiguous()


def sample_plain(srng, mask_words, live=None):
    """Plain version of K1-sample: `engine.vsample`."""
    return E.vsample(srng, mask_words, live)


def sample(srng, mask_words, live=None):
    """K1-sample: the masked-uniform sampler of every env
    (csrc/sample.cu): ``srng`` (n,) int32 engines, ``mask_words`` (n, 3)
    int32 packed masks (`engine.pack_mask`), ``live`` an optional (n,) bool
    (an env with False draws nothing). Returns (actions (n, 5) int32,
    srng', tainted (n,) bool)."""
    n = srng.shape[0]
    _check(srng, "srng", (n,))
    _check(mask_words, "mask_words", (n, E.MASK_WORDS))
    args = [srng, mask_words]
    if live is not None:
        _check(live, "live", (n,), torch.bool)
        args.append(live)
    dev = _device_of(args)
    if dev.type == "cpu":
        return sample_plain(srng, mask_words, live)
    lib = build.load()
    srng_out = torch.empty_like(srng)
    act = torch.empty((n, 5), dtype=_i32, device=dev)
    tainted = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.ed_sample(srng.data_ptr(), srng_out.data_ptr(),
                            mask_words.data_ptr(),
                            None if live is None else live.data_ptr(),
                            act.data_ptr(), tainted.data_ptr(), n,
                            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sample")
    sample.launches += 1
    return act, srng_out, tainted


sample.launches = 0
sample.carry_launches = 0


def sample_carry_plain(srng, carry, mask_src: str = "storage", live=None):
    """Plain version of `sample_carry`: `mask_words`, `sample_plain`, then
    the tainted flags ORed into ``carry``'s rng_tainted row in place."""
    act, srng, tainted = sample_plain(srng, mask_words(carry, mask_src),
                                      live)
    carry[_OFF["rng_tainted"]] |= tainted.to(_i32)
    return act, srng


def sample_carry(srng, carry, mask_src: str = "storage", live=None):
    """K1-sample on each env's active mask read from ``carry`` ((W, n)
    int32): its agent's storage row, or (``mask_src="sel"``) its sel mask;
    the tainted flags OR into the carry's rng_tainted row in place (the
    JAX package's VecEnv.sample, eldorado_tpu/vec.py:877-882). One launch
    (csrc/sample.cu, ``ed_sample_carry``), counted in ``sample.launches``
    and ``sample.carry_launches``. Returns (actions (n, 5) int32, srng')."""
    n = srng.shape[0]
    _check(srng, "srng", (n,))
    _check(carry, "carry", (E.CARRY_WORDS, n))
    if mask_src not in _MASK_SRC:
        raise ValueError(f"mask_src must be 'storage' or 'sel', not {mask_src}")
    args = [srng, carry]
    if live is not None:
        _check(live, "live", (n,), torch.bool)
        args.append(live)
    dev = _device_of(args)
    if dev.type == "cpu":
        return sample_carry_plain(srng, carry, mask_src, live)
    srng_out = torch.empty_like(srng)
    act = torch.empty((n, 5), dtype=_i32, device=dev)
    with torch.cuda.device(dev):
        err = build.load().ed_sample_carry(
            srng.data_ptr(), srng_out.data_ptr(), carry.data_ptr(),
            None if live is None else live.data_ptr(), act.data_ptr(), n,
            _MASK_SRC[mask_src], torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sample_carry")
    sample.launches += 1
    sample.carry_launches += 1
    return act, srng_out


def launch_empty(n: int, device, threads: int = 32) -> None:
    """An empty kernel of ``n`` threads in blocks of ``threads`` (csrc/
    sample.cu ``ed_empty``): a launch floor. K1-sample's grid for ``n``
    envs is the default; K2's for q envs in place is ``launch_empty(32 *
    q, device)``, into a new carry ``launch_empty(32 * q, device, 32 *
    RESET_ENVS)``."""
    with torch.cuda.device(device):
        build.check(build.load().ed_empty(
            n, threads, torch.cuda.current_stream(device).cuda_stream),
            "empty")


# ------------------------------------------------------------------- K2
def fused_reset_plain(carry, n_players, player_xy, req, nr, end, idx=None):
    """Plain version of K2: `engine.reset_body` on every carry column; with
    ``idx``, on the gathered columns ``idx``, scattered back in place."""
    if idx is not None:
        cols = idx.long()
        carry[:, cols] = fused_reset_plain(carry[:, cols], n_players[cols],
                                           player_xy, req, nr, end)
        return carry
    dyn = E.vreset_body(E.unpack_dyn(carry), n_players, player_xy,
                        req, nr, end)
    return E.pack_dyn(dyn)


def fused_reset(carry, n_players, player_xy, req, nr, end, idx=None):
    """K2: the reset body after map generation (csrc/reset_kernel.cu, a
    warp per env) for q envs: the add_players
    positions ``player_xy`` (q, 4, 2) and the pregathered ball rows
    ``req``/``nr``/``end`` (q, 4, 19), all int32.

    Without ``idx``, ``carry`` (W, q) and ``n_players`` (q,) are the q
    envs', and a new carry is returned. With ``idx`` ((q,) int32, unique
    columns), ``carry`` (W, n) and ``n_players`` (n,) are the whole
    batch's: the columns ``idx`` are reset in place, and ``carry`` is
    returned."""
    q = player_xy.shape[0]
    n = q if idx is None else carry.shape[1]
    _check(carry, "carry", (E.CARRY_WORDS, n))
    _check(n_players, "n_players", (n,))
    _check(player_xy, "player_xy", (q, 4, 2))
    for name, t in (("req", req), ("nr", nr), ("end", end)):
        _check(t, name, (q, 4, E.N_BALL))
    args = [carry, n_players, player_xy, req, nr, end]
    if idx is not None:
        _check(idx, "idx", (q,))
        args.append(idx)
    dev = _device_of(args)
    if dev.type == "cpu":
        return fused_reset_plain(carry, n_players, player_xy, req, nr, end,
                                 idx)
    lib = build.load()
    out = torch.empty_like(carry) if idx is None else carry
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ed_fused_reset(
            carry.data_ptr(), out.data_ptr(),
            None if idx is None else idx.data_ptr(), n_players.data_ptr(),
            player_xy.data_ptr(), req.data_ptr(), nr.data_ptr(),
            end.data_ptr(), n, q, stream)
    build.check(err, "fused_reset")
    fused_reset.launches += 1
    return out


fused_reset.launches = 0
