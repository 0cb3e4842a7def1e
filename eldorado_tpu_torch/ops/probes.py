"""K1's cost probes: P1 `null_copy`, P2 `op_chain`, P3 `step_prefix`.

Ports of the TPU probes in ``tools/`` (``tpu_null_kernel.py``,
``tpu_op_cost.py``, ``tpu_prefix_profile.py``), which split K1's time on
the chip into I/O, per-op cost and regions of the step. The kernels are
``csrc/probes.cu``; K1-null is ``step_kernel.fused_step(null_body=True)``.
The timing entry points are ``eldorado_tpu_torch.tools``.

Like the other wrappers, each takes the plain torch version beside it for
CPU tensors and launches its kernel for CUDA tensors or raises, and counts
its launches in a ``launches`` attribute.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from ..core import engine as E
from . import build
from .step_kernel import _check, _device_of, fused_step_plain

_i32 = torch.int32
OPS = ("add", "sel")
OP_CHAIN_K = (2, 6, 64, 4096)   # the k values csrc/probes.cu instantiates
CUTS = (0, 1, 2, 3)
CUT_NAMES = ("load", "sample", "ball", "step")


# ------------------------------------------------------------------- P1
def null_copy_plain(carry):
    """Plain version of P1: a copy of the carry."""
    return carry.clone()


def null_copy(carry):
    """P1: every word of the (W, n) int32 carry read and written once
    (the I/O floor of K1's state). The result equals ``carry``."""
    if carry.dim() != 2:
        raise ValueError(f"carry must be (W, n), got {tuple(carry.shape)}")
    _check(carry, "carry", carry.shape)
    if _device_of([carry]).type == "cpu":
        return null_copy_plain(carry)
    lib = build.load()
    out = torch.empty_like(carry)
    stream = torch.cuda.current_stream(carry.device).cuda_stream
    err = lib.ed_null_copy(carry.data_ptr(), out.data_ptr(), carry.shape[0],
                           carry.shape[1], stream)
    build.check(err, "null_copy")
    null_copy.launches += 1
    return out


null_copy.launches = 0


# ------------------------------------------------------------------- P2
def op_chain_plain(x, y, k: int, op: str = "add"):
    """Plain version of P2, the body of tools/tpu_op_cost.py::build: k // 2
    rounds of ``v += w; w ^= v`` (op "add") or ``v = (v & 3) > 1 ? v + w :
    v - w; w ^= v >> 1`` (op "sel") from v = x, w = y; returns v + w.
    int32 wraps and ``>>`` is arithmetic, as in JAX."""
    v, w = x, y
    for _ in range(k // 2):
        if op == "add":
            v = v + w
            w = w ^ v
        else:
            v = torch.where((v & 3) > 1, v + w, v - w)
            w = w ^ (v >> 1)
    return v + w


def op_chain(x, y, k: int, op: str = "add"):
    """P2: ``k`` dependent int32 ops per element of ``x``/``y`` (same
    shape, any shape), one CUDA thread per element. On the card ``k`` is
    one of `OP_CHAIN_K`."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, not {op!r}")
    _check(x, "x", x.shape)
    _check(y, "y", x.shape)
    if _device_of([x, y]).type == "cpu":
        return op_chain_plain(x, y, k, op)
    if k not in OP_CHAIN_K:
        raise ValueError(f"the op-chain kernel is built for k in "
                         f"{OP_CHAIN_K}, not {k}")
    lib = build.load()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ed_op_chain(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                          x.numel(), k, OPS.index(op), stream)
    build.check(err, "op_chain")
    op_chain.launches += 1
    return out


op_chain.launches = 0


# ------------------------------------------------------------------- P3
def _wrap_i32(x):
    """int64 sums -> the int32 of their wrapping uint32 value."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(_i32)


def _agent(carry):
    """Each env's done flag, and its agent's storage mask (n, 3) and
    position (n, 2)."""
    d = dict(zip(E.DYN_FIELDS, E.unpack_dyn(carry)))
    e, a = torch.arange(carry.shape[1], device=carry.device), d["agent"]
    return d["done"], d["storage_masks"][e, a], d["player_xy"][e, a]


def step_prefix_plain(carry, srng, map_ids, min_xy, n_players, max_steps,
                      n_steps: int, cut: int):
    """Plain version of P3, and the definition of its checksum.

    K1 (storage mask, no gate_dead) cut after stage ``cut`` of
    `engine.fused_sample_step`. Per env, with state S (its carry column)
    and sampler engine r, ``n_steps`` rounds of:

    - cut >= 1: sample the five heads from the storage mask of S's agent
      (`engine._sample_action_w`, advancing r) and add them;
    - cut >= 2: if S is not done, add the 19 cell ids of the agent's ball
      (`engine._ball_ids_xy` at the agent's position);
    - cut == 3: S and r take the whole step (`fused_step_plain`, whose
      sample is the same five heads).

    Then add the 570 words of S and r. Below cut 3 S does not change; r
    does from cut 1 on. Every sum wraps mod 2^32; the result is that
    uint32 as int32, one per env, (n,)."""
    acc = torch.zeros(carry.shape[1], dtype=torch.int64, device=carry.device)
    for _ in range(n_steps if cut >= 1 else 0):
        done, storage, xy = _agent(carry)
        if cut >= 2:
            ids = vmap(E._ball_ids_xy)(map_ids, min_xy, xy[:, None])
            acc += torch.where(done, 0, ids.sum((1, 2)))
        if cut == 3:
            carry, srng, act = fused_step_plain(carry, srng, map_ids, min_xy,
                                                n_players, max_steps, 1)
        else:
            act, srng, _ = vmap(E._sample_action_w)(srng, storage)
        acc += act.sum(1)
    acc += carry.sum(0, dtype=torch.int64) + srng.to(torch.int64)
    return _wrap_i32(acc)


def step_prefix(carry, srng, map_ids, min_xy, n_players, max_steps,
                n_steps: int, cut: int):
    """P3: ``n_steps`` rounds of K1 cut after stage ``cut`` (0 load,
    1 sample, 2 ball read, 3 the whole step; `CUT_NAMES`) in one launch,
    and the (n,) int32 checksum of `step_prefix_plain`. Arguments as
    `step_kernel.fused_step`."""
    if cut not in CUTS:
        raise ValueError(f"cut must be one of {CUTS}, not {cut}")
    n = carry.shape[1]
    _check(carry, "carry", (E.CARRY_WORDS, n))
    _check(srng, "srng", (n,))
    _check(map_ids, "map_ids", (n, E.GRIDSIZE * E.GRIDSIZE))
    _check(min_xy, "min_xy", (n, 2))
    _check(n_players, "n_players", (n,))
    _check(max_steps, "max_steps", (n,))
    args = [carry, srng, map_ids, min_xy, n_players, max_steps]
    dev = _device_of(args)
    if dev.type == "cpu":
        return step_prefix_plain(*args, n_steps, cut)
    lib = build.load()
    out = torch.empty_like(srng)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ed_step_prefix(*(t.data_ptr() for t in args), out.data_ptr(),
                             n, int(n_steps), cut, stream)
    build.check(err, "step_prefix")
    step_prefix.launches += 1
    return out


step_prefix.launches = 0
