"""Bit-exact libstdc++ RNG streams in plain torch integer ops.

Port of ``eldorado_tpu/ops/rng.py``. The reference consumes
``std::default_random_engine`` (libstdc++ ``minstd_rand0``: x' = 16807*x
mod 2^31-1) through ``std::uniform_int_distribution<size_t>`` ("downscaling"
rejection) for every random decision (src/environment.cpp:18-22,
src/cards.cpp:190, src/player.cpp:92,115, include/sampler.h:25). Engine
states are int32 tensors of any shape; every function is elementwise.

torch's ``>>`` on int32 is arithmetic and int32 overflow is not a defined
operation to rely on, so the 46-bit product and the mod-2^32 wrap are
computed in int64, where every value is non-negative and a right shift is
the logical shift of the uint32 original. The same arithmetic, on
``uint32_t``, is ``csrc/rng.cuh`` for the CUDA kernels.

* ``uniform_int`` runs the rejection loop exactly (mapgen);
* ``uniform_int_fast`` is the two-attempt, loop-free form the step and the
  reset body use, and reports the double-rejection deviation (``tainted``).
"""
from __future__ import annotations

import torch

from ..devices import resolve

M = 2147483647  # 2^31 - 1, minstd modulus
A = 16807
URNG_RANGE = 2147483645  # engine max-min = (M-1) - 1

_i32 = torch.int32
_i64 = torch.int64


def seed(s, device="cuda"):
    """libstdc++ linear_congruential_engine::seed: x = s % M, 0 -> 1.
    Accepts uint32 values (as Python ints or any integer tensor; an int32
    bit pattern is read as uint32). Returns int32 on ``device``."""
    s = torch.as_tensor(s, device=resolve(device)).to(_i64) & 0xFFFFFFFF
    s = s % M
    return torch.where(s == 0, torch.ones_like(s), s).to(_i32)


def next_u31(x):
    """One minstd_rand0 step: x' = 16807*x mod (2^31-1)."""
    x = x.to(_i64)
    lo = A * (x & 0xFFFF)
    hi = A * (x >> 16)
    y = (lo + ((hi & 0x7FFF) << 16) + (hi >> 15)) & 0xFFFFFFFF
    y = (y & 0x7FFFFFFF) + (y >> 31)
    return torch.where(y >= M, y - M, y).to(_i32)


def _scaling(uerange):
    uerange = uerange.to(_i64)
    scaling = URNG_RANGE // uerange
    return scaling, uerange * scaling


def uniform_int(x, uerange):
    """Exact libstdc++ uniform_int_distribution(0, uerange-1)(engine),
    elementwise: every lane redraws until it accepts (the loop runs on the
    host while any lane rejects; rejections are rarer than 1 in 10^8).
    Returns (value, new_state), both int32."""
    uerange = torch.as_tensor(uerange, device=x.device)
    scaling, past = _scaling(uerange)
    x = next_u31(x)
    r = x.to(_i64) - 1
    rej = r >= past
    while bool(rej.any()):
        x = torch.where(rej, next_u31(x), x)
        r = torch.where(rej, x.to(_i64) - 1, r)
        rej = r >= past
    return (r // scaling).to(_i32), x


def uniform_int_maybe(x, uerange, do_draw):
    """uniform_int that leaves the stream untouched where ``do_draw`` is
    False (the value is then 0)."""
    uerange = torch.as_tensor(uerange, device=x.device)
    v, x_new = uniform_int(x, torch.clamp(uerange, min=1))
    return (torch.where(do_draw, v, torch.zeros_like(v)),
            torch.where(do_draw, x_new, x))


def uniform_int_fast(x, uerange):
    """Loop-free uniform_int: two unrolled rejection attempts. Returns
    (value, new_state, tainted); ``tainted`` flags the double rejection,
    where the value deviates from the exact stream."""
    uerange = torch.as_tensor(uerange, device=x.device)
    scaling, past = _scaling(uerange)
    x1 = next_u31(x)
    r1 = x1.to(_i64) - 1
    ok1 = r1 < past
    x2 = next_u31(x1)
    r2 = x2.to(_i64) - 1
    v = (torch.where(ok1, r1, r2) // scaling).to(_i32)
    return v, torch.where(ok1, x1, x2), (~ok1) & (r2 >= past)


def uniform_int_fast_maybe(x, uerange, do_draw):
    """uniform_int_fast that leaves the stream untouched when not drawing."""
    uerange = torch.as_tensor(uerange, device=x.device)
    v, x_new, tainted = uniform_int_fast(x, torch.clamp(uerange, min=1))
    return (torch.where(do_draw, v, torch.zeros_like(v)),
            torch.where(do_draw, x_new, x),
            do_draw & tainted)
