"""The plain version of the K1 step kernel (ops.step_kernel.fused_step on
CPU tensors) against the JAX package's jitted XLA step, tolerance zero:
every field, the actions and the sampler rngs, at every step.

Shapes follow tests/test_step_kernel.py (8 envs from vec_reset(3, 8, 4, 1,
0, 100000), sampler_init(7, 8)).
"""
import collections
import functools

import jax
import numpy as np
import pytest
import torch

from eldorado_tpu.core import engine as JE
from eldorado_tpu.vec import _active_mask, sampler_init, vec_reset
from eldorado_tpu_torch import convert
from eldorado_tpu_torch.core import engine as TE
from eldorado_tpu_torch.ops import step_kernel as K

N = 8


@functools.partial(jax.jit, static_argnums=(2,))
def xla_step(s, r, mask_src="storage"):
    a, r, t = jax.vmap(JE.sample_action)(r, _active_mask(s, mask_src))
    s = jax.vmap(JE.step_env)(s, a)
    return s._replace(rng_tainted=s.rng_tainted | t), r, a


@jax.jit
def gated_step(s, r):
    return jax.vmap(lambda a, b: JE.fused_sample_step(
        a, b, JE.ball_words(a), "storage", True))(s, r)


def _start(done_every=0):
    js, jr = vec_reset(3, N, 4, 1, 0, 100000), sampler_init(7, N)
    if done_every:
        done = np.zeros(N, bool)
        done[::done_every] = True
        js = js._replace(done=jax.numpy.asarray(done))
    return js, jr


def _compare(ts, js, tr, jr, ta, ja, t):
    assert np.array_equal(ta.numpy(), np.asarray(ja)), f"actions t={t}"
    assert np.array_equal(tr.numpy(), np.asarray(jr)), f"srng t={t}"
    dyn = dict(zip(TE.DYN_FIELDS, TE.unpack_dyn(ts)))
    for f, x in dyn.items():
        assert np.array_equal(x.numpy(), np.asarray(getattr(js, f))), \
            f"t={t}: {f}"


def _run(js, jr, jax_step, mask_src, gate_dead, steps=10):
    s = convert.state_from_numpy(js, device="cpu")
    carry = TE.pack_dyn(TE.split_state(s)[1])
    tr = convert.rngs_from_numpy(jr, device="cpu")
    dead = torch.zeros(1, dtype=torch.int64)
    want_dead = 0
    for t in range(steps):
        want_dead += int(np.asarray(js.done).sum())
        carry, tr, ta = K.fused_step(carry, tr, s.map_ids, s.min_xy,
                                     s.n_players, s.max_steps, 1, mask_src,
                                     gate_dead, dead)
        js, jr, ja = jax_step(js, jr)
        _compare(carry, js, tr, jr, ta, ja, t)
    assert int(dead) == want_dead
    return want_dead


@pytest.mark.parametrize("mask_src", ["storage", "sel"])
def test_plain_step_equals_xla(mask_src):
    js, jr = _start()
    _run(js, jr, lambda s, r: xla_step(s, r, mask_src), mask_src, False)


def test_plain_step_gate_dead_equals_jax():
    """gate_dead=True: done envs draw nothing and stay frozen."""
    js, jr = _start(done_every=3)
    assert _run(js, jr, gated_step, "storage", True) > 0


def test_plain_step_dead_steps_advance_sampler():
    """Without gate_dead a done env's sampler still draws, its state is
    unchanged, and the dead-step counter counts it at every step."""
    js, jr = _start(done_every=2)
    assert _run(js, jr, xla_step, "storage", False) == 10 * (N // 2)


def test_plain_step_natural_win_equals_xla():
    """A window in which a game ends by a player reaching El Dorado, not
    by the turn limit: the win branch (has_won, n_winners and rewards =
    n_players * has_won - n_winners) against the XLA step. JAX alone
    plays 2-player, 1-piece games up to the first win (about 5k steps);
    the port replays the last steps before it and two after."""
    js, jr = vec_reset(3, N, 2, 1, 0, 100000), sampler_init(7, N)
    window = collections.deque(maxlen=8)
    for _ in range(20000):
        window.append((js, jr))
        js, jr, _ = xla_step(js, jr)
        won = np.asarray(js.done) & np.asarray(js.has_won).any(axis=1)
        if won.any():
            break
    else:
        pytest.fail("no game ended by a win in 20000 steps")
    assert not np.asarray(window[0][0].done).any()
    assert np.asarray(js.rewards)[won].any()
    _run(*window[0], xla_step, "storage", False, steps=len(window) + 2)


def test_multi_step_launch_equals_single_steps():
    """One n_steps=10 call equals ten n_steps=1 calls (the chunk loop)."""
    js, jr = _start(done_every=4)
    s = convert.state_from_numpy(js, device="cpu")
    c0 = TE.pack_dyn(TE.split_state(s)[1])
    r0 = convert.rngs_from_numpy(jr, device="cpu")
    st = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    d1, d2 = torch.zeros(1, dtype=torch.int64), torch.zeros(1,
                                                          dtype=torch.int64)
    c1, r1, a1 = K.fused_step(c0, r0, *st, 10, "storage", False, d1)
    c2, r2 = c0, r0
    for _ in range(10):
        c2, r2, a2 = K.fused_step(c2, r2, *st, 1, "storage", False, d2)
    assert torch.equal(c1, c2) and torch.equal(r1, r2)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)


def test_carry_roundtrip():
    s = convert.state_from_numpy(_start()[0], device="cpu")
    dyn = TE.split_state(s)[1]
    carry = TE.pack_dyn(dyn)
    assert carry.shape == (TE.CARRY_WORDS, N) and carry.dtype == torch.int32
    for a, b in zip(dyn, TE.unpack_dyn(carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)
