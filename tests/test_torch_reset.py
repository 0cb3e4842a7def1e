"""The port's reset path — vec_reset (mapgen, the map prelude and the plain
version of the K2 reset kernel) — against the JAX package, tolerance zero.
"""
import jax
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu import vec as JV
from eldorado_tpu.core import engine as JE
from eldorado_tpu_torch import convert
from eldorado_tpu_torch.core import engine as TE
from eldorado_tpu_torch.ops import step_kernel as K


def assert_states_equal(ours, theirs):
    want = {f: np.asarray(getattr(theirs, f)) for f in JE.EnvState._fields}
    got = convert.state_to_numpy(ours)
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize("n_players", [2, 4])
@pytest.mark.parametrize("difficulty", [0, 2])
def test_vec_reset_equals_jax(n_players, difficulty):
    assert_states_equal(et.vec_reset(5, 8, n_players, 3, difficulty, 100000,
                                     device="cpu"),
                        JV.vec_reset(5, 8, n_players, 3, difficulty, 100000))


def test_vec_reset_varied_equals_jax():
    seeds = [3, 99, 12345, 7, 2 ** 32 - 1, 0]
    args = ([2, 4, 3, 4, 1, 2], [1, 3, 2, 3, 1, 2], [0, 2, 1, 0, 0, 1], 50)
    assert_states_equal(et.vec_reset_varied(seeds, *args, device="cpu"),
                        JV.vec_reset_varied(np.asarray(seeds, np.uint32),
                                            *args))


def test_reset_body_equals_jax():
    """The plain K2 version on mid-game states (80 plain steps after a
    reset) equals jax.vmap(engine.reset_body) on the same prelude."""
    s = et.vec_reset(21, 8, 4, 2, 1, 100000, device="cpu")
    carry = TE.pack_dyn(TE.split_state(s)[1])
    carry, _, _ = K.fused_step(carry, et.sampler_init(3, 8, device="cpu"),
                               s.map_ids, s.min_xy, s.n_players, s.max_steps,
                               80)
    mid = TE.merge_state(TE.split_state(s)[0], TE.unpack_dyn(carry))
    js = JE.EnvState(**{f: jax.numpy.asarray(v) for f, v in
                        convert.state_to_numpy(mid).items()})

    gen, pxy, ball = TE.reset_map_prelude(mid.rng, mid.n_pieces,
                                          mid.difficulty, mid.n_players)
    jgen, jxy, jball = jax.vmap(JE.reset_map_prelude)(
        js.rng, js.n_pieces, js.difficulty, js.n_players)
    assert np.array_equal(pxy.numpy(), np.asarray(jxy))
    for a, b in zip(ball, jball):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(gen.ids.numpy(), np.asarray(jgen.ids))

    got = TE.merge_state(TE.split_state(mid)[0], TE.unpack_dyn(
        K.fused_reset_plain(carry, mid.n_players, pxy, *ball)))
    want = jax.jit(jax.vmap(JE.reset_body))(js, jxy, jball)
    assert_states_equal(got, want)


def test_generate_map_failure_raises():
    # only 3 EASY travel pieces exist
    with pytest.raises(et.GenerateMapFailure):
        et.vec_reset(1, 4, 2, 4, 0, 100, device="cpu")
    states = et.vec_reset(1, 4, 2, 4, 0, 100, check_maps=False, device="cpu")
    assert not bool(states.map_ok.all())
    assert isinstance(states.map_ok, torch.Tensor)
