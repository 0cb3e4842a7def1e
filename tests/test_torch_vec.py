"""The slice as a whole: the port's rollout_chunked on CPU tensors (plain
versions of K1 and K2, plain mapgen) against the JAX package's
rollout_chunked, tolerance zero, including mid-run auto-resets."""
import numpy as np

import eldorado_tpu_torch as et
from eldorado_tpu import vec as JV
from eldorado_tpu.core import engine as JE
from eldorado_tpu_torch import convert
from eldorado_tpu_torch.ops import step_kernel as K


def assert_states_equal(ours, theirs):
    got = convert.state_to_numpy(ours)
    for f in JE.EnvState._fields:
        want = np.asarray(getattr(theirs, f))
        assert got[f].dtype == want.dtype, f
        assert np.array_equal(got[f], want), f


def test_rollout_chunked_equals_jax_xla():
    """n=8, max_steps=30, 200 steps, chunk 50 (the verify recipe): the
    queued sync resets equal the XLA path's bucketed resets."""
    k1, k2 = K.fused_step.launches, K.fused_reset.launches
    ours = et.rollout_chunked(et.vec_reset(5, 8, 4, 1, 0, 30, device="cpu"),
                              et.sampler_init(11, 8, device="cpu"), 200, 50)
    theirs = JV.rollout_chunked(JV.vec_reset(5, 8, 4, 1, 0, 30),
                                JV.sampler_init(11, 8), 200, 50,
                                backend="xla")
    assert_states_equal(ours[0], theirs[0])
    assert np.array_equal(convert.rngs_to_numpy(ours[1]),
                          np.asarray(theirs[1]))
    assert ours[2] == theirs[2] > 0
    # CPU tensors take the plain versions: no kernel launched
    assert (K.fused_step.launches, K.fused_reset.launches) == (k1, k2)


def test_rollout_chunked_exact_equals_jax_kernel():
    """exact=True at tests/test_exact_reset.py's settings (n=8,
    max_steps=20, chunk 10, 12 chunks) against the Pallas kernel path in
    interpret mode: fields, srngs, episodes and dead steps."""
    ours = et.rollout_chunked(et.vec_reset(5, 8, 4, 1, 0, 20, device="cpu"),
                              et.sampler_init(11, 8, device="cpu"), 120, 10,
                              exact=True)
    theirs = JV.rollout_chunked(JV.vec_reset(5, 8, 4, 1, 0, 20),
                                JV.sampler_init(11, 8), 120, 10,
                                backend="kernel", block=8, interpret=True,
                                exact=True)
    assert_states_equal(ours[0], theirs[0])
    assert np.array_equal(convert.rngs_to_numpy(ours[1]),
                          np.asarray(theirs[1]))
    assert ours[2:] == theirs[2:]
    assert ours[3] > 0 and ours[2] > 0


def test_convert_roundtrip():
    js = JV.vec_reset(2, 4, 3, 2, 1, 100)
    ours = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in JE.EnvState._fields},
        device="cpu")
    assert_states_equal(ours, js)
    assert_states_equal(convert.state_from_numpy(convert.state_to_numpy(
        ours), device="cpu"), js)
