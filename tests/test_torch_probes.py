"""K1's cost probes in the port against the JAX package, tolerance zero.

- K1-null (`fused_step(null_body=True)`) against the JAX kernel built by
  ``make_fused_step(..., null_body=True)`` in interpret mode;
- P1 (`null_copy`) against the JAX state's dyn leaves;
- P2 (`op_chain`) against ``tools/tpu_op_cost.build`` run in TPU
  interpret mode, and elementwise against a numpy transcription;
- P3 (`step_prefix`) against the checksum assembled in numpy from the JAX
  engine's ``_sample_action_w`` and ``_ball_ids_xy``, and at cut 3 from
  `fused_step_plain` (held to JAX in tests/test_torch_step.py);
- the tools of ``eldorado_tpu_torch.tools`` refuse to run without a GPU.

The state is 8 envs of vec_reset(3, 8, 4, 1, EASY, 100000), and, for P3, the
same envs 40 steps on with every third one done.
"""
import importlib
import importlib.util
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from eldorado_tpu.core import engine as JE
from eldorado_tpu.ops.step_kernel import make_fused_step
from eldorado_tpu.vec import sampler_init, vec_reset
from eldorado_tpu_torch import convert
from eldorado_tpu_torch.core import engine as TE
from eldorado_tpu_torch.ops import probes as P
from eldorado_tpu_torch.ops import step_kernel as K

N = 8
ROOT = pathlib.Path(__file__).resolve().parents[1]
_OFF = {f: off for f, _, _, off, _ in TE.DYN_LAYOUT}


@pytest.fixture(scope="module")
def jax_start():
    return vec_reset(3, N, 4, 1, 0, 100000), sampler_init(7, N)


def _port(js, jr):
    s = convert.state_from_numpy(js, device="cpu")
    static = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    carry = TE.pack_dyn(TE.split_state(s)[1])
    return carry, convert.rngs_from_numpy(jr, device="cpu"), static


@pytest.fixture(scope="module")
def mid_game(jax_start):
    """The port's carry 40 steps on, every third env then marked done."""
    carry, srng, static = _port(*jax_start)
    carry, srng, _ = K.fused_step(carry, srng, *static, 40)
    carry = carry.clone()
    carry[_OFF["done"], ::3] = 1
    return carry, srng, static


# ---------------------------------------------------------------- K1-null
def test_null_body_equals_jax_kernel(jax_start):
    """One K1-null launch against the JAX null-body kernel: every dyn
    field and srng unchanged, actions zero; the dead counter untouched
    for any n_steps."""
    js, jr = jax_start
    fused = jax.jit(make_fused_step(js, "storage", block=8, interpret=True,
                                    null_body=True))
    js2, jr2, ja = fused(js, jr)
    carry, srng, static = _port(js, jr)
    for n_steps in (1, 5):
        dead = torch.full((1,), 3, dtype=torch.int64)
        c, r, a = K.fused_step(carry, srng, *static, n_steps, "storage",
                               False, dead, null_body=True)
        assert np.array_equal(a.numpy(), np.asarray(ja))
        assert np.array_equal(r.numpy(), np.asarray(jr2))
        for f, x in zip(TE.DYN_FIELDS, TE.unpack_dyn(c)):
            assert np.array_equal(x.numpy(), np.asarray(getattr(js2, f))), f
        assert int(dead) == 3


# --------------------------------------------------------------------- P1
def test_null_copy_is_identity_on_jax_leaves(jax_start):
    """The TPU probe's body lives inside tools/tpu_null_kernel.py:main
    (:96-100) and cannot be called: it copies every dyn leaf of K1's
    windows in to out. So the port is held to what that body computes,
    the identity on the JAX state's dyn leaves."""
    js, jr = jax_start
    carry = _port(js, jr)[0]
    out = P.null_copy(carry)
    assert out.data_ptr() != carry.data_ptr()
    for f, x in zip(TE.DYN_FIELDS, TE.unpack_dyn(out)):
        assert np.array_equal(x.numpy(), np.asarray(getattr(js, f))), f


# --------------------------------------------------------------------- P2
@pytest.fixture(scope="module")
def op_cost_tool():
    """tools/tpu_op_cost.py as a module; it sets the compilation cache
    directory (environment and jax config) at import, restored here."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cfg = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "tpu_op_cost", ROOT / "tools" / "tpu_op_cost.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
        jax.config.update("jax_compilation_cache_dir", cfg)
        sys.path[:] = path
    return mod


def _op_chain_numpy(x, y, k, op):
    """The tool's kernel body on uint32, shifts on the int32 view."""
    v, w = x.astype(np.uint32), y.astype(np.uint32)
    for _ in range(k // 2):
        if op == "add":
            v = v + w
            w = w ^ v
        else:
            v = np.where((v & 3) > 1, v + w, v - w)
            w = w ^ (v.view(np.int32) >> 1).view(np.uint32)
    return (v + w).view(np.int32)


@pytest.mark.parametrize("op", ["add", "sel"])
@pytest.mark.parametrize("k", [2, 6, 64])
@pytest.mark.parametrize("shape", [(8, 64), (3, 512)])
def test_op_chain_equals_tool(op_cost_tool, shape, k, op):
    """Two chained calls, as the tool's scan with steps=2: the sum equals
    the tool's (interpret mode), every element the numpy body's."""
    rng = np.random.default_rng(k + len(shape) + shape[0])
    x, y = (rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)
            for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want_sum = int(op_cost_tool.build(shape, k, op)(
            jnp.asarray(x), jnp.asarray(y), 2))
    z, want = torch.from_numpy(x), x
    for _ in range(2):
        z = P.op_chain(z, torch.from_numpy(y), k, op)
        want = _op_chain_numpy(want, y, k, op)
    assert np.array_equal(z.numpy(), want)
    got_sum = int(P._wrap_i32(z.sum(dtype=torch.int64)))
    assert got_sum == want_sum


# --------------------------------------------------------------------- P3
_sample = jax.jit(jax.vmap(JE._sample_action_w))
_ball = jax.jit(jax.vmap(JE._ball_ids_xy))


def _fields(carry):
    d = dict(zip(TE.DYN_FIELDS, (x.numpy() for x in TE.unpack_dyn(carry))))
    return d, np.arange(carry.shape[1])


def _agent_ids(carry, static):
    d, e = _fields(carry)
    pxy = d["player_xy"][e, d["agent"]][:, None]
    ids = np.asarray(_ball(static[0].numpy(), static[1].numpy(), pxy))[:, 0]
    return np.where(d["done"], 0, ids.sum(1, dtype=np.int64))


def _finish(acc, carry, srng):
    acc = acc + carry.numpy().astype(np.int64).sum(0) + srng.numpy()
    return (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("cut", [0, 1, 2])
def test_step_prefix_equals_jax_engine(mid_game, cut, n_steps):
    """Cuts below 3 leave the state as it is: the checksum is the JAX
    sampler's heads on the agent's storage mask each round, the JAX ball
    read's ids for envs not done (cut 2), then the carry words and srng."""
    carry, srng, static = mid_game
    d, e = _fields(carry)
    acc = np.zeros(N, np.int64)
    r = srng.numpy()
    for _ in range(n_steps if cut else 0):
        heads, r, _ = _sample(r, d["storage_masks"][e, d["agent"]])
        acc += np.asarray(heads).sum(1)
        if cut == 2:
            acc += _agent_ids(carry, static)
    want = _finish(acc, carry, torch.from_numpy(np.array(r)))
    got = P.step_prefix(carry, srng, *static, n_steps, cut)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_step_prefix_cut3_equals_plain_step(mid_game, n_steps):
    """Cut 3 is the whole step: each round's heads are the step's
    actions, the ids the JAX ball read before the step, and the words
    those of the stepped carry."""
    carry, srng, static = mid_game
    acc = np.zeros(N, np.int64)
    c, r = carry, srng
    for _ in range(n_steps):
        acc += _agent_ids(c, static)
        c, r, a = K.fused_step_plain(c, r, *static, 1)
        acc += a.numpy().sum(1)
    got = P.step_prefix(carry, srng, *static, n_steps, 3)
    assert np.array_equal(got.numpy(), _finish(acc, c, r))


# ------------------------------------------------------------------ tools
@pytest.mark.parametrize("name", ["step_cost", "null_kernel", "op_cost",
                                  "prefix_profile", "sample_cost",
                                  "learner_rate"])
def test_tool_refuses_without_gpu(monkeypatch, name):
    mod = importlib.import_module(f"eldorado_tpu_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
