"""The port's entry points make their tensors on the card unless asked not to.

Every entry point that makes tensors from plain values takes
``device="cuda"``. Where there is no CUDA device, as in the CPU test run,
the default call raises a RuntimeError and makes no CPU tensors; with
``device="cpu"`` the same calls give the CPU tensors the other CPU tests
use. The tests of the raising call skip on a machine with a card, where
the default call succeeds.
"""
import inspect

import numpy as np
import pytest
import torch

from eldorado_tpu_torch import compat, convert, stream, vec
from eldorado_tpu_torch.compat import vec as cvec
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.ops import rng as R

ENTRY_POINTS = {
    "vec_reset": vec.vec_reset,
    "vec_reset_varied": vec.vec_reset_varied,
    "sampler_init": vec.sampler_init,
    "state_from_numpy": convert.state_from_numpy,
    "rngs_from_numpy": convert.rngs_from_numpy,
    "device_stats_init": stream.device_stats_init,
    "make_state": E.make_state,
    "seed": R.seed,
    "cog_env": compat.cog_env,
    "get_vec_env": cvec.get_vec_env,
    "get_vec_sampler": cvec.get_vec_sampler,
    "get_runner": cvec.get_runner,
}


@pytest.fixture(scope="module")
def fields():
    """A 2-env reset state as numpy fields, made on the CPU."""
    return convert.state_to_numpy(vec.vec_reset(1, 2, device="cpu"))


def calls(fields):
    """Each entry point's call, given the device keywords."""
    return {
        "vec_reset": lambda **kw: vec.vec_reset(1, 2, **kw),
        "vec_reset_varied": lambda **kw: vec.vec_reset_varied([1, 2], **kw),
        "sampler_init": lambda **kw: vec.sampler_init(1, 2, **kw),
        "state_from_numpy": lambda **kw: convert.state_from_numpy(fields,
                                                                  **kw),
        "rngs_from_numpy": lambda **kw: convert.rngs_from_numpy([5, 6],
                                                                **kw),
        "device_stats_init": lambda **kw: stream.device_stats_init(**kw),
        "make_state": lambda **kw: E.make_state([1, 2], **kw),
        "seed": lambda **kw: R.seed([1, 2], **kw),
        "cog_env": lambda **kw: compat.cog_env(1, 2, 1, **kw),
        "get_vec_env": lambda **kw: reset(cvec.get_vec_env(2, **kw)),
        "get_vec_sampler": lambda **kw: cvec.get_vec_sampler(2, **kw),
        "get_runner": lambda **kw: reset(cvec.get_runner(2, **kw)),
    }


def reset(compat_env):
    compat_env.reset(seed=1, n_pieces=1)
    return compat_env


def tensors(out):
    """Every tensor of an entry point's result."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, E.EnvState):
        return [getattr(out, f) for f in E.FIELDS]
    if isinstance(out, compat.cog_env):
        return [out._env._carry, *out._env._static.values()]
    if isinstance(out, (cvec.VecEnvCompat, cvec.RunnerCompat)):
        return [out._v._carry, out._v.sampler_rngs,
                *out._v._static.values()]
    if isinstance(out, cvec.VecSamplerCompat):
        return [out._rngs]
    return list(out)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_default_device_is_cuda(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_default_call_raises_without_a_card(fields, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call runs there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        calls(fields)[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_cpu_call_gives_cpu_tensors(fields, name):
    out = calls(fields)[name](device="cpu")
    assert all(t.device.type == "cpu" for t in tensors(out))
    if isinstance(out, E.EnvState):
        for f in E.FIELDS:
            shape, dtype = E.FIELD_SPECS[f]
            x = getattr(out, f)
            assert x.dtype == dtype and tuple(x.shape) == (2,) + shape, f
    if name in ("vec_reset", "vec_reset_varied", "state_from_numpy"):
        for f in E.FIELDS:
            assert np.array_equal(getattr(out, f).numpy(), fields[f]), f
    if name in ("sampler_init", "seed", "make_state"):
        # engine i seeded with seed + i (seed 1) or with [1, 2]
        rng = out.rng if name == "make_state" else out
        assert rng.dtype == torch.int32 and rng.tolist() == [1, 2]
    if name == "rngs_from_numpy":
        assert out.dtype == torch.int32 and out.tolist() == [5, 6]
    if name == "device_stats_init":
        assert [t.shape for t in out] == [(), (), (), (5, 22)]
        assert not any(bool(t.any()) for t in out)


def test_cpu_tensors_take_the_plain_generator():
    """On CPU tensors map generation and its prelude run the plain
    versions (no K3 launch, no trip counted on a card), and K3's wrapper
    refuses CPU tensors instead of running anything."""
    from eldorado_tpu_torch.core import mapgen as MG
    launches = MG.generate_map.launches
    trips = MG.generate_map_plain.cuda_trips
    st = E.make_state([3, 4, 5], 2, 2, 1, 100, device="cpu")
    gen = MG.generate_map(st.rng, st.n_pieces, st.difficulty)
    plain = MG.generate_map_plain(st.rng, st.n_pieces, st.difficulty)
    assert torch.equal(gen.ids, plain.ids) and bool(gen.ok.all())
    E.reset_map_prelude(st.rng, st.n_pieces, st.difficulty, st.n_players)
    assert (MG.generate_map.launches,
            MG.generate_map_plain.cuda_trips) == (launches, trips)
    with pytest.raises(ValueError, match="CUDA device"):
        MG.launch(st.rng, st.n_pieces, st.difficulty,
                  (st.map_ids, st.min_xy, st.map_ok, st.map_overflow))
