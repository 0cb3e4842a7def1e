"""The port's copies of the numpy reference engine and the renderer, against
the JAX package's originals, tolerance zero.

``eldorado_tpu_torch.core.ref_engine`` (RefEnv, RefSampler, MinstdRng) runs
in lockstep with ``eldorado_tpu.core.ref_engine`` on the parameters of the
four non-slow cases of tests/test_ref_traj.py (a prefix of each), every
attribute of the env, its map and both engines compared after every step;
then replays the goldens ``traj_trunc`` and ``traj_trunc_storage`` at full
length through test_ref_traj.replay. The renderer's strings, with and
without colour, and the compat surface's structured dtypes equal the JAX
package's; and importing the copied modules and the compat surface pulls
in neither jax nor the JAX package.
"""
import subprocess
import sys

import numpy as np
import pytest

import test_ref_traj
from eldorado_tpu import compat as jcompat
from eldorado_tpu import render as jrender
from eldorado_tpu.core import ref_engine as JR
from eldorado_tpu_torch import compat
from eldorado_tpu_torch import render
from eldorado_tpu_torch.core import ref_engine as R

PREFIX = 300
# (golden, mask_src, max_steps): test_ref_traj's non-slow cases
CASES = [("traj_4p_medium", 0, 100000), ("traj_3p_hard", 0, 100000),
         ("traj_trunc", 0, 100), ("traj_trunc_storage", 1, 100)]


def plain(x):
    """x as nested builtins, classes by name: one env's whole state."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return (type(x).__name__, x.item())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if hasattr(x, "__dict__") or hasattr(x, "__slots__"):
        names = (vars(x) if hasattr(x, "__dict__")
                 else {s: getattr(x, s) for s in x.__slots__})
        return (type(x).__name__, plain(names))
    return x


def make_pair(name, max_steps):
    es, ss, n_players, n_pieces, diff, _ = (
        int(v) for v in np.load(f"{test_ref_traj.GOLDEN}/{name}.npz")["header"])
    out = []
    for mod in (R, JR):
        env = mod.RefEnv(seed=es, n_players=n_players, n_pieces=n_pieces,
                         difficulty=diff, max_steps=max_steps)
        env.reset()
        out.append((env, mod.RefSampler(ss)))
    return out


@pytest.mark.parametrize("name,mask_src,max_steps", CASES)
def test_copy_in_lockstep_with_the_original(name, mask_src, max_steps):
    (env, sam), (jenv, jsam) = make_pair(name, max_steps)
    assert plain(env) == plain(jenv)
    for t in range(PREFIX):
        src = env.storage_masks[env.agent] if mask_src else env.sel_mask
        act = sam.sample(src)
        jsrc = jenv.storage_masks[jenv.agent] if mask_src else jenv.sel_mask
        assert np.array_equal(act, jsam.sample(jsrc)), f"step {t}: action"
        env.step(act)
        jenv.step(act)
        if env.done:
            env.reset()
            jenv.reset()
        assert plain(env) == plain(jenv), f"step {t}"
        assert sam.rng.state == jsam.rng.state, f"step {t}: sampler"


@pytest.mark.parametrize("name,mask_src", [("traj_trunc", 0),
                                           ("traj_trunc_storage", 1)])
def test_copy_replays_the_golden(monkeypatch, name, mask_src):
    monkeypatch.setattr(test_ref_traj, "RefEnv", R.RefEnv)
    monkeypatch.setattr(test_ref_traj, "RefSampler", R.RefSampler)
    test_ref_traj.replay(name, mask_src, 100, None)


def test_minstd_and_map_failure_match():
    for seed in (0, 1, 2 ** 31 - 1, 2 ** 32 - 1, 12345):
        a, b = R.MinstdRng(seed), JR.MinstdRng(seed)
        assert [a() for _ in range(8)] == [b() for _ in range(8)]
        assert ([a.uniform_int(n) for n in (1, 7, 92, 2 ** 20)]
                == [b.uniform_int(n) for n in (1, 7, 92, 2 ** 20)])
    # only 3 EASY travel pieces exist: both raise the same failure
    for mod in (R, JR):
        env = mod.RefEnv(seed=1, n_players=4, n_pieces=4, difficulty=0,
                         max_steps=100)
        with pytest.raises(mod.GenerateMapFailure):
            env.reset()
    assert R.GenerateMapFailure.__module__ == "eldorado_tpu_torch.errors"


@pytest.mark.parametrize("color", [False, True])
def test_render_equals_the_original(color):
    (env, sam), (jenv, _) = make_pair("traj_4p_medium", 100000)
    for _ in range(40):
        act = sam.sample(env.storage_masks[env.agent])
        env.step(act)
        jenv.step(act)
    got = render.render_env(env, color=color)
    assert got == jrender.render_env(jenv, color=color)
    assert ("\x1b[" in got) == color


def test_dtypes_equal_the_original():
    for name in ("deck_dtype", "action_mask_dtype", "player_dtype",
                 "shared_dtype", "obs_dtype", "action_dtype",
                 "agent_info_dtype", "info_dtype"):
        assert getattr(compat, name) == getattr(jcompat, name), name
    assert compat.max_envs == jcompat.max_envs
    assert compat.__all__ == jcompat.__all__
    assert list(compat.Difficulty) == [int(d) for d in jcompat.Difficulty]


def test_port_imports_no_jax():
    """In a fresh interpreter, the copied modules and the compat surface
    import neither jax nor the JAX package (any module the interpreter
    had loaded at start-up is dropped first, so an import would show)."""
    code = (
        "import sys\n"
        "for m in [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'eldorado_tpu'))]:\n"
        "    del sys.modules[m]\n"
        "import eldorado_tpu_torch.compat, eldorado_tpu_torch.compat.vec\n"
        "import eldorado_tpu_torch.render, eldorado_tpu_torch.core.ref_engine\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'eldorado_tpu' or "
        "m.startswith('eldorado_tpu.'))\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
