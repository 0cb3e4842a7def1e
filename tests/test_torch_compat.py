"""The port's `city_of_gold` surface (eldorado_tpu_torch.compat) against the
JAX package's, tolerance zero, on CPU tensors (the kernels' plain
versions: K1-act's for the step, K3's and K2's for the reset, K1-sample's
for the vectorised sampler).

* ``cog_env(backend="device", device="cpu")`` against the JAX package's
  RefEnv in the script of tests/test_api_surfaces.py:140-172 (every
  observation, mask, reward and info field after every step), and through
  a game played to a win followed by a full-parameter reset, which must
  keep what the reference keeps (rewards, infos, the shop's n_in_market);
* ``backend="ref"`` (the port's copy of RefEnv) the same way;
* ``init`` buffers, the getters and ``render`` (test_api_surfaces.py
  :175-303), `action_sampler` against the JAX package's;
* ``compat.vec`` at N=16 for 15 steps against the JAX package's
  ``compat.vec``: actions, dones, observations, infos, masks, rewards and
  agents at every step; the native observation packing against its numpy
  plain version; the runner.
"""
import numpy as np
import pytest

from eldorado_tpu import compat as jcog
from eldorado_tpu import render as jrender
from eldorado_tpu.compat import vec as jcvec
from eldorado_tpu.core.ref_engine import RefEnv, RefSampler
from eldorado_tpu_torch import compat as cog
from eldorado_tpu_torch.compat import vec as cvec
from eldorado_tpu_torch.ops import step_kernel as K

CPU = dict(device="cpu")
N = 16


def assert_env_equal(env, ref, where=""):
    """Every field the surface shows, cog_env against a JAX-package RefEnv
    behind its own cog_env(backend="ref")."""
    assert env.observations.tobytes() == ref.observations.tobytes(), where
    assert env.infos.tobytes() == ref.infos.tobytes(), where
    assert (env.selected_action_mask.tobytes()
            == ref.selected_action_mask.tobytes()), where
    assert np.array_equal(env.rewards, ref.rewards), where
    assert env.get_done() == ref.get_done(), where
    assert env.agent_selection == ref.agent_selection, where
    for name in ("player_xy", "min_xy"):
        assert np.array_equal(getattr(env.get_map(), name),
                              getattr(ref.get_map(), name)), (where, name)


def drive_pair(backend, n_steps=60):
    """test_api_surfaces._drive_pair: the port's cog_env and the JAX
    package's RefEnv, each with its own sampler, checked every step."""
    env = cog.cog_env(seed=77, n_players=3, n_pieces=2,
                      difficulty=cog.Difficulty.EASY, max_steps=100000,
                      backend=backend, **CPU)
    env.reset()
    sam = cog.action_sampler(13)
    ref = jcog.cog_env(seed=77, n_players=3, n_pieces=2, difficulty=0,
                       max_steps=100000, backend="ref")
    ref.reset()
    rsam = RefSampler(13)
    for t in range(n_steps):
        a = sam.sample(env.selected_action_mask)
        env.step(a)
        ref.step(rsam.sample(ref._env.sel_mask))
        if ref.get_done():
            ref.reset()
        if env.get_done():
            env.reset()
        assert_env_equal(env, ref, f"step {t}")
    return env, ref


@pytest.mark.parametrize("backend", ["device", "ref"])
def test_cog_env_matches_ref_engine(backend):
    env, ref = drive_pair(backend)
    assert env.agent_selection == ref._env.agent
    assert np.array_equal(env.observations["shared"]["map"], ref._env.map.obs)


def test_full_reset_after_a_won_game_keeps_what_the_reference_keeps():
    """A 2-player game played to a win (649 steps, storage masks), then
    cog_env::reset(seed, ...) with new parameters: the state is written
    into the existing one, so the rewards, infos and n_in_market of the
    finished game persist (ref_engine.py:25-41) and equal the reference's;
    a fresh env reset with the same parameters differs."""
    kw = dict(seed=10, n_players=2, n_pieces=1, difficulty=0,
              max_steps=100000)
    env = cog.cog_env(**kw, **CPU)
    ref = jcog.cog_env(**kw, backend="ref")
    env.reset()
    ref.reset()
    sam = RefSampler(110)
    t = 0
    while not ref.get_done():
        a = sam.sample(ref._env.storage_masks[ref._env.agent])
        env.step(a)
        ref.step(a)
        t += 1
    assert t == 649 and env.get_done()
    assert ref.rewards.any()   # a win, not a truncation
    assert_env_equal(env, ref, "end of game")
    new = (31, 3, 2, 1, 500)
    env.reset(*new)
    ref.reset(*new)
    assert_env_equal(env, ref, "after the full reset")
    assert ref.rewards.any() and ref.infos["total_length"] > 0
    d, r = env._env, ref._env
    kept = cog.host_fields(d._carry, ("n_in_market",))["n_in_market"]
    assert int(kept[0]) == int(r.n_in_market)
    assert (env.get_seed(), env.get_n_players(), env.get_n_pieces(),
            env.get_difficulty(), env.get_max_steps()) == (31, 3, 2, 1, 500)
    fresh = cog.cog_env(*new[:4], new[4], **CPU)
    fresh.reset()
    assert fresh.infos.tobytes() != env.infos.tobytes()
    assert not fresh.rewards.any()
    sam = RefSampler(5)   # the game goes on from the persisted state
    for t in range(20):
        a = sam.sample(r.sel_mask)
        env.step(a)
        ref.step(a)
        assert_env_equal(env, ref, f"step {t} after the full reset")


def test_step_refuses_an_action_outside_its_head():
    env = cog.cog_env(seed=4, n_players=2, n_pieces=2, **CPU)
    env.reset()
    before = env.observations.tobytes()
    for h, width in enumerate(K.HEAD_WIDTHS):
        a = np.zeros(5, np.uint8)
        a[h] = width
        with pytest.raises(ValueError, match="outside its head"):
            env.step(a)
    assert env.observations.tobytes() == before


def test_cog_env_init_buffers_sync():
    """init() wires caller-owned buffers (single_env.cpp:19-21)."""
    obs = np.zeros((), cog.obs_dtype)
    info = np.zeros((), cog.info_dtype)
    rewards = np.zeros(4, np.float32)
    mask = np.zeros((), cog.action_mask_dtype)
    env = cog.cog_env(seed=5, n_players=2, n_pieces=2,
                      difficulty=cog.Difficulty.EASY, **CPU)
    env.init(obs, info, rewards, mask)
    env.reset()
    assert obs["shared"]["map"].any(), "reset must sync the map buffer"
    assert mask["move"].shape == (7,)
    sam = cog.action_sampler(3)
    before = obs["shared"]["map"].copy()
    for _ in range(10):
        env.step(sam.sample(env.selected_action_mask))
    assert np.array_equal(obs["shared"]["map"], before), \
        "map never changes after reset (SURVEY quirk 2)"
    assert mask[()] == env.selected_action_mask[()]
    assert obs.tobytes() == env.observations.tobytes()
    assert info.tobytes() == env.infos.tobytes()
    with pytest.raises(TypeError):
        env.init(np.zeros(()), info, rewards, mask)


def test_cog_env_getters_and_render(capsys):
    env = cog.cog_env(seed=4, n_players=2, n_pieces=2,
                      difficulty=cog.Difficulty.EASY, max_steps=500, **CPU)
    env.reset()
    assert env.get_seed() == 4
    assert env.get_n_players() == 2
    assert env.get_n_pieces() == 2
    assert env.get_difficulty() == cog.Difficulty.EASY
    assert env.get_max_steps() == 500
    assert env.get_render() is False
    assert env.get_done() is False
    assert env.get_map() is not None
    env.render()
    assert "without specifying" in capsys.readouterr().out
    env = cog.cog_env(seed=3, n_players=2, n_pieces=2, render=True, **CPU)
    env.reset()
    env.render()
    ref = RefEnv(seed=3, n_players=2, n_pieces=2, difficulty=0,
                 max_steps=100000)
    ref.reset()
    assert capsys.readouterr().out == jrender.render_env(ref) + "\n"
    with pytest.raises(ValueError, match="backend"):
        cog.cog_env(seed=3, backend="jax", **CPU)


def test_action_sampler_matches_the_jax_package():
    ours, theirs = cog.action_sampler(7), jcog.action_sampler(7)
    g = np.random.default_rng(1)
    for t in range(200):
        if t == 100:
            ours.set_seed(99)
            theirs.set_seed(99)
        flat = g.random(92) < 0.3
        mask = cog._mask_to_struct(flat) if t % 2 else flat
        assert ours.sample(mask).tobytes() == theirs.sample(mask).tobytes()


@pytest.fixture(scope="module")
def vec_runs():
    """The loop of test_api_surfaces.test_compat_vec_surfaces, 2-turn
    games so that auto-resets fire, on the port (CPU tensors) and on the
    JAX package: each step's outputs as bytes."""
    runs = []
    for mod, kw in ((cvec, CPU), (jcvec, {})):
        venv = mod.get_vec_env(N, **kw)
        venv.reset(seed=21, n_pieces=2, max_steps=2)
        sampler = mod.get_vec_sampler(N, **kw)
        sampler.seed(9)
        rec = []
        for _ in range(15):
            actions = sampler.sample(venv.get_selected_action_masks())
            done = venv.step(actions)
            rec.append(dict(
                actions=actions.tobytes(), sampled=sampler.get_actions(),
                done=np.asarray(done), dones=venv.get_dones(),
                obs=venv.get_observations(), infos=venv.get_infos(),
                masks=venv.get_selected_action_masks(),
                rewards=venv.get_rewards(),
                agents=venv.get_agent_selections(),
                players=venv.get_num_players(), info3=venv.get_info(3)))
        runs.append((venv, rec))
    return runs


def test_compat_vec_matches_the_jax_package(vec_runs):
    (venv, ours), (_, theirs) = vec_runs
    resets = 0
    for t, (a, b) in enumerate(zip(ours, theirs)):
        for key in a:
            x, y = a[key], b[key]
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, (t, key)
                x, y = x.tobytes(), y.tobytes()
            assert x == y, (t, key)
        resets += int(a["done"].sum())
    assert resets > 0   # 2-turn games end inside the 15 steps
    assert venv.get_num_envs() == N
    assert venv.states.map_ids.shape == (N, 48 * 48)


def test_native_packing_equals_the_numpy_version(vec_runs):
    venv = vec_runs[0][0]
    f = venv._fields(cvec._OBS_FIELDS)
    want = cvec.pack_obs_plain(
        cvec.expand_obs_np(venv._v._static["map_ids"].numpy()), f)
    got = venv.get_observations()
    assert got.dtype == want.dtype == cog.obs_dtype
    assert got.tobytes() == want.tobytes()


def test_runner_steps_the_sampled_actions():
    runner = cvec.get_runner(N, 2, **CPU)
    runner.reset(seed=21, n_pieces=2)
    env = cvec.get_vec_env(N, **CPU)
    env.reset(seed=21, n_pieces=2)
    runner.sample()
    runner.step_sync()
    runner.step()     # the same actions again, as the JAX runner does
    runner.sync()
    acts = runner._actions.numpy()
    env.step(acts)
    env.step(acts)
    assert (env.get_observations().tobytes()
            == _as_compat(runner.env).get_observations().tobytes())


def _as_compat(v):
    """A VecEnvCompat view of a VecEnv (the runner's batch)."""
    out = cvec.VecEnvCompat.__new__(cvec.VecEnvCompat)
    out.n_envs, out._v = v.n_envs, v
    return out
