"""The port's learner surface on CPU tensors (the plain versions of K1-act,
K1-sample, K3 and K2) against the JAX package, tolerance zero, at the
shapes of tests/test_api_surfaces.py (16 envs, 2 pieces): vec_step on
sampled actions and on random actions inside the heads that the masks
forbid; vec_sample with and without live flags; rollout (the plain K1
writing the trajectory record, K3 and K2 at each step's resets) in both
auto-reset modes and with both mask sources, and kernel_rollout against
the JAX Pallas kernel in interpret mode: the final state, the sampler
engines and every per-step output; reset_done and reset_done_bucketed;
VecEnv's sample / step loop (the port of
test_api_surfaces.py::test_vecenv_sample_step_loop); and the ValueError
on actions outside their heads. Then, on the port alone: the trajectory
record's packing on values these short games never reach (the rewards of
a won game), the exact-mode check of tests/test_exact_reset.py against
the port's own rollout(auto_reset="step"), a trajectory golden through
VecEnv, and VecEnv's reset queue on the device against the host path
(tests/learner_queue.py), with the ops its step runs around the kernels.

Most of the file's time is the JAX package compiling each static
configuration once (vec_reset, vec_step, the four rollouts, the
interpret-mode kernel, the resets), so the tests share one module's
compiles: the rollouts are run once each (the `rollouts` fixture), and
the resets start from the ("none", "storage") rollout's batch.

The games are short (6 turns), so every episode here ends by truncation
and resets fire: after a move that wins, the JAX package keeps a stale
one-hop word that the port repairs (ROADMAP.md, Queue 3), so where games
are won the goldens decide, as in the last test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
import learner_queue as LQ
import traj_replay as TR
from eldorado_tpu import vec as JV
from eldorado_tpu.core import engine as JE
from eldorado_tpu_torch import convert
from eldorado_tpu_torch.core import engine as TE
from eldorado_tpu_torch.ops import step_kernel as K

N, PIECES, TURNS = 16, 2, 6
WIDTHS = np.asarray(K.HEAD_WIDTHS)


def assert_states_equal(ours, theirs, tag=""):
    got = convert.state_to_numpy(ours)
    for f in JE.EnvState._fields:
        want = np.asarray(getattr(theirs, f))
        assert got[f].dtype == want.dtype, f"{tag} {f}"
        assert np.array_equal(got[f], want), f"{tag} {f}"


def both(seed=21, sampler_seed=42):
    """The same batch and samplers from each package."""
    js = JV.vec_reset(seed, N, 4, PIECES, 0, TURNS)
    jr = JV.sampler_init(sampler_seed, N)
    ts = et.vec_reset(seed, N, 4, PIECES, 0, TURNS, device="cpu")
    tr = et.sampler_init(sampler_seed, N, device="cpu")
    assert_states_equal(ts, js, "reset")
    return js, jr, ts, tr


@pytest.mark.parametrize("kind", ["sampled", "forbidden"])
def test_vec_step_equals_jax(kind):
    """30 steps of vec_step, every field and done flag equal after each;
    the actions sampled from the storage masks (resets fire), or each head
    0 or drawn inside the head at random, half and half (mostly forbidden
    by the masks)."""
    js, jr, ts, _ = both()
    gen = np.random.default_rng(0)
    forbidden = episodes = 0
    launches = K.step_actions.launches
    for t in range(30):
        mask = JV._active_mask(js, "storage")
        if kind == "sampled":
            acts, jr, _ = JV.vec_sample(jr, mask)
            acts = np.asarray(acts)
        else:
            acts = gen.integers(0, 1 << 20, (N, 5)) % WIDTHS
            acts = np.where(gen.random((N, 5)) < 0.5, acts, 0)
            acts = acts.astype(np.int32)
            m = np.asarray(mask)
            forbidden += int(sum((~m[np.arange(N), off + acts[:, h]]).sum()
                                 for h, (off, _) in enumerate(JE._HEAD_DEFS)))
        js, jd = JV.vec_step(js, jnp.asarray(acts))
        ts, td = et.vec_step(ts, torch.as_tensor(acts))
        assert np.array_equal(td.numpy(), np.asarray(jd)), t
        assert_states_equal(ts, js, f"step {t}")
        episodes += int(td.sum())
    assert episodes > 0 if kind == "sampled" else forbidden > N * 30
    assert K.step_actions.launches == launches   # CPU: the plain version


@pytest.mark.parametrize("live", [False, True])
def test_vec_sample_equals_jax(live):
    """vec_sample on each env's storage mask (and K1-sample's plain
    version with live flags, against sample_action(live=...)): actions,
    engines and tainted flags."""
    js, jr, ts, tr = both()
    masks = JV._active_mask(js, "storage")
    if live:
        flags = np.arange(N) % 3 != 0
        want = jax.vmap(JE.sample_action)(jr, masks, jnp.asarray(flags))
        got = K.sample(tr, TE.pack_mask(torch.as_tensor(np.asarray(masks))),
                       torch.as_tensor(flags))
    else:
        want = JV.vec_sample(jr, masks)
        got = et.vec_sample(tr, torch.as_tensor(np.asarray(masks)))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().view(np.asarray(b).dtype)
                              if a.dtype == torch.int32 else a.numpy(),
                              np.asarray(b))
    if live:
        assert np.array_equal(got[1].numpy()[~flags],
                              tr.numpy()[~flags])


@pytest.mark.parametrize("mask_src", ["storage", "sel"])
def test_sample_carry_equals_jax_vecenv_sample(mask_src):
    """K1-sample reading its masks from the carry (`sample_carry`, its
    plain route here) against the JAX package's VecEnv.sample: 12 rounds
    of sample then step from the reset, with either mask source, each
    round's actions, the engines and every field (rng_tainted, into which
    the tainted flags OR) equal; each round one carry read and no
    separate mask table."""
    js, jr, ts, tr = both()
    ref = JV.VecEnv(N, mask_src)
    ref.states, ref.sampler_rngs = js, jr
    static, carry = et.vec._split(ts)
    for t in range(12):
        want = np.asarray(ref.sample())
        acts, tr = K.sample_carry(tr, carry, mask_src)
        assert np.array_equal(acts.numpy(), want), t
        assert np.array_equal(convert.rngs_to_numpy(tr),
                              np.asarray(ref.sampler_rngs)), t
        assert_states_equal(et.vec._merge(static, carry), ref.states, t)
        carry, _ = et.vec._step_columns(carry, static, acts)
        ref.step(want)


STEPS = 30


def assert_traj_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, i
        assert np.array_equal(a.numpy(), b), i


@pytest.fixture(scope="module")
def rollouts():
    """rollout(auto_reset, mask_src) from one batch in each package, run
    once per module: (JAX's result, the port's, K1's launches during the
    port's)."""
    done = {}

    def run(auto_reset, mask_src):
        if (auto_reset, mask_src) not in done:
            js, jr, ts, tr = both(seed=5, sampler_seed=11)
            want = JV.rollout(js, jr, STEPS, mask_src, auto_reset)
            launches = K.fused_step.launches
            got = et.rollout(ts, tr, STEPS, mask_src, auto_reset)
            done[auto_reset, mask_src] = (
                want, got, K.fused_step.launches - launches)
        return done[auto_reset, mask_src]
    return run


@pytest.mark.parametrize("mask_src", ["storage", "sel"])
@pytest.mark.parametrize("auto_reset", ["none", "step"])
def test_rollout_equals_jax(rollouts, auto_reset, mask_src):
    want, got, launches = rollouts(auto_reset, mask_src)
    assert_states_equal(got[0], want[0])
    assert np.array_equal(convert.rngs_to_numpy(got[1]), np.asarray(want[1]))
    assert_traj_equal(got[2], want[2])
    assert int(np.asarray(want[2][1]).sum()) > 0   # games ended
    assert launches == 0                           # CPU: the plain K1


def test_kernel_rollout_equals_jax():
    js, jr, ts, tr = both(seed=5, sampler_seed=11)
    want = JV.kernel_rollout(js, jr, STEPS, block=N, interpret=True)
    got = et.kernel_rollout(ts, tr, STEPS)
    assert_states_equal(got[0], want[0])
    assert np.array_equal(convert.rngs_to_numpy(got[1]), np.asarray(want[1]))
    assert_traj_equal(got[2], want[2])
    assert int(np.asarray(want[2][1]).sum()) > 0


@pytest.fixture(scope="module")
def some_done(rollouts):
    """Both packages' batch 30 steps into its rollout, some envs done by
    their turn limit, none reset."""
    want, got, _ = rollouts("none", "storage")
    js, ts = want[0], got[0]
    assert_states_equal(ts, js, "rollout")
    assert 0 < int(np.asarray(js.done).sum()) < N
    return js, ts


def test_reset_done_equals_jax(some_done):
    js, ts = some_done
    assert_states_equal(et.reset_done(ts), JV.reset_done(js))


def test_reset_done_bucketed_equals_jax(some_done):
    js, ts = some_done
    want, n_want = JV.reset_done_bucketed(js)
    got, n_got = et.reset_done_bucketed(ts)
    assert n_got == n_want > 0
    assert_states_equal(got, want)
    again = et.reset_done_bucketed(got)   # nothing left to reset
    assert again[1] == 0 and again[0] is got


@pytest.mark.parametrize("levels", ["uniform", "mixed"])
def test_vecenv_sample_step_loop(levels):
    """tests/test_api_surfaces.py's VecEnv loop on the port (shapes, the
    dead n_*_uses stats), held to the JAX package's VecEnv field for field
    after every step; envs reset on the way (through the step's reset
    queue). "uniform": 6-turn games; "mixed": each env at its level of
    cog-4p-mixed-t100 (`learner_queue.LEVELS`) from vec_reset_varied, in
    100-turn games entered near their end (`learner_queue.batch`)."""
    env = et.VecEnv(N, device="cpu")
    ref = JV.VecEnv(N)
    if levels == "uniform":
        obs = env.reset(seed=21, n_pieces=PIECES, max_steps=TURNS)
        ref.states = JV.vec_reset(21, N, 4, PIECES, 0, TURNS)
        ref.sampler_rngs = JV.sampler_init(42, N)
    else:
        states, srng = LQ.batch("mixed", N, 25, "cpu")
        env._attach(states, srng)
        obs = env.observations
        ref.states = JV.vec_reset_varied(
            5000 + np.arange(N), 4, [LQ.LEVELS[i % 3][0] for i in range(N)],
            [LQ.LEVELS[i % 3][1] for i in range(N)], LQ.TURNS)._replace(
                turn_counter=jnp.asarray(states.turn_counter.numpy()))
        ref.sampler_rngs = JV.sampler_init(77, N)
        assert_states_equal(states, ref.states, "reset")
    assert obs["map"].shape == (N, 48, 48, 7)
    assert obs["action_masks"].shape == (N, 4, 92)
    for key, want in ref.observations.items():
        assert np.array_equal(obs[key].numpy(), np.asarray(want)), key
    done_any = False
    for t in range(25):
        actions = env.sample()
        assert np.array_equal(actions.numpy(), np.asarray(ref.sample())), t
        done = env.step(actions)
        assert np.array_equal(done.numpy(),
                              np.asarray(ref.step(actions.numpy()))), t
        assert_states_equal(env.states, ref.states, f"step {t}")
        assert np.array_equal(convert.rngs_to_numpy(env.sampler_rngs),
                              np.asarray(ref.sampler_rngs))
        done_any |= bool(done.any())
    assert done_any
    assert np.asarray(done).shape == (N,)
    assert np.asarray(env.agent_selection).shape == (N,)
    assert np.asarray(env.rewards).shape == (N, 4)
    for prop in ("selected_action_masks", "agent_selection", "dones",
                 "rewards"):
        assert np.array_equal(getattr(env, prop).numpy(),
                              np.asarray(getattr(ref, prop))), prop
    infos, want = env.infos, ref.infos
    assert infos.keys() == want.keys()
    for key in infos:
        assert np.array_equal(infos[key].numpy(), np.asarray(want[key])), key
    assert np.asarray(infos["returns"]).shape == (N, 4)
    assert not np.asarray(infos["n_machete_uses"]).any()


@pytest.mark.parametrize("head,bad", [(0, -1), (1, 22), (2, 22), (3, 7),
                                      (4, 19)])
def test_actions_outside_their_heads_raise(head, bad):
    """vec_step and VecEnv.step raise ValueError for an action outside its
    head's width (or below 0), and the batch is left as it was."""
    env = et.VecEnv(4, device="cpu")
    env.reset(seed=3, n_pieces=1, max_steps=TURNS)
    before = env.states
    actions = env.sample()
    actions[2, head] = bad
    with pytest.raises(ValueError):
        env.step(actions)
    with pytest.raises(ValueError):
        et.vec_step(before, actions)
    for f in TE.FIELDS:
        assert torch.equal(getattr(env.states, f), getattr(before, f)), f


def test_traj_record_round_trip():
    """pack_traj then unpack_traj returns every field exactly: random
    in-range actions, agents and phases, done flags, the f32 rewards of
    won games (n_players * won - winners, negative too), fractional
    resources and any int32 sel words."""
    n = 1000
    gen = np.random.default_rng(6)
    fields = (
        torch.as_tensor(gen.integers(0, 1 << 20, (n, 5))
                        % np.asarray(K.HEAD_WIDTHS), dtype=torch.int32),
        torch.as_tensor(gen.random(n) < 0.5),
        torch.as_tensor(gen.integers(-4, 5, (n, 4)), dtype=torch.float32),
        torch.as_tensor(gen.integers(0, 4, n), dtype=torch.int32),
        torch.as_tensor(gen.integers(-2 ** 31, 2 ** 31, (n, 3)),
                        dtype=torch.int32),
        torch.as_tensor(gen.integers(-40, 80, (n, 3)) / 2,
                        dtype=torch.float32),
        torch.as_tensor(gen.integers(0, 3, n), dtype=torch.int32))
    act, done, rewards, agent, sel, resources, phase = fields
    got = K.unpack_traj(K.pack_traj(act, done, rewards, agent, sel,
                                    resources, phase))
    for i, (a, b) in enumerate(zip(got, fields)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


CHUNK, CHUNKS = 10, 12


def _exact_traj(states, srng):
    """K1 with gate_dead (exact mode: a done env draws nothing) chunk by
    chunk, writing the trajectory record, the finished envs reset at each
    boundary (reset_done_bucketed): the per-step (actions, done, rewards,
    agent)."""
    cols = [[], [], [], []]
    for _ in range(CHUNKS):
        static = {f: getattr(states, f) for f in TE.STATIC_FIELDS}
        carry = TE.pack_dyn(TE.split_state(states)[1])
        recs = torch.empty((CHUNK, 8, K.TRAJ_WORDS), dtype=torch.int32)
        carry, srng, _ = K.fused_step(
            carry, srng, static["map_ids"], static["min_xy"],
            static["n_players"], static["max_steps"], CHUNK, gate_dead=True,
            record="traj", records=recs)
        states = TE.merge_state(tuple(static[f] for f in TE.STATIC_FIELDS),
                                TE.unpack_dyn(carry))
        for c, t in zip(cols, K.unpack_traj(recs)[:4]):
            c.append(t.numpy())
        states, _ = et.reset_done_bucketed(states)
    return [np.concatenate(c) for c in cols]


def test_exact_per_env_sequences_match_step_reset():
    """tests/test_exact_reset.py's check on the port: each env's steps in
    exact mode with dead steps left out equal the port's
    rollout(auto_reset="step") (vec_cog_env's same-step reset)."""
    states = et.vec_reset(5, 8, 4, 1, 0, 20, device="cpu")
    srng = et.sampler_init(11, 8, device="cpu")
    ref = [t.numpy() for t in et.rollout(states, srng, CHUNK * CHUNKS,
                                         auto_reset="step")[2][:4]]
    acts, dones, rews, agents = _exact_traj(states, srng)
    entry_dead = np.concatenate([np.zeros((1, 8), bool), dones[:-1]])
    entry_dead[::CHUNK] = False
    assert entry_dead.sum() > 0, "the workload must defer resets"
    for e in range(8):
        live = ~entry_dead[:, e]
        k = int(live.sum())
        for name, got, want in (("actions", acts, ref[0]),
                                ("done", dones, ref[1]),
                                ("rewards", rews, ref[2]),
                                ("agent", agents, ref[3])):
            assert np.array_equal(got[live, e], want[:k, e]), (e, name)


def test_vecenv_replays_trajectory_golden():
    """traj_trunc (env seed 13, sampler seed 17, 4 players, 3 pieces,
    EASY, 100 turns, the sel mask) through VecEnv's sample / step loop:
    every compared field of its first 440 steps, which hold its first
    truncation reset (step 432) and that reset's map
    (tests/traj_replay.py's check)."""
    name, steps = "traj_trunc", 440
    d = TR.load(name)
    es, ss, n_players, n_pieces, diff, _ = TR.header(d)
    mask_src, max_steps = TR.probe_params(name)
    env = et.VecEnv(1, ("sel", "storage")[mask_src], device="cpu")
    env.reset(es, n_players, n_pieces, diff, max_steps, ss)
    rows = [env._carry[:, 0].clone()]
    acts, dones, maps = [], [], {-1: env._static["map_ids"][0].clone()}
    for t in range(steps):
        acts.append(env.sample()[0])
        dones.append(env.step(acts[-1][None])[0])
        if dones[-1]:
            maps[t] = env._static["map_ids"][0].clone()
        rows.append(env._carry[:, 0].clone())
    traj = TR.Trajectory(torch.stack(rows), torch.stack(acts),
                         torch.stack(dones), maps)
    assert len(maps) > 1
    TR.check(name, d, traj, steps)


# (case, envs, rounds): 100-turn games, cog-4p-mixed-t100's levels, and a
# step that ends 1030 of 1100 games, over the queue's 1024. A round at
# 1100 envs takes ~0.35 s of plain kernels here, so the burst runs 8
# rounds on the CPU; the card test runs it over 200.
QUEUE_CASES = [("t100", 24, 200), ("mixed", 18, 200), ("burst", 1100, 8)]


@pytest.mark.parametrize("case,n,rounds", QUEUE_CASES)
def test_vecenv_card_queue_equals_host_path(case, n, rounds):
    """VecEnv.step choosing its queue by select and resetting it with K3
    and K2 on its buffers (their plain versions here) equals the host
    path, `_reset_columns` on the ascending done rows, in every field, the
    done flags and the sampler engines after every round; every round that
    ended games counts in `VecEnv.card_queues` but the burst, which counts
    in `VecEnv.host_queues` alone."""
    got = LQ.run(*LQ.batch(case, n, rounds, "cpu"), rounds)
    assert got["ended"] >= (2 if case == "burst" else 10), got
    assert got["bursts"] == (case == "burst"), got
    assert got["card_queues"] == got["ended"] - got["bursts"], got
    assert got["host_queues"] == got["bursts"], got


def test_vecenv_step_queue_runs_no_sort(monkeypatch):
    """Around K1-act, select, K3 and K2 (their plain versions, whose own
    ops are not counted), a VecEnv step whose done envs fit the queue runs
    no sort, nonzero or arange and allocates nothing of the prelude's
    shapes: select, K3 and K2 run in that order on the queue's own
    buffers, the same every round."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Ops(TorchDispatchMode):
        """The ops dispatched outside the kernels' plain versions."""
        def __init__(self):
            super().__init__()
            self.inside, self.names, self.shapes, self.calls = 0, [], [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not self.inside:
                self.names.append(func.overloadpacket.__name__)
                self.shapes += [tuple(t.shape) for t in tree_flatten(out)[0]
                                if isinstance(t, torch.Tensor)]
            return out

    ops = Ops()

    def kernel(name, fn):
        def run(*args):
            if not ops.inside:   # fused_reset_plain calls itself
                ops.calls.append((name, args))
            ops.inside += 1
            try:
                return fn(*args)
            finally:
                ops.inside -= 1
        return run

    V = et.vec
    monkeypatch.setattr(V, "step_actions", kernel("k1act", V.step_actions))
    monkeypatch.setattr(V.Q, "select_plain",
                        kernel("select", V.Q.select_plain))
    monkeypatch.setattr(V.E, "reset_map_prelude_rows_plain",
                        kernel("k3", V.E.reset_map_prelude_rows_plain))
    monkeypatch.setattr(V.K, "fused_reset_plain",
                        kernel("k2", V.K.fused_reset_plain))
    env = et.VecEnv(N, device="cpu")
    env.reset(seed=21, n_pieces=1, max_steps=2)
    idx, count, pre = env._queue
    queues, bursts = 0, et.VecEnv.host_queues
    for t in range(12):
        acts = env.sample()
        ops.names, ops.shapes, ops.calls = [], [], []
        with ops:
            done = env.step(acts)
        k = int(done.sum())
        assert et.VecEnv.host_queues == bursts
        assert [c[0] for c in ops.calls] == (
            ["k1act", "select", "k3", "k2"] if k else ["k1act"]), t
        assert not {"sort", "nonzero", "arange"} & set(ops.names), \
            (t, ops.names)
        assert not [s for s in ops.shapes
                    if s[1:] in ((4, 2), (4, TE.N_BALL))], (t, ops.shapes)
        if k:
            queues += 1
            (_, sel), (_, k3), (_, k2) = ops.calls[1:]
            assert sel[2] is idx and sel[3] is count
            assert k3[4] is idx and k3[6] is count and k3[7] is pre
            assert all(a is b for a, b in zip(k2[2:], pre + (idx, count)))
    assert queues >= 3
