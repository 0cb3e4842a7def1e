"""The port's learner feed against the JAX package's, at tolerance zero:
K1's plain records against the JAX XLA rollout's per-step surface, and
`stream_rollout` (compact and full records, reset keyframes, the
ObsReconstructor mirror, exact mode, on-device delivery, the compressed
ring) against the JAX `stream_rollout` with its Pallas kernel in interpret
mode. Seeds and settings are those of tests/test_stream*.py.

Each JAX interpret-mode rollout costs ~15 s, mostly compilation, so each
runs once, in a module-scoped fixture, and the tests share them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu import stream as JS
from eldorado_tpu import vec as JV
from eldorado_tpu.core import engine as JE
from eldorado_tpu_torch import convert
from eldorado_tpu_torch import stream as S
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.ops import step_kernel as K

N = 8


def assert_states_equal(ours, theirs):
    got = convert.state_to_numpy(ours)
    for f in JE.EnvState._fields:
        assert np.array_equal(got[f], np.asarray(getattr(theirs, f))), f


def collect(out):
    return out, lambda r: out.append(r.copy())


def jax_stream(reset, T, chunk, spp, **kw):
    blocks, fn = collect([])
    out = JS.stream_rollout(JV.vec_reset(*reset), JV.sampler_init(11, N), T,
                            chunk=chunk, block=N, interpret=True,
                            steps_per_push=spp, consume=fn, **kw)
    return out, np.concatenate(blocks)


def our_stream(reset, T, chunk, spp, **kw):
    blocks, fn = collect([])
    out = S.stream_rollout(et.vec_reset(*reset), et.sampler_init(11, N), T,
                           chunk=chunk, steps_per_push=spp, consume=fn, **kw)
    return out, np.concatenate(blocks)


# reset-free (test_stream.py), with resets and full records
# (test_stream_full.py), exact mode with resets (test_stream.py)
COMPACT = dict(reset=(5, N, 4, 3, 0, 100000), T=80, chunk=40, spp=20)
FULL = dict(reset=(5, N, 4, 1, 0, 60), T=240, chunk=40, spp=40,
            record="full")
EXACT = dict(reset=(5, N, 4, 1, 0, 30), T=200, chunk=50, spp=25, exact=True)


@pytest.fixture(scope="module")
def jax_compact():
    return jax_stream(**COMPACT)


@pytest.fixture(scope="module")
def jax_full():
    return jax_stream(**FULL)


@pytest.fixture(scope="module")
def jax_exact():
    return jax_stream(**EXACT)


@pytest.fixture(scope="module")
def our_full():
    return our_stream(**FULL)


# ------------------------------------------- K1's plain records vs XLA
@pytest.mark.parametrize("mask_src", ["storage", "sel"])
def test_plain_records_equal_xla_surface(mask_src):
    """fused_step_plain's compact records == vec.rollout(..., "none")'s
    per-step surface packed with pack_step_blocked (nb = 1), at every
    step; 2-player games that end at 10 turns, so with the storage mask
    done envs dead-step (the sel mask never moves, so never ends)."""
    T = 40
    js = JV.vec_reset(9, N, 2, 1, 0, 10)
    _, _, traj = JV.rollout(js, JV.sampler_init(4, N), T, mask_src, "none")
    act, done, rew, agent, sel, res, phase = traj

    def blk(x):   # (T, n, f...) -> (T, 1, f, n)
        x = jnp.asarray(x)
        x = x[..., None] if x.ndim == 2 else x
        return jnp.moveaxis(x, 1, -1)[:, None]

    want = jax.vmap(JS.pack_step_blocked)(
        blk(act), blk(done.astype(jnp.int32)), blk(rew), blk(agent),
        blk(sel), blk(res), blk(phase))
    want = np.moveaxis(np.asarray(want)[:, 0], -1, 1)       # (T, n, 5)

    s = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in JE.EnvState._fields})
    recs = torch.zeros((T, N, S.RECORD_WORDS), dtype=torch.int32)
    K.fused_step(E.pack_dyn(E.split_state(s)[1]), et.sampler_init(4, N),
                 s.map_ids, s.min_xy, s.n_players, s.max_steps, T, mask_src,
                 record="compact", records=recs)
    assert np.array_equal(recs.numpy(), want)
    assert (want[..., 0] >> 25 & 1).any() == (mask_src == "storage")


def test_full_records_equal_xla_replay():
    """fused_step_plain's full records: words 0-4 == its compact records,
    and every word == pack_step_full_blocked of an XLA replay of the
    recorded actions (jax vmap(step_env)), at every step."""
    T = 40
    s = et.vec_reset(9, N, 2, 1, 0, 10)
    args = (E.pack_dyn(E.split_state(s)[1]), et.sampler_init(3, N),
            s.map_ids, s.min_xy, s.n_players, s.max_steps, T)
    full = torch.zeros((T, N, S.RECORD_WORDS_FULL), dtype=torch.int32)
    comp = torch.zeros((T, N, S.RECORD_WORDS), dtype=torch.int32)
    K.fused_step(*args, record="full", records=full)
    K.fused_step(*args, record="compact", records=comp)
    full, comp = full.numpy(), comp.numpy()
    assert np.array_equal(full[..., :S.RECORD_WORDS], comp)

    vstep = jax.jit(jax.vmap(JE.step_env))
    truth = JV.vec_reset(9, N, 2, 1, 0, 10)
    acts = S.unpack_records(full)["actions"].astype(np.int32)

    def blk(x):
        x = jnp.asarray(x)
        return jnp.moveaxis(x[..., None] if x.ndim == 1 else x, 0, -1)[None]

    for t in range(T):
        p_pre = truth.agent
        truth = vstep(truth, acts[t])
        base = JS.pack_step_blocked(
            blk(acts[t]), blk(truth.done.astype(jnp.int32)),
            blk(truth.rewards), blk(truth.agent), blk(truth.sel_mask),
            blk(truth.resources), blk(truth.phase))
        want = JS.pack_step_full_blocked(
            base, blk(truth.piles), blk(truth.shop_stock),
            blk(truth.storage_masks), blk(truth.resources), blk(p_pre),
            blk(truth.agent))
        assert np.array_equal(full[t], np.moveaxis(np.asarray(want)[0], -1,
                                                   0)), t


# ------------------------------------------------------ stream_rollout
def test_stream_compact_equals_jax(jax_compact):
    (js, jr, jeps, jcons), jrec = jax_compact
    (s, r, eps, cons), rec = our_stream(**COMPACT)
    assert rec.shape == (COMPACT["T"], N, S.RECORD_WORDS)
    assert np.array_equal(rec, jrec)
    assert eps == jeps == 0 and cons.records == jcons.records == N * 80
    assert cons.checksum == jcons.checksum
    assert_states_equal(s, js)
    assert np.array_equal(r.numpy(), np.asarray(jr))


def test_stream_full_equals_jax(jax_full, our_full):
    """Full records with mid-run resets: records, episodes, final states
    and the keyframes (header and valid slots; padding slots differ)."""
    (js, jr, jeps, jcons), jrec = jax_full
    (s, r, eps, cons), rec = our_full
    assert rec.shape == (FULL["T"], N, S.RECORD_WORDS_FULL)
    assert np.array_equal(rec, jrec)
    assert eps == jeps > 0
    assert_states_equal(s, js)
    assert cons.q_cap == jcons.q_cap == N
    assert [f[0] for f in cons.feat] == [f[0] for f in jcons.feat]
    assert [k for k, _ in cons.keyframes] == [k for k, _ in jcons.keyframes]
    assert cons.keyframes
    for (_, ours), (_, theirs) in zip(cons.keyframes, jcons.keyframes):
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
        a = S.parse_reset_buffer(ours, cons.q_cap, N)
        b = JS.parse_reset_buffer(theirs, jcons.feat, jcons.q_cap, N)
        v = a["valid"]
        assert np.array_equal(a["idxs"], b["idxs"]) and v.any()
        assert (a["ok"], a["overflow"]) == (b["ok"], b["overflow"])
        assert np.array_equal(a["min_xy"][v], b["min_xy"][v])
        assert np.array_equal(a["map_ids"][v], b["map_ids"][v])
        for f in b["dyn"]:
            assert a["dyn"][f].dtype == b["dyn"][f].dtype, f
            assert np.array_equal(a["dyn"][f][v], b["dyn"][f][v]), f


def test_obs_reconstructor_equals_jax(jax_full, our_full):
    """The port's mirror, driven by the port's feed, equals JAX's mirror,
    driven by JAX's feed, on every field at every step and after every
    keyframe; the final ObsData surfaces are equal too."""
    (_, _, _, jcons), jrec = jax_full
    (_, _, _, cons), rec = our_full
    ours = S.ObsReconstructor(et.vec_reset(*FULL["reset"]), cons.q_cap)
    theirs = JS.ObsReconstructor(JV.vec_reset(*FULL["reset"]), jcons.feat,
                                 jcons.q_cap)
    names = ("piles", "shop", "storage", "sel", "map_ids", "min_xy",
             "agent", "phase", "resources", "done")

    def same(at):
        for f in names:
            a, b = getattr(ours, f), getattr(theirs, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (f, at)

    kf, jkf = dict(cons.keyframes), dict(jcons.keyframes)
    chunk = FULL["chunk"]
    for t in range(FULL["T"]):
        ours.apply_step(rec[t])
        theirs.apply_step(jrec[t])
        same(t)
        ci = t // chunk
        if t % chunk == chunk - 1 and ci in kf:
            ours.apply_reset(kf[ci])
            theirs.apply_reset(jkf[ci])
            same((ci, "reset"))
    a, b = ours.observations(), theirs.observations()
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], np.asarray(b[k])), k


def test_stream_exact_equals_jax(jax_exact):
    (js, jr, jeps, jcons, jdead), jrec = jax_exact
    (s, r, eps, cons, dead), rec = our_stream(**EXACT)
    assert np.array_equal(rec, jrec)
    assert (eps, dead) == (jeps, jdead) and eps > 0 and dead > 0
    assert_states_equal(s, js)


def test_device_delivery_equals_jax_stats(jax_compact):
    """deliver="device": the stats carry folded over the port's records
    == JAX's device_stats_fn over JAX's records (as (T, 1, 5, n))."""
    _, jrec = jax_compact
    s, r, eps, carry = S.stream_rollout(
        et.vec_reset(*COMPACT["reset"]), et.sampler_init(11, N),
        COMPACT["T"], COMPACT["chunk"], deliver="device")
    want = JS.device_stats_fn(JS.device_stats_init(),
                              jnp.moveaxis(jnp.asarray(jrec), 1, -1)[:, None])
    for ours, theirs in zip(carry, want):
        assert ours.numpy().dtype == np.asarray(theirs).dtype
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
    assert int(carry[0]) == N * COMPACT["T"]


@pytest.mark.parametrize("mode", ["sync", "exact"])
def test_compressed_ring_equals_jax(mode, jax_full, jax_exact):
    """compress=True delivers, decompressed, JAX's compact records: over
    FULL's resets (JAX's full records, words 0-4) and in exact mode."""
    if mode == "exact":
        kw, (_, jrec) = dict(EXACT), jax_exact
    else:
        kw, (_, jrec) = dict(FULL, record="compact"), jax_full
    out, rec = our_stream(**kw, compress=True)
    cons = out[3]
    assert np.array_equal(rec, jrec[..., :S.RECORD_WORDS])
    assert cons.records == rec.shape[0] * N
    assert 0 < cons.tunnel_bytes < rec.nbytes
