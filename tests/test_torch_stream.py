"""The port's learner-feed pieces that need no rollout, against the JAX
package at tolerance zero: record packing and unpacking, the compressed
chunk, the native ring and its loader, the numpy map expansion, the
refusals (a failing compiler, compression with on-device delivery), and
the consumer thread's stop, which must not drop the last block.

Inputs are made from a numpy seed and handed to both packages; the JAX
functions take the blocked (nb, f, block) layout, here with nb = 1."""
import stat
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu import stream as JS
from eldorado_tpu.core import cells as JC
from eldorado_tpu_torch import native
from eldorado_tpu_torch import stream as S
from eldorado_tpu_torch.core import cells as C
from eldorado_tpu_torch.ops import build

N = 64


def blocked(x):
    """(n, f...) -> the JAX kernel's (1, f..., n) layout with nb = 1."""
    x = np.asarray(x)
    return jnp.asarray(np.moveaxis(x.reshape((1,) + x.shape), 1, -1))


def env_major(x):
    """(1, f, n) -> (n, f)."""
    return np.moveaxis(np.asarray(x)[0], -1, 0)


@pytest.fixture(scope="module")
def fields():
    """Post-step fields over the whole domain the packers clamp or wrap:
    wrapped u8 pile counts (255 = -1), negative rewards, shop stock above
    3 (and 255), resources past every clamp, half-integer rounding."""
    g = np.random.default_rng(7)
    res = np.stack([g.integers(-2, 40, N) + g.choice([0, .5], N),
                    g.integers(-2, 40, N) + g.choice([0, .5], N),
                    g.integers(-4, 2200, N) * 0.5 + g.choice([0, .25], N)],
                   axis=-1).astype(np.float32)
    res[:4] = [[2.5, 3.5, 0.25], [0.5, 1.5, 0.75], [31.5, 32.5, 2047.75],
               [-0.5, 7.5, 511.75]]
    return {
        "act": g.integers(0, 22, (N, 5)).astype(np.int32),
        "done": g.integers(0, 2, N).astype(bool),
        "rew": g.integers(-4, 5, (N, 4)).astype(np.float32),
        "agent": g.integers(0, 4, N).astype(np.int32),
        "p_pre": g.integers(0, 4, N).astype(np.int32),
        "sel": g.integers(-2 ** 31, 2 ** 31, (N, 3)).astype(np.int32),
        "res": res,
        "phase": g.integers(0, 3, N).astype(np.int32),
        "piles": g.choice([0, 1, 2, 3, 4, 254, 255],
                          (N, 4, 5, 21)).astype(np.int32),
        "shop": g.choice([0, 1, 2, 3, 4, 255], (N, 18),
                         p=[.2, .2, .2, .3, .05, .05]).astype(np.int32),
        "storage": g.integers(-2 ** 31, 2 ** 31, (N, 4, 3)).astype(np.int32),
    }


def ours_compact(f):
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    return S.pack_step(t["act"], t["done"], t["rew"], t["agent"], t["sel"],
                       t["res"], t["phase"])


def theirs_compact(f):
    return JS.pack_step_blocked(
        blocked(f["act"]), blocked(f["done"][:, None].astype(np.int32)),
        blocked(f["rew"]), blocked(f["agent"][:, None]), blocked(f["sel"]),
        blocked(f["res"]), blocked(f["phase"][:, None]))


def test_pack_step_equals_jax(fields):
    ours = ours_compact(fields).numpy()
    assert ours.shape == (N, S.RECORD_WORDS) and ours.dtype == np.int32
    assert np.array_equal(ours, env_major(theirs_compact(fields)))


def test_pack_step_full_equals_jax(fields):
    f = fields
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    ours = S.pack_step_full(ours_compact(f), t["piles"], t["shop"],
                            t["storage"], t["res"], t["p_pre"],
                            t["agent"]).numpy()
    theirs = JS.pack_step_full_blocked(
        theirs_compact(f), blocked(f["piles"]), blocked(f["shop"]),
        blocked(f["storage"]), blocked(f["res"]),
        blocked(f["p_pre"][:, None]), blocked(f["agent"][:, None]))
    assert ours.shape == (N, S.RECORD_WORDS_FULL)
    assert np.array_equal(ours, env_major(theirs))
    d = S.unpack_full(ours)   # the wrapped and overflowing cases occurred
    assert d["shop_overflow"].any() and d["res_overflow"].any()
    assert (d["actor_piles"] == 255).any()


@pytest.mark.parametrize("words", [S.RECORD_WORDS, S.RECORD_WORDS_FULL])
def test_unpack_equals_jax(words):
    buf = np.random.default_rng(words).integers(
        -2 ** 31, 2 ** 31, (3, N, words)).astype(np.int32)
    unpack = S.unpack_records if words == S.RECORD_WORDS else S.unpack_full
    junpack = (JS.unpack_records if words == S.RECORD_WORDS
               else JS.unpack_full)
    ours, theirs = unpack(buf), junpack(buf)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        assert np.array_equal(ours[k], theirs[k]), k


def redundant_records(seed, T, n):
    """Records that change like the feed's: word0 every step, words 1..4
    now and then. Word0 keeps to its legal fields (the move head is 3-bit,
    bits 30-31 are unused), which is all the header carries."""
    g = np.random.default_rng(seed)
    rec = g.integers(-2 ** 31, 2 ** 31, (T, n, 5)).astype(np.int32)
    rec[..., 0] &= 0x3FF3FFFF
    keep = g.random((T, n, 4)) < 0.7
    for t in range(1, T):
        rec[t, :, 1:] = np.where(keep[t], rec[t - 1, :, 1:], rec[t, :, 1:])
    return rec


def test_compress_chunk_equals_jax():
    T, n = 30, 16
    prev = np.zeros((n, 4), np.int32)
    for seed in range(3):      # a carried prev across chunks
        rec = redundant_records(seed, T, n)
        ours = S.compress_chunk(torch.as_tensor(rec), torch.as_tensor(prev))
        theirs = JS.compress_chunk(jnp.asarray(rec), jnp.asarray(prev))
        hdr, pay, used, nprev = (x.numpy() for x in ours)
        used = int(used)
        assert used == int(theirs[2]) and 0 < used < T * n * 4
        assert np.array_equal(hdr, np.asarray(theirs[0]))
        assert np.array_equal(pay[:used], np.asarray(theirs[1])[:used])
        assert np.array_equal(nprev, np.asarray(theirs[3]))
        back, hprev = S.decompress_chunk(hdr, pay[:used], prev)
        assert np.array_equal(back, rec)
        assert np.array_equal(hprev, nprev)
        prev = nprev


def test_native_ring_push_pop():
    lib_path = native.build(build.BUILD_DIR)
    assert lib_path.parent == build.BUILD_DIR
    ring = native.TrajectoryRing(4 * 6, capacity=2)
    a = np.arange(6, dtype=np.int32)
    assert ring.pop() is None and len(ring) == 0
    assert ring.push(a) and ring.push(a + 10)
    assert not ring.push(a + 20)          # full at capacity
    assert len(ring) == 2
    assert np.array_equal(ring.pop().view(np.int32), a)
    assert np.array_equal(ring.pop().view(np.int32), a + 10)
    assert ring.pop() is None
    with pytest.raises(ValueError):
        ring.push(np.zeros(5, np.int32))


def test_pack_obs_equals_jax():
    from eldorado_tpu import native as JN
    g = np.random.default_rng(3)
    args = (g.integers(0, 6, (2, 48, 48, 7)), g.integers(0, 3, 2),
            g.random((2, 3)), g.integers(0, 4, (2, 18)),
            g.integers(0, 256, (2, 4, 5, 21)),
            g.integers(0, 2, (2, 4, 92)).astype(bool))
    ours = native.pack_obs(*args)
    assert ours.shape == (2, 16947)
    assert np.array_equal(ours, JN.pack_obs(*args))


@pytest.fixture
def failing_cxx(tmp_path):
    """A compiler that reports its version and fails every compile."""
    path = tmp_path / "g++"
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "if '--version' in sys.argv:\n"
        "    print('fake g++ 0.0')\n"
        "    sys.exit(0)\n"
        "print('obs_abi.cpp:1: error: no toolchain here', file=sys.stderr)\n"
        "sys.exit(1)\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_ring_loader_raises_on_failing_compiler(tmp_path, failing_cxx,
                                                monkeypatch):
    with pytest.raises(RuntimeError, match="no toolchain here"):
        native.build(tmp_path / "out", failing_cxx)
    assert list((tmp_path / "out").iterdir()) == []   # nothing half-written
    # the ring asked for through the loader raises too: no fallback
    monkeypatch.setenv("CXX", failing_cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out2")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no toolchain here"):
            native.TrajectoryRing(16, 4)
    finally:
        native.load.cache_clear()


def test_device_delivery_refuses_compress():
    s = et.vec_reset(5, 8, 4, 1, 0, 30, device="cpu")
    with pytest.raises(ValueError, match="compress"):
        S.stream_rollout(s, et.sampler_init(11, 8, device="cpu"), 40, 40,
                         deliver="device", compress=True)


@pytest.mark.parametrize("n_steps", [40, 400])
def test_failing_consumer_raises(n_steps):
    """A consumer that raises stops the feed with its error, whether the
    ring still has room (40 steps) or fills up behind it (400 steps,
    an 8-slot ring), instead of leaving the producer waiting."""
    def consume(rec):
        raise KeyError("consumer bug")

    s = et.vec_reset(5, 8, 4, 1, 0, 100000, device="cpu")
    with pytest.raises(RuntimeError, match="consumer") as info:
        S.stream_rollout(s, et.sampler_init(11, 8, device="cpu"), n_steps, 40,
                         steps_per_push=20, consume=consume)
    assert isinstance(info.value.__cause__, KeyError)


def test_consumer_takes_the_last_block_pushed_before_the_stop():
    """The producer pushes its last block and stops the consumer between
    the consumer's finding the ring empty and its reading the stop flag:
    the consumer still takes the block before it returns."""
    block = np.arange(2 * 3 * 5, dtype=np.int32).view(np.uint8)

    class Ring:   # empty at the first pop, then the last block arrives
        def __init__(self):
            self.pops, self.left = 0, [block]

        def pop(self):
            self.pops += 1
            if self.pops == 1:
                consumer._stopping.set()   # the push and the stop, here
                return None
            return self.left.pop() if self.left else None

    got = []
    consumer = S.RingConsumer(Ring(), 2, 3, got.append, record_words=5)
    consumer.start()
    consumer.finish()
    assert len(got) == 1 and consumer.records == 2 * 3
    assert np.array_equal(got[0].reshape(-1), block.view(np.int32))


def test_expand_obs_np_equals_jax():
    ids = np.random.default_rng(2).integers(0, C.N_CELL_TYPES, (3, 2304))
    ours = C.expand_obs_np(ids)
    assert ours.dtype == np.uint8
    assert np.array_equal(ours, JC.expand_obs_np(ids))
    assert np.array_equal(ours, C.expand_obs(torch.as_tensor(ids)).numpy())


def test_import_stream_without_jax():
    code = ("import sys, eldorado_tpu_torch.stream, eldorado_tpu_torch.native;"
            " sys.exit('jax' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code],
                          cwd=build.BUILD_DIR.parents[1]).returncode == 0
