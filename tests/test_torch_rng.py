"""The port's RNG (eldorado_tpu_torch.ops.rng) is the libstdc++ stream.

Held against the golden streams of tests/golden/rng_streams.bin (as
tests/test_rng_parity.py holds the JAX package) and against
eldorado_tpu.ops.rng on numpy-seeded states, tolerance zero.
"""
import jax
import numpy as np
import pytest
import torch

from eldorado_tpu.ops import rng as JR
from eldorado_tpu_torch.ops import rng as TR
from test_rng_parity import GOLDEN


@pytest.fixture(scope="module")
def streams():
    raw = np.fromfile(GOLDEN, dtype=np.uint32)
    n_seeds, n_raw, n_ranges, n_draws = (int(v) for v in raw[:4])
    off = 4
    seeds, raws = [], []
    for _ in range(n_seeds):
        seeds.append(int(raw[off]))
        raws.append(raw[off + 1:off + 1 + n_raw])
        off += 1 + n_raw
    ranges = [1, 2, 3, 4, 5, 6, 7, 8, 16, 21, 22, 23, 37, 100, 504, 65536,
              2147483645]
    assert len(ranges) == n_ranges
    uniforms = {}
    for s in seeds:
        for r in ranges:
            uniforms[(s, r)] = raw[off:off + n_draws]
            off += n_draws
    return seeds, raws, ranges, uniforms, n_draws


def test_raw_engine_stream(streams):
    seeds, raws, _, _, _ = streams
    x = TR.seed(torch.tensor(seeds, dtype=torch.int64), device="cpu")
    got = []
    for _ in range(raws[0].shape[0]):
        x = TR.next_u31(x)
        got.append(x)
    got = torch.stack(got, 1).numpy().astype(np.uint32)
    assert np.array_equal(got, np.stack(raws))


def test_uniform_int_streams(streams):
    """The exact rejection form, every (seed, range) lane at once."""
    seeds, _, ranges, uniforms, n_draws = streams
    ss = [s for s in seeds for _ in ranges]
    rr = torch.tensor([r for _ in seeds for r in ranges], dtype=torch.int64)
    x = TR.seed(torch.tensor(ss, dtype=torch.int64), device="cpu")
    out = []
    for _ in range(n_draws):
        v, x = TR.uniform_int(x, rr)
        out.append(v)
    got = torch.stack(out, 1).numpy().astype(np.uint32)
    want = np.stack([uniforms[(s, int(r))] for s, r in zip(ss, rr)])
    assert np.array_equal(got, want)


def _states(n=10_000):
    """numpy-seeded engine states in [1, M-1], half of them above 2^30
    so that 16807 * x wraps past 2^31 and 2^32 in next_u31."""
    rs = np.random.RandomState(0)
    x = rs.randint(1, TR.M, size=n, dtype=np.int64)
    x[: n // 2] = rs.randint(1 << 30, TR.M, size=n // 2, dtype=np.int64)
    x[:4] = (1, TR.M - 1, 1 << 30, (1 << 31) - 2)
    return x.astype(np.int32)


def test_next_and_seed_equal_jax():
    x = _states()
    assert np.array_equal(TR.next_u31(torch.from_numpy(x)).numpy(),
                          np.asarray(JR.next_u31(x)))
    seeds = np.random.RandomState(1).randint(0, 1 << 32, size=10_000,
                                             dtype=np.int64)
    seeds[:3] = (0, TR.M, (1 << 32) - 1)
    assert np.array_equal(TR.seed(torch.from_numpy(seeds),
                                  device="cpu").numpy(),
                          np.asarray(JR.seed(seeds.astype(np.uint32))))


def test_uniform_forms_equal_jax():
    x = _states()
    rs = np.random.RandomState(2)
    n = rs.randint(-3, 300, size=x.shape[0]).astype(np.int32)
    n[:10] = np.arange(1, 11)
    n[10] = 2147483645
    do = rs.rand(x.shape[0]) < 0.7
    xt, nt, dt = (torch.from_numpy(a) for a in (x, np.maximum(n, 1), do))
    for got, want in (
            (TR.uniform_int_fast(xt, nt), JR.uniform_int_fast(x, np.maximum(n, 1))),
            (TR.uniform_int_fast_maybe(xt, torch.from_numpy(n), dt),
             JR.uniform_int_fast_maybe(x, n, do)),
            (TR.uniform_int_maybe(xt, torch.from_numpy(n), dt),
             jax.vmap(JR.uniform_int_maybe)(x, n, do))):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
