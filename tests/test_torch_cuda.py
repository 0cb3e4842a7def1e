"""The CUDA kernels against their plain versions on the card: K1 (with and
without the learner feed's records), K2 and K1's cost probes (K1-null, P1
null copy, P2 op chain, P3 step prefix); and the feed, CUDA against CPU.

Marked ``cuda``: skipped where torch sees no GPU. On the machine with the
card: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu_torch import stream as S
from eldorado_tpu_torch.core import engine as TE
from eldorado_tpu_torch.ops import probes as P
from eldorado_tpu_torch.ops import step_kernel as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("mask_src,gate_dead",
                         [("storage", False), ("sel", False),
                          ("storage", True)])
def test_fused_step_equals_plain(dev, mask_src, gate_dead):
    s = et.vec_reset(9, 256, 2, 1, 0, 10, device=dev)
    carry = TE.pack_dyn(TE.split_state(s)[1])
    st = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    r = et.sampler_init(4, 256, device=dev)
    outs = []
    for fn in (K.fused_step, K.fused_step_plain):
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        outs.append(fn(carry, r, *st, 100, mask_src, gate_dead, dead)
                    + (dead,))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][3]) > 0   # max_steps=10: envs finish and dead-step


@pytest.mark.parametrize("mask_src,gate_dead",
                         [("storage", False), ("sel", False),
                          ("storage", True)])
def test_fused_step_records_equal_plain(dev, mask_src, gate_dead):
    """K1's compact and full records == the plain version's, and the
    carry, srng, actions and dead steps are those of K1 without records."""
    T, n = 100, 256
    s = et.vec_reset(9, n, 2, 1, 0, 10, device=dev)
    args = (TE.pack_dyn(TE.split_state(s)[1]), et.sampler_init(4, n,
                                                               device=dev),
            s.map_ids, s.min_xy, s.n_players, s.max_steps, T, mask_src,
            gate_dead)
    dead = torch.zeros(1, dtype=torch.int64, device=dev)
    want = K.fused_step(*args, dead) + (dead,)
    plain = torch.zeros((T, n, S.RECORD_WORDS_FULL), dtype=torch.int32,
                        device=dev)
    K.fused_step_plain(*args, record="full", records=plain)
    for record, words in S.RECORD_WIDTH.items():
        recs = torch.full((T, n, words), -1, dtype=torch.int32, device=dev)
        dead = torch.zeros(1, dtype=torch.int64, device=dev)
        got = K.fused_step(*args, dead, record=record, records=recs)
        assert torch.equal(recs, plain[..., :words]), record
        for a, b in zip(got + (dead,), want):
            assert torch.equal(a, b), record
    if mask_src == "storage":   # envs ended, so the dead-step records ran
        assert bool(((plain[..., 0] >> 25) & 1).any())


def test_stream_cuda_equals_cpu(dev):
    """stream_rollout(record="full") over the ring, and on-device
    delivery, at 64 envs with mid-run resets: records, keyframes,
    episodes, final states and the stats carry equal on both devices."""
    outs = []
    for d in (dev, torch.device("cpu")):
        blocks = []
        s = et.vec_reset(5, 64, 4, 1, 0, 30, device=d)
        r = et.sampler_init(11, 64, device=d)
        ring = S.stream_rollout(s, r, 200, 50, steps_per_push=25,
                                record="full",
                                consume=lambda b: blocks.append(b.copy()))
        device = S.stream_rollout(s, r, 200, 50, deliver="device")
        outs.append((ring, np.concatenate(blocks), device))
    ((sa, ra, ea, ca), reca, da), ((sb, rb, eb, cb), recb, db) = outs
    assert np.array_equal(reca, recb) and ea == eb > 0
    assert [k for k, _ in ca.keyframes] == [k for k, _ in cb.keyframes]
    for (_, x), (_, y) in zip(ca.keyframes, cb.keyframes):
        assert np.array_equal(x, y)
    for f in TE.FIELDS:
        assert torch.equal(getattr(sa, f).cpu(), getattr(sb, f)), f
    assert torch.equal(ra.cpu(), rb)
    for x, y in zip(da[3], db[3]):
        assert torch.equal(x.cpu(), y)


def test_fused_reset_equals_plain(dev):
    st = TE.make_state(torch.arange(300, device=dev), 3, 3, 2, 100)
    carry = TE.pack_dyn(TE.split_state(st)[1])
    _, xy, (req, nr, end) = TE.reset_map_prelude(st.rng, st.n_pieces,
                                                 st.difficulty, st.n_players)
    args = (carry, st.n_players, xy, req, nr, end)
    assert torch.equal(K.fused_reset(*args), K.fused_reset_plain(*args))


def test_rollout_cuda_equals_cpu(dev):
    outs = []
    for d in (dev, torch.device("cpu")):
        s = et.vec_reset(5, 16, 4, 1, 0, 30, device=d)
        outs.append(et.rollout_chunked(s, et.sampler_init(11, 16, device=d),
                                       200, 50, exact=True))
    (a, ra, *ca), (b, rb, *cb) = outs
    for f in TE.FIELDS:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert torch.equal(ra.cpu(), rb) and ca == cb and ca[0] > 0


@pytest.fixture
def probe_state(dev):
    """256 envs 50 steps into 2-player games that end at 10 turns: some
    are done, most are not."""
    s = et.vec_reset(9, 256, 2, 1, 0, 10, device=dev)
    static = (s.map_ids, s.min_xy, s.n_players, s.max_steps)
    carry = TE.pack_dyn(TE.split_state(s)[1])
    carry, r, _ = K.fused_step(carry, et.sampler_init(4, 256, device=dev),
                               *static, 50)
    done = TE.unpack_dyn(carry)[TE.DYN_FIELDS.index("done")]
    assert 0 < int(done.sum()) < 256
    return carry, r, static


def test_null_body_equals_plain(dev, probe_state):
    carry, r, static = probe_state
    outs = []
    for fn in (K.fused_step, K.fused_step_plain):
        dead = torch.full((1,), 5, dtype=torch.int64, device=dev)
        outs.append(fn(carry, r, *static, 100, "storage", False, dead,
                       null_body=True) + (dead,))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][0], carry) and torch.equal(outs[0][1], r)
    assert int(outs[0][3]) == 5 and not bool(outs[0][2].any())


def test_null_copy_equals_plain(dev, probe_state):
    carry = probe_state[0]
    for c in (carry, carry[:, :255].contiguous()):   # 16-byte and word path
        assert torch.equal(P.null_copy(c), P.null_copy_plain(c))


@pytest.mark.parametrize("op", P.OPS)
@pytest.mark.parametrize("shape,k", [((8, 64), 64), ((32, 512), 4096)])
def test_op_chain_equals_plain(dev, shape, k, op):
    rng = np.random.default_rng(1)
    x, y = (torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape),
                            dtype=torch.int32, device=dev) for _ in range(2))
    assert torch.equal(P.op_chain(x, y, k, op), P.op_chain_plain(x, y, k, op))


@pytest.mark.parametrize("cut", P.CUTS)
def test_step_prefix_equals_plain(dev, probe_state, cut):
    carry, r, static = probe_state
    assert torch.equal(P.step_prefix(carry, r, *static, 20, cut),
                       P.step_prefix_plain(carry, r, *static, 20, cut))
