"""csrc/engine.cuh on the host, against the plain torch K1, tolerance zero.

K1's per-env work (``ed::run_steps``: ``ed::sample_step`` and the record
packer, on an env staged into its padded ``EnvSlot``) is built with g++
around tests/engine_host.cpp and run on the CPU, so every edit to the
engine's logic or to the slot layout is held to
`step_kernel.fused_step_plain` here, before the card sees it. 64 envs with
mixed players, pieces and difficulties, taken mid-game by 1500 host steps
(so that bought cards and their specials are in play), x 200 steps in
which half of them reach their turn limit, with the storage mask, the sel
mask, and gate_dead (every 7th env done at entry): the carry, srng, last
actions, dead steps and full records are equal word for word. Skips only
where g++ is missing.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu_torch import stream as S
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.ops import build
from eldorado_tpu_torch.ops import step_kernel as K

DRIVER = Path(__file__).with_name("engine_host.cpp")
N, T, WARM = 64, 200, 1500
_OFF = {f: off for f, _, _, off, _ in E.DYN_LAYOUT}


@pytest.fixture(scope="module")
def host_step(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of engine.cuh needs it")
    so = tmp_path_factory.mktemp("engine_host") / "libengine_host.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{build.CSRC}", "-o", str(so), str(DRIVER)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    fn = ctypes.CDLL(str(so)).ed_host_fused_step
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def start(host_step):
    """64 envs of mixed parameters, reset on the CPU and stepped WARM
    times on the host (a few games end there by a win and dead-step from
    then on); then every odd env's turn limit is set a few turns ahead,
    so that it ends inside the compared window."""
    i = np.arange(N)
    s = et.vec_reset_varied(1000 + i, 2 + i % 3, 1 + i % 3, i % 2, 100000,
                            device="cpu")
    static = (s.map_ids, s.min_xy, s.n_players, s.max_steps.clone())
    carry, _, _, _, _ = run_host(host_step, E.pack_dyn(E.split_state(s)[1]),
                                 et.sampler_init(7, N, device="cpu"), static,
                                 WARM, "storage", False, record_words=0)
    turns = carry[_OFF["turn_counter"]]
    static[3][1::2] = turns[1::2] + 2 + torch.arange(N // 2) % 5
    return carry, static


def run_host(host_step, carry, srng, static, n_steps, mask_src, gate_dead,
             record_words=S.RECORD_WORDS_FULL):
    n = carry.shape[1]
    out, srng_out = torch.empty_like(carry), torch.empty_like(srng)
    act = torch.zeros((n, 5), dtype=torch.int32)
    dead = torch.zeros(1, dtype=torch.int64)
    rec = torch.full((n_steps, n, record_words), -1, dtype=torch.int32)
    err = host_step(carry.data_ptr(), out.data_ptr(), srng.data_ptr(),
                    srng_out.data_ptr(), *(t.data_ptr() for t in static),
                    act.data_ptr(), dead.data_ptr(), rec.data_ptr(), n,
                    n_steps, mask_src == "sel", int(gate_dead),
                    record_words)
    assert err == 0
    return out, srng_out, act, dead, rec


@pytest.mark.parametrize("mask_src,gate_dead", [
    ("storage", False), ("sel", False), ("storage", True)])
def test_engine_host_equals_plain(host_step, start, mask_src, gate_dead):
    carry, static = start
    carry = carry.clone()
    if gate_dead:
        carry[_OFF["done"], ::7] = 1
    srng = et.sampler_init(42, N, device="cpu")
    got = run_host(host_step, carry, srng, static, T, mask_src, gate_dead)
    dead = torch.zeros(1, dtype=torch.int64)
    rec = torch.empty((T, N, S.RECORD_WORDS_FULL), dtype=torch.int32)
    c, r, a = K.fused_step_plain(carry, srng, *static, T, mask_src,
                                 gate_dead, dead, record="full", records=rec)
    for name, x, y in (("carry", got[0], c), ("srng", got[1], r),
                       ("actions", got[2], a), ("dead", got[3], dead),
                       ("records", got[4], rec)):
        assert torch.equal(x, y), name
    fields = dict(zip(E.DYN_FIELDS, E.unpack_dyn(c)))
    assert bool(fields["done"][1::7].any())   # envs ended inside the run
    if gate_dead:
        assert int(dead) >= len(range(0, N, 7)) * T
