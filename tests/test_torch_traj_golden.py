"""The port against the trajectory goldens (tests/golden/traj_*.npz),
tolerance zero.

1. The per-env code the CUDA kernels run: csrc/engine.cuh's
   ``ed::sample_step`` (K1's step) and, after the step that ends a game,
   csrc/mapgen.cuh's ``ed::map_env`` (K3, through the lane shim's loop
   form) then ``ed::reset_body`` (K2), built with g++ around
   tests/traj_host.cpp. It replays all 11 goldens over their full length,
   traj_win_storage's 20,000 steps with its two won games and their reset
   maps included.
2. The port's main path on CPU tensors, which run the kernels' plain
   versions: one `fused_step` launch per step, then `vec._reset_columns`
   on the envs whose game ended. It replays the JAX package's 6
   TRAJ_CASES over their first PREFIX steps, which hold traj_trunc's first
   reset (step 432) and traj_trunc_storage's (step 501).

Each holds the state after the first reset, every compared field of every
step and every reset map in the window, and names the first diverging
field and step (tests/traj_replay.py). The host replay skips only where
g++ is missing.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import traj_replay as TR
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.core import mapgen as MG
from eldorado_tpu_torch.ops import build
from eldorado_tpu_torch.ops.rng import seed
from test_jax_parity import TRAJ_CASES
from test_ref_traj import CASES as REF_CASES

HOST_SOURCE = Path(__file__).with_name("traj_host.cpp")
PREFIX = 520      # the plain path's window, past both truncation resets
MAX_MAPS = 16     # maps kept per host replay (the goldens make at most 5)
_i32 = torch.int32


def test_probe_params_are_the_reference_replays():
    """traj_replay's mask source and turn limit per golden are those of
    tests/test_ref_traj.py and tests/test_jax_parity.py."""
    ref = {p.values[0]: tuple(p.values[1:3]) for p in REF_CASES}
    assert set(ref) == set(TR.NAMES)
    for name, want in ref.items():
        assert TR.probe_params(name) == want, name
    for name, mask_src, max_steps, _, _ in TRAJ_CASES:
        assert TR.probe_params(name) == (mask_src, max_steps), name


@pytest.fixture(scope="module")
def host_traj(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernels' code "
                    "needs it")
    so = tmp_path_factory.mktemp("traj_host") / "libtraj_host.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         f"-I{build.CSRC}", "-o", str(so), str(HOST_SOURCE)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    fn = ctypes.CDLL(str(so)).ed_host_traj
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int]
    fn.restype = ctypes.c_int
    ovl = torch.as_tensor(MG._build_pair_overlap()).to(_i32)

    def run(name, steps):
        """The probe loop of golden ``name`` over ``steps`` steps."""
        es, ss, n_players, n_pieces, diff, _ = TR.header(TR.load(name))
        mask_src, max_steps = TR.probe_params(name)
        st = E.make_state([es], n_players, n_pieces, diff, max_steps,
                          device="cpu")
        carry0 = E.pack_dyn(E.split_state(st)[1])[:, 0].contiguous()
        states = torch.empty((steps + 1, E.CARRY_WORDS), dtype=_i32)
        actions = torch.empty((steps, 5), dtype=_i32)
        done = torch.empty(steps, dtype=_i32)
        maps = torch.empty((MAX_MAPS, E.GRIDSIZE ** 2), dtype=_i32)
        map_steps = torch.empty(MAX_MAPS, dtype=_i32)
        n_maps = fn(carry0.data_ptr(), int(seed(ss, device="cpu")),
                    n_players, n_pieces, diff, max_steps, int(not mask_src),
                    ovl.data_ptr(), steps, states.data_ptr(),
                    actions.data_ptr(), done.data_ptr(), maps.data_ptr(),
                    map_steps.data_ptr(), MAX_MAPS)
        assert n_maps > 0, f"{name}: a map generation failed"
        kept = min(n_maps, MAX_MAPS)
        return TR.Trajectory(states, actions, done != 0, dict(
            zip(map_steps[:kept].tolist(), maps[:kept])))
    return run


@pytest.mark.parametrize("name", TR.NAMES)
def test_host_kernel_code_replays_golden(host_traj, name):
    d = TR.load(name)
    steps = TR.header(d)[-1]
    traj = host_traj(name, steps)
    TR.check(name, d, traj, steps)
    if name == "traj_win_storage":   # both won games and their maps
        won = np.nonzero(d["done"] & (d["rewards"].max(axis=1) > 0))[0]
        assert len(won) == 2 and set(won) <= set(traj.maps)


@pytest.fixture(scope="module")
def plain_replays():
    """The 6 TRAJ_CASES through the port's main path on the CPU, PREFIX
    steps: one batch for each mask source."""
    out = {}
    for mask_src in (0, 1):
        names = [c[0] for c in TRAJ_CASES if c[1] == mask_src]
        out.update(zip(names, TR.replay(names, PREFIX, "cpu")))
    return out


@pytest.mark.parametrize("name,mask_src,max_steps,limit,with_map",
                         TRAJ_CASES)
def test_plain_path_replays_golden(plain_replays, name, mask_src, max_steps,
                                   limit, with_map):
    d = TR.load(name)
    TR.check(name, d, plain_replays[name], PREFIX)
    if name.startswith("traj_trunc"):   # a reset inside the window
        assert any(0 <= t < PREFIX for t in plain_replays[name].maps)
