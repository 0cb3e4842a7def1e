"""csrc/mapgen.cuh on the host, tolerance zero: K3's logic before the card.

K3's per-env work (``ed::map_env``: the generator, the raster, the start
positions and the prelude's add_players gate and ball rows) is built with
g++ around tests/mapgen_host.cpp, with ed_generate_map's arguments, and
run on the CPU through the lane shim's loop form (``ed::LoopLanes``: one
thread runs the 32 lanes of each of the warp's cooperative steps, the
candidate scan's ballots, the bounding-box reductions, the raster and the
ball cells, in lane order), so the code K3's warps run is what is held. It is held to `mapgen.generate_map_plain` plus the plain
prelude (`engine.reset_map_prelude` on CPU tensors), with each env's
generator trips and retries, on a mixed batch
(`mapgen.mixed_batch`: 1-4 players, 1-16 pieces, difficulties 0-2; lanes
that abort after five failed retries, and lanes whose retries stack 52
placements past MAX_PLACED), through the queue form (rows picked by
``idx`` in a wider batch), to the eight oracle goldens, and to the JAX
package's generate_map. Skips only where g++ is missing.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from eldorado_tpu.core.mapgen import generate_map as jax_generate_map
from eldorado_tpu.ops.rng import seed as jax_seed
from eldorado_tpu_torch.core import cells as TCells
from eldorado_tpu_torch.core import engine as E
from eldorado_tpu_torch.core import mapgen as MG
from eldorado_tpu_torch.ops import build
from eldorado_tpu_torch.ops.rng import seed
from test_jax_parity import GOLDEN, MAPGEN_CASES

HOST_SOURCE = Path(__file__).with_name("mapgen_host.cpp")
_i32 = torch.int32
FIELDS = ("ids", "min_xy", "ok", "overflow", "start_xy", "start_no",
          "player_xy", "req", "nr", "end")


@pytest.fixture(scope="module")
def host_map(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of mapgen.cuh needs it")
    so = tmp_path_factory.mktemp("mapgen_host") / "libmapgen_host.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{build.CSRC}",
         "-o", str(so), str(HOST_SOURCE)], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    fn = ctypes.CDLL(str(so)).ed_host_generate_map
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ovl = torch.as_tensor(MG._build_pair_overlap()).to(_i32)

    def run(rng, n_pieces, difficulty, n_players, idx=None):
        """K3's outputs for the envs ``idx`` (all without) of (n,) batch
        inputs: the batch rows (ids, min_xy, ok, overflow, sentinel -7
        where no env was generated) and the queue-width rest, with
        ``work``: each env's trips and retries."""
        n = rng.shape[0]
        q = n if idx is None else idx.shape[0]
        out = dict(
            ids=torch.full((n, E.GRIDSIZE ** 2), -7, dtype=_i32),
            min_xy=torch.full((n, 2), -7, dtype=_i32),
            ok=torch.zeros(n, dtype=torch.bool),
            overflow=torch.ones(n, dtype=torch.bool),
            start_xy=torch.zeros((q, 4, 2), dtype=_i32),
            start_no=torch.zeros((q, 4), dtype=_i32),
            player_xy=torch.zeros((q, 4, 2), dtype=_i32),
            **{k: torch.zeros((q, 4, E.N_BALL), dtype=_i32)
               for k in ("req", "nr", "end")},
            work=torch.full((q, 2), -7, dtype=_i32))
        ins = (rng, idx, n_pieces, difficulty, n_players, ovl)
        err = fn(*(None if t is None else t.data_ptr() for t in ins),
                 *(out[k].data_ptr() for k in FIELDS), q,
                 out["work"].data_ptr())
        assert err == 0
        return out
    return run


def batch(seeds, n_pieces, difficulty, n_players):
    n = len(seeds)

    def par(v):
        return torch.as_tensor(v).to(_i32).expand(n).contiguous()
    return (seed(torch.as_tensor(np.asarray(seeds, np.int64)), device="cpu"),
            par(n_pieces), par(difficulty), par(n_players))


def plain(rng, n_pieces, difficulty, n_players):
    gen, pxy, (req, nr, end) = E.reset_map_prelude(rng, n_pieces, difficulty,
                                                   n_players)
    return dict(ids=gen.ids, min_xy=gen.min_xy, ok=gen.ok,
                overflow=gen.overflow, start_xy=gen.player_start_xy,
                start_no=gen.player_start_no, player_xy=pxy, req=req, nr=nr,
                end=end, work=torch.stack([gen.trips, gen.retries], 1))


def test_host_equals_plain_on_mixed_batch(host_map):
    seeds, players, pieces, diff = MG.mixed_batch(48)
    args = batch(seeds, pieces, diff, players)
    got, want = host_map(*args), plain(*args)
    for f in FIELDS + ("work",):
        assert torch.equal(got[f], want[f]), f
    aborted = ~want["ok"] & ~want["overflow"]
    assert int(want["ok"].sum()) > 0 and int(aborted.sum()) > 0
    # an abort is the push past MAX_DEPTH - 1 nested frames
    assert bool((want["work"][aborted, 1] >= MG.MAX_DEPTH).all())
    assert want["overflow"][-3:].all(), "the overflow lanes"


def test_host_queue_rows_equal_plain(host_map):
    """The queue form: envs ``idx`` of a 40-env batch (unordered, with
    gaps), each row written at its index and nowhere else."""
    seeds, players, pieces, diff = MG.mixed_batch(40, seed=3)
    args = batch(seeds, pieces, diff, players)
    idx = torch.tensor([39, 2, 17, 5, 30, 11, 0, 23, 38], dtype=_i32)
    got = host_map(*args, idx=idx)
    want = plain(*(a[idx.long()] for a in args))
    rows = idx.long()
    others = torch.ones(40, dtype=torch.bool)
    others[rows] = False
    for f in FIELDS:
        x = got[f][rows] if f in ("ids", "min_xy", "ok", "overflow") \
            else got[f]
        assert torch.equal(x, want[f]), f
    assert bool((got["ids"][others] == -7).all())
    assert bool((got["min_xy"][others] == -7).all())


@pytest.mark.parametrize("name,n_pieces,diff", MAPGEN_CASES)
def test_host_matches_oracle(host_map, name, n_pieces, diff):
    d = np.load(f"{GOLDEN}/{name}.npz")
    got = host_map(*batch(d["seeds"], n_pieces, diff, 4))
    assert np.array_equal(got["ok"].numpy().astype(np.uint8), d["ok"])
    good = d["ok"] > 0
    assert np.array_equal(TCells.expand_obs(got["ids"]).numpy()[good],
                          d["obs"][good])


@pytest.mark.parametrize("n_pieces,diff", [(3, 0), (5, 2), (4, 0)])
def test_host_equals_jax(host_map, n_pieces, diff):
    seeds = np.random.RandomState(n_pieces).randint(
        0, 1 << 31, size=16).astype(np.uint32)
    want = jax.jit(jax.vmap(lambda s: jax_generate_map(s, n_pieces, diff)))(
        jax.vmap(jax_seed)(seeds))
    got = host_map(*batch(seeds, n_pieces, diff, 4))
    for mine, theirs in (("ids", "ids"), ("min_xy", "min_xy"),
                         ("start_xy", "player_start_xy"),
                         ("start_no", "player_start_no"), ("ok", "ok"),
                         ("overflow", "overflow")):
        assert np.array_equal(got[mine].numpy(),
                              np.asarray(getattr(want, theirs))), mine
