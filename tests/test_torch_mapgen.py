"""The port's map generation (plain torch, batched) against the oracle
goldens and against the JAX package's generate_map, tolerance zero."""
import jax
import numpy as np
import pytest
import torch

import eldorado_tpu_torch as et
from eldorado_tpu.core import cells as JCells
from eldorado_tpu.core.mapgen import generate_map as jax_generate_map
from eldorado_tpu.ops.rng import seed as jax_seed
from eldorado_tpu_torch.core import cells as TCells
from eldorado_tpu_torch.core.mapgen import generate_map
from eldorado_tpu_torch.ops.rng import seed
from test_jax_parity import GOLDEN, MAPGEN_CASES


@pytest.mark.parametrize("name,n_pieces,diff", MAPGEN_CASES)
def test_mapgen_matches_oracle(name, n_pieces, diff):
    d = np.load(f"{GOLDEN}/{name}.npz")
    out = generate_map(seed(d["seeds"].astype(np.int64), device="cpu"),
                       n_pieces, diff)
    assert np.array_equal(out.ok.numpy().astype(np.uint8), d["ok"])
    good = d["ok"] > 0
    assert np.array_equal(TCells.expand_obs(out.ids).numpy()[good],
                          d["obs"][good])


@pytest.mark.parametrize("n_pieces,diff", [(3, 0), (5, 2), (4, 0)])
def test_mapgen_equals_jax(n_pieces, diff):
    seeds = np.random.RandomState(n_pieces).randint(
        0, 1 << 31, size=16).astype(np.uint32)
    want = jax.jit(jax.vmap(lambda s: jax_generate_map(s, n_pieces, diff)))(
        jax.vmap(jax_seed)(seeds))
    got = generate_map(seed(seeds.astype(np.int64), device="cpu"), n_pieces,
                       diff)
    for f in ("ids", "min_xy", "player_start_xy", "player_start_no", "ok",
              "overflow"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


def test_cell_codec_roundtrip_equals_jax():
    d = np.load(f"{GOLDEN}/mapgen_easy.npz")
    obs = d["obs"][:4]
    ids = TCells.ids_from_obs(torch.from_numpy(obs))
    assert np.array_equal(ids.numpy(), np.asarray(JCells.ids_from_obs(obs)))
    assert np.array_equal(TCells.expand_obs(ids).numpy(), obs)
    req, nr, end = TCells.decode_cells(ids)
    assert np.array_equal(TCells.cell_type_ids(req, nr, end).numpy(),
                          ids.numpy())


def test_full_library_map_generates():
    # start + all 16 travel pieces + end (tests/test_map_failure.py)
    states = et.vec_reset(1, 4, 4, 16, 2, 100, device="cpu")
    assert bool(states.map_ok.all())


def test_capacity_error_surfacing():
    states = et.vec_reset(5, 4, 2, 2, 0, 100, device="cpu")
    states.map_overflow = torch.ones_like(states.map_overflow)
    with pytest.raises(et.MapCapacityError):
        et.check_map_generation(states)
