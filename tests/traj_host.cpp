// The oracle's trajectory probe loop for one env (the loop of
// tests/test_jax_parity.py::parity_rollout) on the per-env code the CUDA
// kernels run: every step ed::sample_step (K1's), and after a step that
// ends the game ed::map_env (K3's, through the lane shim's loop form) on a
// copy of the env's engine, then ed::reset_body (K2's). For
// tests/test_torch_traj_golden.py: g++ builds it, ctypes loads it.
#include <string.h>

#include "mapgen.cuh"

namespace {

struct Probe {
  ed::Env s;
  alignas(16) int map[ed::kMapCells];
  int min_xy[2];
  ed::MapScratch scratch;
};

// cog_env::reset after its seeding: the map from a copy of the env's
// engine, then the reset body from the map's add_players positions and
// ball rows. False when the generation failed.
bool reset(Probe& p, int n_players, int n_pieces, int difficulty,
           const int* ovl) {
  const int rng = (int)p.s.rng;
  unsigned char ok = 0, overflow = 0;
  int xy[2 * ed::kPlayers], req[ed::kPlayers * ed::kBall],
      nr[ed::kPlayers * ed::kBall], end[ed::kPlayers * ed::kBall];
  const ed::MapArgs a = {&rng,     nullptr,  &n_pieces, &difficulty,
                         &n_players, ovl,    p.map,     p.min_xy,
                         &ok,      &overflow, nullptr,  nullptr,
                         xy,       req,      nr,        end,
                         1};
  ed::map_env<ed::LoopLanes>(a, 0, p.scratch, ed::OvlPlain{ovl});
  ed::reset_body(p.s, n_players, xy, req, nr, end);
  return ok != 0;
}

}  // namespace

// carry0: the fresh env's (570,) carry column (engine.make_state, then
// pack_dyn, at one env); srng0 the sampler's engine; mask_sel samples the
// sel mask, else the acting player's storage mask; ovl the pair table.
// Runs the first reset and n_steps probe steps, and writes states
// (n_steps + 1, 570): the column after the first reset, then after each
// step and its reset; actions (n_steps, 5) and done (n_steps,): each
// step's action and whether it ended the game; maps (max_maps, 2304) and
// map_steps (max_maps,): the first reset's
// map at step -1, then the map of each reset at the step that ended the
// game, as many as fit. Returns the number of maps made, or -1 when a
// generation failed.
extern "C" int ed_host_traj(const int* carry0, int srng0, int n_players,
                            int n_pieces, int difficulty, int max_steps,
                            int mask_sel, const int* ovl, int n_steps,
                            int* states, int* actions, int* done,
                            int* maps, int* map_steps, int max_maps) {
  static Probe p;
  int n_maps = 0;
  auto reset_and_keep = [&](int step) {
    if (!reset(p, n_players, n_pieces, difficulty, ovl)) return false;
    if (n_maps < max_maps) {
      memcpy(maps + (size_t)n_maps * ed::kMapCells, p.map, sizeof(p.map));
      map_steps[n_maps] = step;
    }
    ++n_maps;
    return true;
  };
  ed::load_env(p.s, carry0, 1, 0);
  uint32_t srng = (uint32_t)srng0;
  if (!reset_and_keep(-1)) return -1;
  ed::store_env(p.s, states, 1, 0);
  for (int t = 0; t < n_steps; ++t) {
    int act[5];
    ed::sample_step(p.s, srng, p.map, p.min_xy[0], p.min_xy[1], n_players,
                    max_steps, mask_sel, 0, act);
    for (int h = 0; h < 5; ++h) actions[5 * t + h] = act[h];
    done[t] = p.s.done;
    if (p.s.done && !reset_and_keep(t)) return -1;
    ed::store_env(p.s, states + (size_t)(t + 1) * ed::kCarryWords, 1, 0);
  }
  return n_maps;
}
