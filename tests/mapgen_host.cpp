// K3's per-env work (ed::map_env of eldorado_tpu_torch/csrc/mapgen.cuh) as
// a host function, for tests/test_torch_mapgen_host.py: g++ builds it,
// ctypes loads it. It takes the arguments of ed_generate_map
// (csrc/mapgen.cu) without the count and the stream and runs the envs one
// after another, each through the lane shim's loop form (ed::LoopLanes: one
// thread runs the 32 lanes of every cooperative step of K3's warp in lane
// order).
#include "mapgen.cuh"

extern "C" int ed_host_generate_map(
    const int* rng, const int* idx, const int* n_pieces,
    const int* difficulty, const int* n_players, const int* ovl,
    int* map_ids, int* min_xy, unsigned char* ok, unsigned char* overflow,
    int* start_xy, int* start_no, int* player_xy, int* req, int* nr,
    int* end, int q, int* work) {
  const ed::MapArgs a = {rng,      idx,      n_pieces, difficulty, n_players,
                         ovl,      map_ids,  min_xy,   ok,         overflow,
                         start_xy, start_no, player_xy, req,       nr,
                         end,      q,        work};
  static ed::MapScratch scratch;
  for (int e = 0; e < q; ++e)
    ed::map_env<ed::LoopLanes>(a, e, scratch, ed::OvlPlain{ovl});
  return 0;
}
