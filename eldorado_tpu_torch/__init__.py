"""eldorado_tpu_torch — the City of Gold engine in PyTorch, with CUDA
kernels for the NVIDIA H100.

A port of ``eldorado_tpu`` (the JAX package, which stays the reference):
bit-exact lockstep batches of the reference game, with the same field
names, dtypes and random streams. The step (K1, and K1-act for given
actions), the sampler (K1-sample), map generation (K3) and the reset body
(K2) are CUDA C++ kernels (``csrc/``, built with nvcc on first use); CPU
tensors take their plain torch versions. Nothing here imports jax.

Public surface (`vec`, the JAX package's twelve names): `VecEnv` (reset,
then sample / step in a loop, and the observation surface), `vec_reset`,
`vec_reset_varied`, `sampler_init`, `vec_step` (a learner's own actions:
K1-act, then the done envs' reset), `vec_sample` (K1-sample),
`reset_done`, `reset_done_bucketed`, `rollout` and `kernel_rollout` (K1
writing the per-step trajectory), `rollout_chunked` (self-play with queued
auto-reset, ``reset_mode="sync"`` or ``"async"``) and
`check_map_generation`; the per-step learner feed (`stream`):
`stream_rollout`, whose records K1 writes on the card and the native ring
(`native`) hands to a consumer thread. `eldorado_tpu_torch.compat`, the
`city_of_gold`-shaped mirror (structured dtypes, `cog_env`,
`action_sampler`, the `vec` getters), is imported on its own, as in the
JAX package; so are the numpy reference engine (`core.ref_engine`) and
the renderer (`render`).
"""
from . import constants, errors
from .constants import Difficulty
from .core.engine import EnvState
from .errors import GenerateMapFailure, MapCapacityError
from .stream import stream_rollout
from .vec import (VecEnv, check_map_generation, kernel_rollout, reset_done,
                  reset_done_bucketed, rollout, rollout_chunked, sampler_init,
                  vec_reset, vec_reset_varied, vec_sample, vec_step)

__all__ = [
    "constants", "errors", "Difficulty", "EnvState",
    "GenerateMapFailure", "MapCapacityError",
    "VecEnv", "vec_reset", "vec_reset_varied", "vec_step", "vec_sample",
    "rollout", "rollout_chunked", "kernel_rollout", "sampler_init",
    "reset_done", "reset_done_bucketed", "check_map_generation",
    "stream_rollout",
]
