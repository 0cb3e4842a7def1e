"""eldorado_tpu_torch — the City of Gold engine in PyTorch, with CUDA
kernels for the NVIDIA H100.

A port of ``eldorado_tpu`` (the JAX package, which stays the reference):
bit-exact lockstep batches of the reference game, with the same field
names, dtypes and random streams. The step (K1) and the reset body (K2) are
CUDA C++ kernels (``csrc/``, built with nvcc on first use); CPU tensors take
their plain torch versions. Nothing here imports jax.

Public surface (`vec`): `vec_reset`, `vec_reset_varied`, `sampler_init`,
`check_map_generation`, `rollout_chunked`; the per-step learner feed
(`stream`): `stream_rollout`, whose records K1 writes on the card and the
native ring (`native`) hands to a consumer thread.
"""
from . import constants, errors
from .constants import Difficulty
from .core.engine import EnvState
from .errors import GenerateMapFailure, MapCapacityError
from .stream import stream_rollout
from .vec import (check_map_generation, rollout_chunked, sampler_init,
                  vec_reset, vec_reset_varied)

__all__ = [
    "constants", "errors", "Difficulty", "EnvState",
    "GenerateMapFailure", "MapCapacityError",
    "vec_reset", "vec_reset_varied", "sampler_init",
    "rollout_chunked", "check_map_generation", "stream_rollout",
]
