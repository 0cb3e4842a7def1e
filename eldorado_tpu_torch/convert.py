"""Carry engine states and sampler rngs across frameworks as numpy arrays.

`state_from_numpy` takes ``{field: np.asarray(jax_state.field)}`` (or any
mapping or object with the `EnvState` field names) and `state_to_numpy`
goes back; both keep each field's dtype (bool, int32, float32). The same
pair for the sampler rngs is `rngs_from_numpy`/`rngs_to_numpy`. The
``_from_numpy`` pair makes CUDA tensors unless given ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.engine import FIELD_SPECS, FIELDS, EnvState
from .devices import resolve


def state_from_numpy(fields, device="cuda") -> EnvState:
    device = resolve(device)
    if isinstance(fields, dict):
        get = fields.__getitem__
    else:
        def get(f):
            return getattr(fields, f)
    out = {}
    for f in FIELDS:
        shape, dt = FIELD_SPECS[f]
        x = torch.as_tensor(np.array(get(f)),
                            device=device).to(dt)
        if tuple(x.shape[1:]) != shape:
            raise ValueError(f"{f}: per-env shape {tuple(x.shape[1:])}, "
                             f"expected {shape}")
        out[f] = x
    return EnvState(**out)


def state_to_numpy(state: EnvState) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


def rngs_from_numpy(rngs, device="cuda") -> torch.Tensor:
    device = resolve(device)
    return torch.as_tensor(np.asarray(rngs).astype(np.int32), device=device)


def rngs_to_numpy(rngs: torch.Tensor) -> np.ndarray:
    return rngs.cpu().numpy()
