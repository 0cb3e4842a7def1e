"""Where the port's entry points make their tensors.

Every entry point that makes tensors from plain values (`vec.vec_reset`,
`vec.vec_reset_varied`, `vec.sampler_init`, `convert.state_from_numpy`,
`convert.rngs_from_numpy`, `stream.device_stats_init`,
`core.engine.make_state`, `ops.rng.seed`, `compat.cog_env` with
``backend="device"``, `compat.vec.get_vec_env`, `get_vec_sampler` and
`get_runner`) takes ``device="cuda"``: the port
runs on the card unless the caller asks for the CPU with ``device="cpu"``,
where the kernels' plain torch versions run. Functions that take tensors
follow their inputs' device. Nothing falls back to the CPU: asking for a
CUDA device where there is none raises.
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; a RuntimeError if it is a CUDA device
    and this process has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch versions on the CPU")
    return dev
