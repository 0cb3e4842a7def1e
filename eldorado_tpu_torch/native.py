"""ctypes loader for the host runtime of ``native/obs_abi.cpp``: the
lock-free SPSC `TrajectoryRing` the learner feed hands its records through,
and `pack_obs` (planar state -> the reference's ObsData byte layout).

Port of ``eldorado_tpu/native.py``. The source is shared with the JAX
package and left untouched; the library is built with g++ at first use into
the port's build directory (`ops.build.BUILD_DIR`), named by a hash of the
source, the flags and the compiler's version, so an edited source or
another toolchain rebuilds and concurrent processes never load a
half-written file. Nothing is written into ``native/``.

There is no quiet fallback: when the library cannot be built, `load`
raises with the compiler's log, and so does every ring or packer asked for.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "obs_abi.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _compiler_version(cxx: str) -> str:
    res = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    return res.stdout.splitlines()[0] if res.stdout else ""


def library_name(cxx: str) -> str:
    """``libobs_abi_<hash>.so``: a hash of the source, flags and compiler."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_compiler_version(cxx).encode())
    h.update(SOURCE.read_bytes())
    return f"libobs_abi_{h.hexdigest()[:16]}.so"


def build(build_dir: Path, cxx: str = "g++") -> Path:
    """Compile ``native/obs_abi.cpp`` into ``build_dir`` unless it is there
    already; raises with the compiler's output when the build fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / library_name(cxx)
    if lib.exists():
        return lib
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        so = Path(tmp) / lib.name
        res = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(so)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name} "
                               f"({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per hash) and load the library, argtypes set."""
    lib = ctypes.CDLL(str(build(BUILD_DIR, os.environ.get("CXX", "g++"))))
    lib.pack_obs.argtypes = [_I64] + [_P] * 7
    lib.pack_obs.restype = None
    lib.obs_struct_size.restype = ctypes.c_int
    lib.ring_create.restype = _P
    lib.ring_create.argtypes = [_I64, _I64]
    lib.ring_destroy.argtypes = [_P]
    lib.ring_push.argtypes = [_P, _P]
    lib.ring_pop.argtypes = [_P, _P]
    lib.ring_size.argtypes = [_P]
    lib.ring_size.restype = _I64
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_obs(map_obs, phase, resources, shop, piles, storage_masks):
    """One-pass packing of batched planar host state into the reference's
    ObsData array-of-structs bytes: map (n, 48, 48, 7) u8, phase (n,),
    resources (n, 3), shop (n, 18), piles (n, 4, 5, 21), storage_masks
    (n, 4, 92) bool. Returns (n, 16947) u8."""
    lib = load()
    n = map_obs.shape[0]
    out = np.empty((n, lib.obs_struct_size()), np.uint8)
    args = [np.ascontiguousarray(map_obs, np.uint8),
            np.ascontiguousarray(phase, np.int32),
            np.ascontiguousarray(resources, np.float32),
            np.ascontiguousarray(shop, np.int32),
            np.ascontiguousarray(piles, np.int32),
            np.ascontiguousarray(storage_masks, np.uint8)]
    lib.pack_obs(n, *(_ptr(a) for a in args), _ptr(out))
    return out


class TrajectoryRing:
    """Lock-free single-producer single-consumer ring of ``capacity``
    fixed-size chunks of ``chunk_bytes`` (native/obs_abi.cpp). `push`
    copies a chunk in and returns False when the ring is full; `pop`
    returns a copied-out chunk as u8 bytes, or None when it is empty."""

    def __init__(self, chunk_bytes: int, capacity: int = 64):
        self._lib = load()
        self.chunk_bytes = int(chunk_bytes)
        self._h = self._lib.ring_create(self.chunk_bytes, int(capacity))

    def push(self, chunk: np.ndarray) -> bool:
        c = np.ascontiguousarray(chunk).reshape(-1).view(np.uint8)
        if c.nbytes != self.chunk_bytes:
            raise ValueError(f"chunk of {c.nbytes} bytes, ring takes "
                             f"{self.chunk_bytes}")
        return bool(self._lib.ring_push(self._h, _ptr(c)))

    def pop(self):
        out = np.empty(self.chunk_bytes, np.uint8)
        if not self._lib.ring_pop(self._h, _ptr(out)):
            return None
        return out

    def __len__(self):
        return int(self._lib.ring_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None
