"""Build the CUDA kernels of csrc/ on first use and bind them with ctypes.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):
``build/eldorado_tpu_torch/libeldorado_<hash>.so`` at the root of the
checkout (or, for an installed copy, under ``$XDG_CACHE_HOME`` or
``~/.cache``), named by a hash of the sources and flags, so an edited
source rebuilds and concurrent processes never load a half-written file.
Each source compiles in its own ``nvcc`` process, all started together,
then one more links them. The compilers' output (``ptxas -v``: registers
and stack frame of every kernel) is kept beside the library as
``libeldorado_<hash>.log`` and read back when the library is already built.
Each C entry takes raw device pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()``; `check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("step_kernel.cu", "step_compact.cu", "step_full.cu",
           "step_traj.cu", "step_actions.cu", "sample.cu", "reset_kernel.cu",
           "mapgen.cu", "queue.cu", "probes.cu")
HEADERS = ("rng.cuh", "lanes.cuh", "engine.cuh", "step_kernel.cuh",
           "mapgen.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
                 "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entries: name -> argtypes (pointers and the stream as void*)
_ENTRIES = {
    # carry_in, carry_out, srng_in, srng_out, map_ids, min_xy, n_players,
    # max_steps, actions, dead, records, n, n_steps, mask_src_sel,
    # gate_dead, null_body, record_words, stream
    "ed_fused_step": [_P] * 11 + [_I] * 6 + [_P],
    # out: threads per block, shared bytes per block, blocks per SM
    "ed_fused_step_occupancy": [_P],
    # carry_in, carry_out, actions, map_ids, min_xy, n_players, max_steps,
    # counts, n, stream
    "ed_step_actions": [_P] * 8 + [_I] + [_P],
    # srng_in, srng_out, mask_words, live, actions, tainted, n, stream
    "ed_sample": [_P] * 6 + [_I] + [_P],
    # srng_in, srng_out, carry, live, actions, n, mask_sel, stream
    "ed_sample_carry": [_P] * 5 + [_I] * 2 + [_P],
    # n, threads per block, stream
    "ed_empty": [_I, _I, _P],
    # carry_in, carry_out, idx, count, n_players, player_xy, req, nr, end,
    # n, q, stream
    "ed_fused_reset": [_P] * 9 + [_I] * 2 + [_P],
    # rng, idx, n_pieces, difficulty, n_players, ovl, map_ids, min_xy, ok,
    # overflow, start_xy, start_no, player_xy, req, nr, end, q, count,
    # work, stream
    "ed_generate_map": [_P] * 16 + [_I] + [_P] * 3,
    # the same, then envs_per_block, ovl_shared before the stream
    "ed_generate_map_shaped": [_P] * 16 + [_I, _P, _P, _I, _I, _P],
    # done, inflight, idx, count, n, q_cap, stream
    "ed_queue_select": [_P] * 4 + [_I] * 2 + [_P],
    # idx, count, ok, overflow, inflight, tally, work, work_tally, q_cap,
    # stream
    "ed_queue_settle": [_P] * 8 + [_I] + [_P],
    # envs_per_block, ovl_shared; out: envs per block, threads per block,
    # shared bytes per block, blocks per SM, ovl_shared
    "ed_generate_map_shape": [_I] * 2 + [_P],
    # carry_in, carry_out, rows, n, stream
    "ed_null_copy": [_P] * 2 + [_I] * 2 + [_P],
    # x, y, out, count, k, sel, stream
    "ed_op_chain": [_P] * 3 + [_I] * 3 + [_P],
    # carry, srng, map_ids, min_xy, n_players, max_steps, out, n, n_steps,
    # cut, stream
    "ed_step_prefix": [_P] * 7 + [_I] * 3 + [_P],
}


def _build_dir() -> Path:
    """<checkout>/build/eldorado_tpu_torch in a checkout; a per-user cache
    directory for an installed copy, whose parent is site-packages."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists():
        return root / "build" / "eldorado_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "eldorado_tpu_torch"


BUILD_DIR = _build_dir()


class Library:
    """The loaded kernels: ``lib.fn`` for each C entry, plus the build's
    wall time (next to nothing when it was already built) and the
    compilers' log (``ptxas -v`` register counts)."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log
        self._dll = ctypes.CDLL(str(path))
        for name, argtypes in _ENTRIES.items():
            fn = getattr(self._dll, name)
            fn.argtypes = argtypes
            fn.restype = _I
            setattr(self, name, fn)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return str(path)


def library_name() -> str:
    """``libeldorado_<hash>.so``: a hash of the flags and the sources."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update((CSRC / name).read_bytes())
    return f"libeldorado_{h.hexdigest()[:16]}.so"


def _compile(nvcc: str, lib: Path, log_path: Path) -> None:
    """One nvcc per source, all at once, then the link; writes the library
    and its log under their final names only when everything succeeded."""
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in SOURCES:
            obj, out = tmp / f"{src}.o", tmp / f"{src}.log"
            with open(out, "w") as fh:
                proc = subprocess.Popen(
                    [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj),
                     str(CSRC / src)], stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((src, obj, out, proc))
        log, failed = [], []
        for src, _, out, proc in jobs:
            rc = proc.wait()
            log.append(f"== {src}\n{out.read_text()}")
            if rc != 0:
                failed.append(src)
        log = "".join(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        so = tmp / lib.name
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(so),
                              *(str(obj) for _, obj, _, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        (tmp / log_path.name).write_text(log)
        os.replace(tmp / log_path.name, log_path)
        os.replace(so, lib)


def build(build_dir: Path) -> tuple[Path, float, str]:
    """Compile the library into ``build_dir`` unless it is there already.
    Returns (library path, build seconds, the compilers' log); on a cache
    hit the log is read back from beside the library."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / library_name()
    log_path = lib.with_suffix(".log")
    t0 = time.perf_counter()
    if not lib.exists():
        _compile(_nvcc(), lib, log_path)
    log = log_path.read_text() if log_path.exists() else ""
    return lib, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def load() -> Library:
    """Compile (once per source hash) and load the kernel library."""
    return Library(*build(BUILD_DIR))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
