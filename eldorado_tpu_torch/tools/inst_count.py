"""Instructions a kernel executes per thread, from a profiling build.

The bound of a latency-bound integer kernel such as K1 is the work its
inputs need: the instructions each thread executes, each kind over the
rate of the units that execute it. They depend on the data (the branches
a game takes), so they are counted on the same inputs as the timed run,
by a profiling build of the kernel itself:

1. ``nvcc -ptx`` compiles the kernel's source as the library does
   (`ops.build`), to PTX;
2. `instrument` adds per-thread 64-bit counters to one entry, one for
   each kind of instruction (`classify`: integer, memory, other): at the
   top of every basic block it adds the block's counts, and before the
   thread returns it adds its totals to a global;
3. the CUDA driver JIT-compiles that PTX, and `CountedKernel` launches it
   with the arguments the library's kernel takes.

So the count is of PTX instructions executed per thread, the counters'
own excluded. ptxas turns PTX into SASS, the instructions the card runs,
which are not the same number: `sass_counts` counts the SASS of an
entry of the built library (``cuobjdump -sass``) by the same kinds, to
set beside the entry's static PTX count. Runs on the card only.

    python -m eldorado_tpu_torch.tools.inst_count [--envs 4096] [--steps 200]

prints K1's instructions per env-step by kind (record-free, compact and
full records) on the tools' state, the record-free K1's static SASS and
PTX counts, and, as its last line, a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import build

COUNTER = "ed_icount"
PTX_FLAGS = ("-arch=compute_90a", "-std=c++17", "-O3", "--fmad=false",
             "-ptx")
# K1's instantiations (csrc/step_kernel.cuh) by record width: the source
# that instantiates each, and a pattern of its mangled entry name
K1_SOURCE = {0: "step_kernel.cu", 5: "step_compact.cu", 40: "step_full.cu",
             11: "step_traj.cu"}
K1_ENTRY = "fused_step_kernelILb{null}ELi{rec}E"
# K3's and K2's work counted one thread per env (not part of the library)
K3_WORK_SOURCE = "mapgen_work.cu"
K2_WORK_SOURCE = "reset_work.cu"
PTX_SOURCES = build.SOURCES + (K3_WORK_SOURCE, K2_WORK_SOURCE)
_LABEL = re.compile(r"^\$?[\w$]+:$")


def _ptx_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(PTX_FLAGS).encode())
    for name in build.HEADERS + (source,):
        h.update((build.CSRC / name).read_bytes())
    return build.BUILD_DIR / f"{source}_{h.hexdigest()[:16]}.ptx"


def build_ptx(sources=PTX_SOURCES) -> None:
    """Compile the PTX of each of ``sources`` (in csrc/) that is not built
    yet, one ``nvcc -ptx`` each, all at once, into the build directory,
    named by a hash of the sources and flags."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources if not _ptx_path(s).exists()]
    if not todo:
        return
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        jobs = [(s, Path(tmp) / _ptx_path(s).name) for s in todo]
        procs = [subprocess.Popen(
            [build._nvcc(), *PTX_FLAGS, "-o", str(out), str(build.CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, out in jobs]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"{s}:\n{log}" for (s, _), proc, log
                  in zip(jobs, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc -ptx failed on " + "\n".join(failed))
        for s, out in jobs:
            out.replace(_ptx_path(s))


def ptx(source: str) -> str:
    """The PTX of ``csrc/<source>`` (built by `build_ptx` if need be)."""
    build_ptx((source,))
    return _ptx_path(source).read_text()


def _code(line: str) -> str:
    return line.split("//", 1)[0].strip()


def find_entry(text: str, pattern: str) -> str:
    """The one ``.entry`` of a PTX module whose name matches ``pattern``."""
    names = [n for n in re.findall(r"\.entry\s+([\w$]+)\s*\(", text)
             if re.search(pattern, n)]
    if len(names) != 1:
        raise ValueError(f"{len(names)} entries match {pattern!r}: {names}")
    return names[0]


def classify(inst: str) -> str:
    """The kind of a PTX instruction (a code line), as `KINDS` names them
    and as the card's units execute them: "int" (integer and logic
    arithmetic, compares, selects and conversions: the SM's 64 int32
    lanes), "mem" (loads, stores and atomics: its 32 load/store units) or
    "other" (moves, branches, returns, barriers, floating point: issue
    slots only)."""
    op = re.sub(r"^@!?%\w+\s+", "", inst).split(None, 1)[0]
    base = op.split(".", 1)[0]
    if base in _MEM_OPS:
        return "mem"
    if base in _INT_OPS and not re.search(r"\.f(16|32|64)\b", op):
        return "int"
    return "other"


KINDS = ("int", "mem", "other")
_MEM_OPS = frozenset("ld ldu st atom red".split())
_INT_OPS = frozenset(
    "add sub mul mad mul24 mad24 sad div rem abs neg min max popc clz bfind "
    "fns brev bfe bfi dp4a dp2a and or xor not cnot lop3 shf shl shr setp "
    "set selp slct prmt cvt cvta szext bmsk".split())


def instrument(text: str, entry: str) -> tuple[str, dict]:
    """``text`` (a PTX module) with per-thread instruction counters in
    ``entry``, one per kind (`classify`), summed over threads into the
    global ``ed_icount[3]`` (u64, in `KINDS` order). Returns (the new PTX,
    the entry's static instruction count by kind)."""
    lines = text.splitlines()
    start = next((i for i, l in enumerate(lines)
                  if re.search(rf"\.entry\s+{re.escape(entry)}\s*\(", l)),
                 None)
    if start is None:
        raise ValueError(f"entry {entry} not in the PTX")
    open_ = next(i for i in range(start, len(lines))
                 if _code(lines[i]) == "{")
    depth, close = 0, None
    for i in range(open_, len(lines)):
        c = _code(lines[i])
        depth += c.count("{") - c.count("}")
        if depth == 0:
            close = i
            break
    body = lines[open_ + 1:close]
    # each code line: "decl" (also inside a nested { } scope), "label" or
    # "inst"
    kinds = []
    for line in body:
        c = _code(line)
        if not c or c in ("{", "}"):
            kinds.append(None)
        elif c.startswith("."):
            kinds.append("decl")
        elif _LABEL.match(c):
            kinds.append("label")
        else:
            if re.match(r"^(@!?%\w+\s+)?call", c):
                raise ValueError(f"{entry} calls a function; its "
                                 f"instructions would go uncounted: {c}")
            kinds.append("inst")
    first = next(i for i, k in enumerate(kinds) if k == "inst")
    # block leaders: the first instruction, the first instruction after a
    # label, and the one after a branch
    out, pending = [], []
    total = dict.fromkeys(KINDS, 0)

    def flush():
        nonlocal pending
        n = dict.fromkeys(KINDS, 0)
        for line, k in pending:
            if k == "inst":
                n[classify(_code(line))] += 1
        for j, kind in enumerate(KINDS):
            if n[kind]:
                out.append(f"\tadd.s64 \t%icnt{j}, %icnt{j}, {n[kind]};")
                total[kind] += n[kind]
        for line, k in pending:
            c = _code(line)
            if k == "inst" and re.match(r"^(@!?%\w+\s+)?(ret|exit)\b", c):
                pred = re.match(r"^(@!?%\w+\s+)?", c).group(1) or ""
                out.extend(f"\t{pred}red.global.add.u64 \t[{COUNTER}+"
                           f"{8 * j}], %icnt{j};" for j in range(len(KINDS)))
            out.append(line)
        pending = []

    for i, (line, k) in enumerate(zip(body, kinds)):
        if i < first:
            out.append(line)
            continue
        if i == first:
            out.extend(f"\tmov.u64 \t%icnt{j}, 0;" for j in range(len(KINDS)))
        if k == "label":
            flush()
            out.append(line)
            continue
        pending.append((line, k))
        if k == "inst" and re.match(r"^(@!?%\w+\s+)?bra", _code(line)):
            flush()
    flush()
    decl = f"\t.reg .b64 \t%icnt<{len(KINDS)}>;"
    new = lines[:open_ + 1] + [decl] + out + lines[close:]
    addr = next(i for i, l in enumerate(new)
                if l.strip().startswith(".address_size"))
    new.insert(addr + 1, f".global .align 8 .u64 {COUNTER}[{len(KINDS)}];")
    return "\n".join(new) + "\n", total


class _Driver:
    """The few CUDA driver calls the profiling build needs (ctypes)."""

    def __init__(self):
        self.lib = ctypes.CDLL("libcuda.so.1")

    def __call__(self, name, *args):
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA driver error {err}")


@functools.lru_cache(maxsize=None)
def _driver() -> _Driver:
    return _Driver()


class CountedKernel:
    """The entry of ``csrc/<source>`` whose name matches ``pattern``,
    instrumented (`instrument`) and loaded on the current device. Call it
    with the kernel's launch and arguments; it returns the instructions
    all threads executed, by kind."""

    CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

    def __init__(self, source: str, pattern: str):
        torch.zeros(1, device="cuda")   # make the primary context current
        text = ptx(source)
        self.entry = find_entry(text, pattern)
        text, self.static = instrument(text, self.entry)
        d = _driver()
        self._mod = ctypes.c_void_p()
        self._src = ctypes.create_string_buffer(text.encode())
        d("cuModuleLoadData", ctypes.byref(self._mod), self._src)
        self._fn = ctypes.c_void_p()
        d("cuModuleGetFunction", ctypes.byref(self._fn), self._mod,
          self.entry.encode())
        self._ptr = ctypes.c_uint64()
        size = ctypes.c_size_t()
        d("cuModuleGetGlobal_v2", ctypes.byref(self._ptr),
          ctypes.byref(size), self._mod, COUNTER.encode())

    def __call__(self, blocks: int, threads: int, smem: int, args) -> dict:
        """``args``: tensors (passed as device pointers), None (a null
        pointer) or ints (32-bit), in the kernel's order."""
        d = _driver()
        if smem > 48 * 1024:
            d("cuFuncSetAttribute", self._fn,
              self.CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
              ctypes.c_int(smem))
        counts = (ctypes.c_uint64 * len(KINDS))()
        nbytes = ctypes.c_size_t(ctypes.sizeof(counts))
        d("cuMemcpyHtoD_v2", self._ptr, counts, nbytes)
        vals = [ctypes.c_int(a) if isinstance(a, int) else
                ctypes.c_uint64(0 if a is None else a.data_ptr())
                for a in args]
        params = (ctypes.c_void_p * len(vals))(
            *(ctypes.addressof(v) for v in vals))
        stream = torch.cuda.current_stream().cuda_stream
        d("cuLaunchKernel", self._fn, ctypes.c_uint(blocks), ctypes.c_uint(1),
          ctypes.c_uint(1), ctypes.c_uint(threads), ctypes.c_uint(1),
          ctypes.c_uint(1), ctypes.c_uint(smem), ctypes.c_void_p(stream),
          params, None)
        torch.cuda.synchronize()
        d("cuMemcpyDtoH_v2", counts, self._ptr, nbytes)
        return dict(zip(KINDS, counts))


@functools.lru_cache(maxsize=None)
def counter(source: str, pattern: str) -> CountedKernel:
    return CountedKernel(source, pattern)


def count_k1(carry, srng, static, n_steps: int, mask_src: str = "storage",
             gate_dead: bool = False, record=None,
             null_body: bool = False) -> dict:
    """Instructions K1's threads execute, by kind, for ``fused_step(carry,
    srng, *static, n_steps, mask_src, gate_dead, null_body=null_body,
    record=record)``, launched as the library launches K1; the arguments
    are not changed."""
    from ..ops import step_kernel as K
    n = carry.shape[1]
    words = 0 if record is None else K.RECORD_WORDS[record]
    shape = K.fused_step_shape(n)
    out, srng_out = torch.empty_like(carry), torch.empty_like(srng)
    act = torch.zeros((n, 5), dtype=torch.int32, device=carry.device)
    recs = (torch.empty((n_steps, n, words), dtype=torch.int32,
                        device=carry.device) if words else None)
    kernel = counter(K1_SOURCE[words],
                     K1_ENTRY.format(null=int(null_body), rec=words))
    return kernel(shape["blocks"], shape["threads"], shape["smem_bytes"],
                  [carry, out, srng, srng_out, *static, act, None, recs, n,
                   int(n_steps), int(mask_src == "sel"), int(gate_dead)])


def count_k1_act(carry, actions, static) -> dict:
    """Instructions K1-act's threads execute, by kind, for
    ``step_actions(carry, actions, *static)`` (csrc/step_actions.cu,
    `ACT_ENVS` envs and `ACT_WARPS` warps a block); the arguments are not
    changed."""
    from ..core import engine as E
    from ..ops import step_kernel as K
    n = carry.shape[1]
    counts = torch.zeros(3, dtype=torch.int32, device=carry.device)
    return counter("step_actions.cu", "step_actions_kernel")(
        -(-n // K.ACT_ENVS), 32 * K.ACT_WARPS,
        K.ACT_ENVS * 4 * (E.CARRY_WORDS + 1),
        [carry, torch.empty_like(carry), actions, *static, counts, n])


def count_k1_sample(srng, mask_words, live=None) -> dict:
    """Instructions K1-sample's threads execute, by kind, for
    ``sample(srng, mask_words, live)`` (csrc/sample.cu: one thread per
    env, 32 a block)."""
    n = srng.shape[0]
    return counter("sample.cu", "sample_kernelILb0E")(
        -(-n // 32), 32, 0,
        [srng, torch.empty_like(srng), mask_words, None, live,
         torch.empty((n, 5), dtype=torch.int32, device=srng.device),
         torch.empty(n, dtype=torch.bool, device=srng.device), n, 0])


def count_k1_sample_carry(srng, carry, mask_src="storage",
                          live=None) -> dict:
    """The same for ``sample_carry(srng, carry, mask_src, live)``, run on
    a copy of ``carry`` (its rng_tainted row is written in place)."""
    n = srng.shape[0]
    return counter("sample.cu", "sample_kernelILb1E")(
        -(-n // 32), 32, 0,
        [srng, torch.empty_like(srng), None, carry.clone(), live,
         torch.empty((n, 5), dtype=torch.int32, device=srng.device), None,
         n, int(mask_src == "sel")])


def count_k2(carry, n_players, player_xy, req, nr, end, idx=None) -> dict:
    """Instructions K2's warps execute, by kind, summed over their lanes,
    for ``fused_reset`` on these arguments (csrc/reset_kernel.cu: a warp
    per env; in place a warp a block, into a new carry `RESET_ENVS` envs
    a block), run on a copy of ``carry``."""
    from ..ops import step_kernel as K
    q = player_xy.shape[0]
    envs = 1 if idx is not None else K.RESET_ENVS
    out = carry.clone()
    pattern = f"fused_reset_kernelILb{int(idx is not None)}E"
    return counter("reset_kernel.cu", pattern)(
        -(-q // envs), 32 * envs, 0,
        [carry if idx is None else out, out, idx, None, n_players,
         player_xy, req, nr, end, carry.shape[1], q])


def count_k2_work(carry, n_players, player_xy, req, nr, end, idx) -> dict:
    """The instructions of K2's work in place on the same inputs, by kind:
    the same per-env code run one thread per env through the lane shim's
    loop form (csrc/reset_work.cu), on a copy of ``carry``."""
    q = player_xy.shape[0]
    return counter(K2_WORK_SOURCE, "fused_reset_work_kernel")(
        (q + 31) // 32, 32, 0,
        [carry.clone(), idx, n_players, player_xy, req, nr, end,
         carry.shape[1], q])


def _k3_args(rng, n_pieces, difficulty, n_players, idx) -> list:
    """K3's arguments for map generation and the prelude of the envs
    ``idx`` of these (n,) batch arrays, as `engine.reset_map_prelude_rows`
    passes them, into scratch outputs."""
    from ..core import engine as E
    from ..core import mapgen as MG
    n, q, dev = rng.shape[0], idx.shape[0], rng.device

    def z(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)
    return [rng, idx, n_pieces, difficulty, n_players, MG._K(dev).ovl,
            z(n, E.GRIDSIZE * E.GRIDSIZE), z(n, 2), z(n, dtype=torch.bool),
            z(n, dtype=torch.bool), None, None, z(q, 4, 2),
            z(q, 4, E.N_BALL), z(q, 4, E.N_BALL), z(q, 4, E.N_BALL), q]


def count_k3(rng, n_pieces, difficulty, n_players, idx) -> dict:
    """Instructions K3's threads execute, by kind, for map generation and
    the prelude of the envs ``idx`` of these (n,) batch arrays, launched
    as the library launches K3 (csrc/mapgen.cu, the default shape: one
    warp per env), summed over every lane of each env's warp."""
    from ..core import mapgen as MG
    shape = MG.launch_shape(idx.shape[0])
    pattern = f"generate_map_kernelILb{int(shape['ovl_shared'])}E"
    return counter("mapgen.cu", pattern)(
        shape["blocks"], shape["threads"], shape["smem_bytes"],
        _k3_args(rng, n_pieces, difficulty, n_players, idx) + [None])


def count_k3_work(rng, n_pieces, difficulty, n_players, idx) -> dict:
    """The instructions of K3's work on the same inputs, by kind: the same
    per-env code run one thread per env through the lane shim's loop form
    (csrc/mapgen_work.cu), so each candidate is tested once and the
    scalar chain runs once per env, not once in every lane of a warp."""
    q = idx.shape[0]
    return counter(K3_WORK_SOURCE, "generate_map_work_kernel")(
        (q + 31) // 32, 32, 0,
        _k3_args(rng, n_pieces, difficulty, n_players, idx))


def count_p3(carry, srng, static, n_steps: int, cut: int) -> dict:
    """Instructions P3's threads execute, by kind, for ``step_prefix``
    (launched like K1: csrc/probes.cu)."""
    from ..ops import step_kernel as K
    n = carry.shape[1]
    shape = K.fused_step_shape(n)
    return counter("probes.cu", f"step_prefix_kernelILi{cut}E")(
        shape["blocks"], shape["threads"], shape["smem_bytes"],
        [carry, srng, *static, torch.empty_like(srng), n, int(n_steps)])


def classify_sass(opcode: str) -> str:
    """The kind of a SASS opcode, as `classify` sorts PTX."""
    base = opcode.split(".", 1)[0]
    if base in _SASS_MEM:
        return "mem"
    if base in _SASS_INT:
        return "int"
    return "other"


_SASS_MEM = frozenset(
    "LD LDG LDS LDL LDC LDSM LDGSTS ST STG STS STL ATOM ATOMG ATOMS RED "
    "REDG".split())
_SASS_INT = frozenset(
    "IADD3 IADD IMAD IMUL IMNMX VIMNMX IABS ISETP ICMP LOP LOP3 PLOP3 SHF "
    "SHL SHR SEL LEA PRMT POPC FLO BREV BMSK SGXT I2I I2IP IDP VIADD "
    "VIADDMNMX P2R R2P".split())
_SASS_LINE = re.compile(
    r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def parse_sass(text: str, pattern: str) -> dict:
    """Static SASS instructions by kind of the one function of a
    ``cuobjdump -sass`` listing whose name matches ``pattern`` (the
    padding NOPs after its end left out)."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"^\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = dict.fromkeys(KINDS, 0)
            continue
        m = _SASS_LINE.match(line)
        if m and name is not None and m.group(1) != "NOP":
            funcs[name][classify_sass(m.group(1))] += 1
    names = [n for n in funcs if re.search(pattern, n)]
    if len(names) != 1:
        raise ValueError(f"{len(names)} functions match {pattern!r}: {names}")
    return funcs[names[0]]


def sass_counts(pattern: str) -> dict:
    """Static SASS instructions by kind of the built library's function
    matching ``pattern`` (``cuobjdump -sass``, from the CUDA toolkit)."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    listing = subprocess.run([str(tool), "-sass", str(build.load().path)],
                             capture_output=True, text=True, check=True)
    return parse_sass(listing.stdout, pattern)


def main(argv=None):
    from . import _timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    dev = _timing.require_cuda("inst_count")
    print(_timing.card(), flush=True)
    carry, srng, static = _timing.inputs(args.envs, dev)
    row = {}
    for record in (None, "compact", "full"):
        counts = count_k1(carry, srng, static, args.steps, record=record)
        per = {k: v / (args.envs * args.steps) for k, v in counts.items()}
        row[record or "none"] = per
        print(f"K1 records={record}: {sum(per.values()):.1f} PTX "
              f"instructions per env-step ({args.envs} envs x {args.steps} "
              f"steps): " + ", ".join(f"{k} {v:.1f}" for k, v in per.items()),
              flush=True)
    pattern = K1_ENTRY.format(null=0, rec=0)
    static_ptx = counter(K1_SOURCE[0], pattern).static
    static_sass = sass_counts(pattern)
    print("K1 static instructions, SASS / PTX: " + ", ".join(
        f"{k} {static_sass[k]} / {static_ptx[k]}" for k in KINDS))
    print(json.dumps({"envs": args.envs, "steps": args.steps,
                      "card": _timing.card(), "per_env_step": row,
                      "static_ptx": static_ptx, "static_sass": static_sass}))


if __name__ == "__main__":
    main()
