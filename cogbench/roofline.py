"""The yardstick of a kernel's share of its roofline.

A kernel's least time on the card is the larger of the bytes it must move
over HBM's bandwidth and the time its instructions need on the units that
execute them: integer instructions on each SM's 64 int32 lanes, loads and
stores on its 32 load/store units, and all of them through its 4 x 32 issue
slots, at 1.98 GHz (the clock of the data sheet's peak rates) on every SM.
The work is frozen in ``work/<kernel>/<config>.json``: PTX instructions by
kind per unit of work (an env-step, or an env reset), counted once at the
configuration's inputs, and the bytes as the shapes give them, each input
word read once and each output word written once. A later change to a
kernel moves its time, not its yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet)
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
# instructions per SM per clock: int32 lanes, load/store units, and the
# issue slots of its four schedulers (every kind)
INT_PER_SM, MEM_PER_SM, ISSUE_PER_SM = 64, 32, 128


def bound_s(n_bytes: float, ops: dict, sms: int) -> tuple:
    """(the least seconds the card could take for work that moves
    ``n_bytes`` and executes ``ops`` instructions by kind on ``sms`` SMs,
    "bytes" or "operations": whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    clocks = max(ops.get("int", 0) / INT_PER_SM,
                 ops.get("mem", 0) / MEM_PER_SM,
                 sum(ops.values()) / ISSUE_PER_SM)
    t_ops = clocks / (sms * CLOCK_HZ)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bytes(n: int, steps: int, live: int, words: int = 0) -> int:
    """The bytes one K1 launch must move: each env's carry column (570
    words) in and out, its sampler engine in and out, its last actions out
    and its four per-env inputs in; the ball cells its live steps read,
    each map plane (2304 words) at most once; and the records out."""
    ball = min(live * 19 * 4, n * 2304 * 4)
    return n * (2 * 570 * 4 + 8 + 20 + 16) + ball + steps * n * words * 4


def k2_moved_bytes(players: list, in_place: bool = True) -> int:
    """The bytes K2 moves for envs with these player counts: in place, the
    nine words it reads and the words the reset writes (57 a column and 98
    a live player); into a new carry, the words it reads or keeps in and
    the whole column out; and the inputs (the column index in place,
    n_players, player_xy and the three ball rows)."""
    q = len(players)
    written = 57 * q + 98 * sum(players)
    inputs = q * (4 + 8 * 4 + 3 * 4 * 19 * 4 + (4 if in_place else 0))
    if in_place:
        return 4 * (9 * q + written) + inputs
    return 4 * ((570 + 5) * q - written + 570 * q) + inputs


def launch_bytes(work: dict, launches: int, units: float, live: float,
                 n_envs: int) -> float:
    """The bytes of ``launches`` launches doing ``units`` units of work
    (``live`` of them live steps), from the work file's coefficients:
    per launch, per env and launch, per unit, and per live unit up to a
    cap per env and launch (K1's ball reads: each map plane once)."""
    b = work["bytes"]
    live_b = live * b.get("per_live_unit", 0)
    cap = b.get("live_cap_per_env", 0)
    if cap:
        live_b = min(live_b, launches * n_envs * cap)
    return (launches * (b.get("per_launch", 0)
                        + n_envs * b.get("per_env_launch", 0))
            + units * b.get("per_unit", 0) + live_b)


def share(run, kernel: str):
    """``kernel``'s share of its roofline in the traced window, in %: its
    bound for the work it did there over its device time; None where it
    did not run or the run has no trace."""
    tr = run.trace
    if tr is None:
        return None
    work = run.work(kernel)
    spans = tr.kernels(work["trace_name"])
    if not spans:
        return None
    seconds = sum(d for _, d in spans) * 1e-6
    units = run.traced.get(work["unit"], 0)
    if not units or seconds <= 0:
        return None
    live = run.traced.get("live_step", units)
    ops = {k: v * units for k, v in work["ops_per_unit"].items()}
    b = launch_bytes(work, len(spans), units, live, run.n_envs)
    t, _ = bound_s(b, ops, run.sms)
    return 100.0 * t / seconds
