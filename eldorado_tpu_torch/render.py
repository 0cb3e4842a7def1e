"""ANSI terminal rendering of environment state.

The reference declares a coloured hex renderer but ships stubs
("Rendering … is a work in progress": src/map.cpp:413, src/cards.cpp:129-134,
src/player.cpp:81-83). This module completes the feature using the
reference's own colour conventions (include/map.h:57-79: requirement glyphs
m/p/c/u/d coloured green/blue/yellow/gray/red; players on red/green/yellow/
blue backgrounds; end hexes on a yellow background).

A copy of ``eldorado_tpu/render.py``. `render_env` reads only
``env.map.obs / player_xy / min_xy``, ``shop_stock``, ``agent``, ``phase``,
``resources`` and ``piles``, so it serves both backends of `compat.cog_env`:
the scalar numpy engine (`core.ref_engine.RefEnv`) and the host snapshot of
the device env.
"""
from __future__ import annotations

import numpy as np

from .constants import GRIDSIZE, Requirement

_RESET = "\x1b[0m"
_REQ_GLYPH = {
    Requirement.MACHETE: ("m", "\x1b[32m"),   # green
    Requirement.PADDLE: ("p", "\x1b[34m"),    # blue
    Requirement.COIN: ("c", "\x1b[33m"),      # yellow
    Requirement.DISCARD: ("u", "\x1b[2m\x1b[37m"),  # gray
    Requirement.REMOVE: ("d", "\x1b[31m"),    # red
}
_PLAYER_BG = ["\x1b[101;30m", "\x1b[102;30m", "\x1b[103;30m", "\x1b[104;30m"]
_END_BG = "\x1b[103;30m"

_CARD_NAMES = [
    "Explorer", "Scout", "Trailblazer", "Pioneer", "Giant machete", "Sailor",
    "Captain", "Traveler", "Photographer", "Journalist", "Treasure chest",
    "Millionaire", "Jack of all trades", "Adventurer", "Prop plane",
    "Transmitter", "Cartographer", "Compass", "Scientist", "Travel log",
    "Native",
]


def _grid_index(xy, min_xy):
    d = np.asarray(xy) - np.asarray(min_xy)
    out = np.where(d >= 0, (d >> 1) + 1, np.where(d == -1, 1, 0))
    return int(out[0]), int(out[1])


def render_map(map_obs, player_xy=None, min_xy=None, n_players=0,
               color=True) -> str:
    """Draw the hex grid row by row (axial rows offset by half a cell)."""
    occupied = {}
    if player_xy is not None and min_xy is not None:
        for p in range(n_players):
            occupied[_grid_index(player_xy[p], min_xy)] = p
    cells = np.asarray(map_obs)
    ys = [y for y in range(GRIDSIZE)
          if cells[:, y, 1:6].any() or any(k[1] == y for k in occupied)]
    xs = [x for x in range(GRIDSIZE)
          if cells[x, :, 1:6].any() or any(k[0] == x for k in occupied)]
    if not ys or not xs:
        return "(empty map)"
    lines = []
    for y in range(max(ys), min(ys) - 1, -1):
        row = [" " * (y - min(ys))]
        for x in range(min(xs), max(xs) + 1):
            cell = cells[x, y]
            req_ch = np.nonzero(cell[1:6])[0]
            p = occupied.get((x, y))
            if len(req_ch) == 0:
                tile = f"{1 + p}· " if p is not None else " · "
                row.append(tile)
                continue
            req = Requirement(int(req_ch[0]))
            n = int(cell[1 + req_ch[0]])
            glyph, col = _REQ_GLYPH[req]
            body = f"{n}{glyph}"
            mark = str(1 + p) if p is not None else " "
            if not color:
                row.append(f"{body}{mark}")
            elif p is not None:
                row.append(f"{col}{body}{_RESET}{_PLAYER_BG[p]}{mark}{_RESET}")
            elif cell[6]:
                row.append(f"{_END_BG}{body} {_RESET}")
            else:
                row.append(f"{col}{body}{_RESET} ")
        lines.append("".join(row))
    return "\n".join(lines)


def render_shop(shop_stock, color=True) -> str:
    from .core.tables import SHOP_CARD_TYPE, SHOP_COST
    rows = ["The shop:"]
    for i in range(len(shop_stock)):
        name = _CARD_NAMES[int(SHOP_CARD_TYPE[i])]
        rows.append(f"  {name:<20} cost {int(SHOP_COST[i])}  "
                    f"stock {int(shop_stock[i])}")
    return "\n".join(rows)


def render_deck(piles, color=True) -> str:
    names = ("draw", "hand", "active", "played", "discard")
    rows = []
    for k, pile in enumerate(np.asarray(piles)):
        cards = [f"{_CARD_NAMES[i]}x{int(c)}" for i, c in enumerate(pile)
                 if c]
        rows.append(f"  {names[k]:<8} {', '.join(cards) if cards else '-'}")
    return "\n".join(rows)


def render_env(env, color=True) -> str:
    """Full frame for a scalar RefEnv (or anything with the same attrs)."""
    parts = ["Current map:\n"]
    parts.append(render_map(env.map.obs, env.map.player_xy, env.map.min_xy,
                            env.n_players, color))
    parts.append("")
    parts.append(render_shop(env.shop_stock, color))
    parts.append(f"\ncurrent player: {env.agent} "
                 f"(phase {int(env.phase)}, resources "
                 f"{np.asarray(env.resources).tolist()})")
    parts.append(render_deck(env.piles[env.agent], color))
    return "\n".join(parts)
