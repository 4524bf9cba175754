"""Certificate-escalation ladder helpers (port of the JAX package's
``utils/cache.py``; its compilation-cache setup has no PyTorch counterpart)."""
from __future__ import annotations


def ladder_lookup(memo: dict, key, base, retry: int = 64):
    """Memoised escalation rung with periodic base-rung retry.

    A plain dict memo only ever ratchets up: one pathological pair would
    permanently pin the expensive rung for every later same-shaped pair in
    the process. Every ``retry`` uses of an escalated rung the cheap base
    rung is retried once; if it still overflows, the caller's ladder
    re-escalates and ``ladder_store`` restarts the clock.
    """
    ent = memo.get(key)
    if ent is None:
        return base
    rung, uses = ent
    if rung != base and uses >= retry:
        # Restart the clock now, so a failing base retry that re-climbs to
        # the same rung does not trigger another base retry right away.
        memo[key] = (rung, 0)
        return base
    return rung


def next_rung(cap: int, ft: int, max_cap: int, max_ft: int):
    """Budget-first certificate escalation.

    Widening the fallback-tile budget (ft) is cheap — the tier passes are
    count-gated and seeded — while widening the stage-1 cap multiplies the
    whole refinement. Escalate ft x4 first, and only then cap x4.
    """
    if ft < max_ft:
        return cap, min(ft * 4, max_ft)
    return min(cap * 4, max_cap), ft


def ladder_store(memo: dict, key, rung) -> None:
    """Record the rung that certified; count repeat uses for ladder_lookup."""
    ent = memo.get(key)
    if ent is not None and ent[0] == rung:
        memo[key] = (rung, ent[1] + 1)
    else:
        memo[key] = (rung, 0)
