"""Certificate-escalation ladder helpers (port of the JAX package's
``utils/cache.py``, less its compilation-cache setup) and ``climb``."""
from __future__ import annotations

import typing


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


def climb(run: typing.Callable, base: typing.Tuple[int, int], max_cap: int,
          max_ft: int, memo: typing.Optional[dict] = None, key=None):
    """The certificate ladder: ``run(cap, ft)``, which returns ``(result,
    overflow)`` with ``overflow`` a host bool, from ``base`` (with a
    ``memo``, the rung ``ladder_lookup`` gives under ``key``) up
    ``next_rung``'s rungs until one is exact; returns ``(result, rung)``
    and, with a ``memo``, ``ladder_store``s that rung."""
    rung = base if memo is None else ladder_lookup(memo, key, base)
    while True:
        result, overflow = run(*rung)
        # Exact iff the certificate passed, or stage 1 refined every search
        # chunk (cap >= max_cap): then no chunk is left that could hold a
        # nearer point, whatever the certificate says.
        if not overflow or rung[0] >= max_cap:
            if memo is not None:
                ladder_store(memo, key, rung)
            return result, rung
        rung = next_rung(*rung, max_cap, max_ft)
