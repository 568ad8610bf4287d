"""How `correct` is decided: the timed path's answers against the plain
reference that the configuration names (`portbench/reference/<name>.py`:
its `judge(run, data)` gives the numbers compared, its `LIMITS` their
limits).  A run that compared no answer is not correct; a batch that
raises ends the run with no result.
"""

from __future__ import annotations

import numpy as np

from portbench import gen


def sample(n: int, cap: int, seed: int) -> np.ndarray:
    """Which of n kept answers are compared: all when n <= cap, else a
    seeded draw of cap of them, in order."""
    if n <= cap:
        return np.arange(n)
    return np.sort(gen.rng(seed, gen.CHECK, 1).choice(n, cap, replace=False))


def verdict(readings: dict, limits: dict, compared: int) -> tuple:
    """-> (correct, the result line's `check` object, the lines for
    standard error): each number beside its limit."""
    check = {name: {"value": int(readings[name]), "limit": limits[name]}
             for name in limits}
    correct = compared > 0 and all(
        c["value"] <= c["limit"] for c in check.values())
    lines = [f"check compared_queries {compared}"]
    lines += [f"check {name} {c['value']} limit {c['limit']}"
              for name, c in check.items()]
    lines.append(f"check correct {str(correct).lower()}")
    return correct, check, lines
