"""The benchmark's plain references (NumPy only; nothing of the
program).  A configuration names one: `portbench/reference/<name>.py`
holds `LIMITS` (each number compared and its limit), `judge(run,
data)` -> (answers compared, {number: reading}) once the window has
closed and the program is freed, and `control(cell, recipe, seed)`,
the control of `python3 -m portbench.control`."""
