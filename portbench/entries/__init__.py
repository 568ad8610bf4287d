"""How each configuration's `entry` builds the system under test.

`portbench/entries/<entry>.py` holds one class, `Entry(cfg, data,
device)`, whose set-up loads the recipe's data into the port.
`prepare(queries)` turns a batch into the arguments the deployed caller
hands the port (made before the window), and `query(args)` is the one
call the driver times per batch, as the span named `span`.
`keep(answers, positions)` keeps the answers at those positions for the
check, as objects no garbage collection walks (strings, NumPy arrays);
`counters()` reads the program's own counters; `close()` frees the
program.
"""
