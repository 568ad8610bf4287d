"""How each traffic mix's `driver` offers its load.

`portbench/drivers/<driver>.py` holds `drive(run)`: it makes the mix's
queries from the seed, warms the shapes the mix uses, calls
`run.open()` when the measured window starts and `run.close()` when
its last request has returned, and leaves on `run` what the metric
readers and the check read (see `portbench/run.py` `Run`).
"""
