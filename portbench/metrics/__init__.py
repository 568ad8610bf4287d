"""One reader a metric: `portbench/metrics/<name>.py` holds `read(run)`,
which returns the metric's value from the run (portbench/run.py `Run`),
or None where the run holds nothing to read, and the metric is then
left out of the result line."""
