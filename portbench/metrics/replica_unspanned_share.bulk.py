"""replica_unspanned_share.bulk: % of the window inside the harness's
`query_batch` calls that no phase span of the program covers: what the
spans miss (portbench/phases.py)."""

from portbench.phases import unspanned_share as read  # noqa: F401
