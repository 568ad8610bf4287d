"""Service layer: RID application logic + SCD handlers.

The analog of pkg/rid/{server,application} and pkg/scd in the
reference: owner/version fencing prechecks, time-range adjustment,
quotas, notification fanout, OVN key checks, and proto-JSON-shaped
request/response assembly for the REST gateway.
"""
