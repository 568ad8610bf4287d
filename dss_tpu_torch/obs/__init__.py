"""Observability of the port: request tracing (obs/trace.py) and the
per-stage timing sink (obs/stages.py), copies of the reference's
`dss_tpu/obs` modules.  Logging and the metrics registry come with the
API slice."""
