"""Observability of the port: request tracing (obs/trace.py), the
per-stage timing sink (obs/stages.py), JSON logging with the access-log
middleware (obs/logging.py) and the Prometheus metrics registry
(obs/metrics.py), copies of the reference's `dss_tpu/obs` modules."""

from dss_tpu_torch.obs.logging import configure_logging, get_logger
from dss_tpu_torch.obs.metrics import MetricsRegistry

__all__ = ["configure_logging", "get_logger", "MetricsRegistry"]
