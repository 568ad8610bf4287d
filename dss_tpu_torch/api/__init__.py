"""REST gateway (aiohttp): the ASTM OpenAPI surface of the reference's
http-gateway + grpc-backend pair, collapsed into one process."""

from dss_tpu_torch.api.app import build_app, RID_SCOPES, SCD_SCOPES

__all__ = ["build_app", "RID_SCOPES", "SCD_SCOPES"]
