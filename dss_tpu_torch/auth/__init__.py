"""JWT (RS256) auth: key resolution, claims validation, scope
enforcement, owner injection.  Mirrors the reference's pkg/auth."""

from dss_tpu_torch.auth.jwt import (
    decode_unverified,
    sign_rs256,
    verify_rs256,
)
from dss_tpu_torch.auth.authorizer import (
    Authorizer,
    JWKSResolver,
    StaticKeyResolver,
    require_all_scopes,
    require_any_scope,
)

__all__ = [
    "Authorizer",
    "JWKSResolver",
    "StaticKeyResolver",
    "decode_unverified",
    "require_all_scopes",
    "require_any_scope",
    "sign_rs256",
    "verify_rs256",
]
