"""Minimal RS256 JWT encode/verify on top of `cryptography`.

The reference uses dgrijalva/jwt-go (pkg/auth/auth.go:303-317,
cmds/dummy-oauth/main.go:72-87); this is the same wire format
(base64url(header).base64url(payload).base64url(sig), RSASSA-PKCS1-v1_5
with SHA-256) without pulling in a JWT dependency.
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Tuple

# `cryptography` is an optional dependency: token signing/verification
# needs it, but importing this module (and everything above it — the
# authorizer, the app builder) must not, so no-auth deployments and
# environments without the wheel still serve.  Every entry point that
# actually touches RSA goes through _crypto() and fails as a JWTError.
try:  # pragma: no cover - exercised implicitly by both environments
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    _CRYPTO_ERR = None
except ImportError as _e:  # noqa: N816
    InvalidSignature = hashes = serialization = padding = rsa = None
    _CRYPTO_ERR = _e


class JWTError(Exception):
    pass


def crypto_available() -> bool:
    """True when the `cryptography` wheel is importable."""
    return _CRYPTO_ERR is None


def _crypto() -> None:
    """Raise JWTError when RSA primitives are unavailable."""
    if _CRYPTO_ERR is not None:
        raise JWTError(
            f"cryptography is not installed ({_CRYPTO_ERR}); "
            "RS256 sign/verify is unavailable"
        )


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(s: str) -> bytes:
    pad = (-len(s)) % 4
    try:
        return base64.urlsafe_b64decode(s + "=" * pad)
    except Exception as e:
        raise JWTError(f"bad base64url segment: {e}")


def load_private_key(pem: bytes) -> "rsa.RSAPrivateKey":
    _crypto()
    key = serialization.load_pem_private_key(pem, password=None)
    if not isinstance(key, rsa.RSAPrivateKey):
        raise JWTError("private key is not RSA")
    return key


def load_public_key(pem: bytes):
    """Accept either a public key PEM or a certificate PEM."""
    _crypto()
    try:
        key = serialization.load_pem_public_key(pem)
    except ValueError:
        from cryptography import x509

        key = x509.load_pem_x509_certificate(pem).public_key()
    if not isinstance(key, rsa.RSAPublicKey):
        raise JWTError("public key is not RSA")
    return key


def sign_rs256(claims: dict, private_key, kid: Optional[str] = None) -> str:
    _crypto()
    header = {"alg": "RS256", "typ": "JWT"}
    if kid is not None:
        header["kid"] = kid
    if isinstance(private_key, (bytes, str)):
        if isinstance(private_key, str):
            private_key = private_key.encode()
        private_key = load_private_key(private_key)
    signing_input = (
        _b64url_encode(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url_encode(json.dumps(claims, separators=(",", ":")).encode())
    )
    sig = private_key.sign(
        signing_input.encode("ascii"), padding.PKCS1v15(), hashes.SHA256()
    )
    return signing_input + "." + _b64url_encode(sig)


def split(token: str) -> Tuple[dict, dict, str, bytes]:
    """-> (header, payload, signing_input, signature)."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JWTError("token must have three segments")
    try:
        header = json.loads(_b64url_decode(parts[0]))
        payload = json.loads(_b64url_decode(parts[1]))
    except (ValueError, JWTError) as e:
        raise JWTError(f"bad token encoding: {e}")
    if not isinstance(header, dict) or not isinstance(payload, dict):
        raise JWTError("header/payload must be JSON objects")
    return header, payload, parts[0] + "." + parts[1], _b64url_decode(parts[2])


def decode_unverified(token: str) -> Tuple[dict, dict]:
    header, payload, _, _ = split(token)
    return header, payload


def verify_rs256(token: str, public_key) -> dict:
    """Verify signature; returns the payload.  Claims semantics (exp,
    iss, aud, scopes) are the Authorizer's job."""
    _crypto()
    header, payload, signing_input, sig = split(token)
    if header.get("alg") != "RS256":
        raise JWTError(f"unsupported alg: {header.get('alg')!r}")
    if isinstance(public_key, (bytes, str)):
        if isinstance(public_key, str):
            public_key = public_key.encode()
        public_key = load_public_key(public_key)
    try:
        public_key.verify(
            sig, signing_input.encode("ascii"), padding.PKCS1v15(), hashes.SHA256()
        )
    except InvalidSignature:
        raise JWTError("signature verification failed")
    return payload
