"""Request authorization: key resolution + claims validation + scopes.

Mirrors pkg/auth: key resolvers from PEM files or a JWKS endpoint with
periodic refresh (auth.go:73-149, 258-277), token verification against
every cached key (auth.go:303-317), claims rules (claims.go:43-60:
non-empty sub, exp <= 1h out, non-empty iss), audience check
(auth.go:319-322), and per-operation scope validators
(RequireAllScopes/RequireAnyScope, auth.go:151-218).  Invalid token ->
UNAUTHENTICATED; missing scopes -> PERMISSION_DENIED.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

from dss_tpu_torch import errors
from dss_tpu_torch.auth import jwt as jwtlib

MAX_TOKEN_LIFETIME_S = 3600  # claims.go:49-52


# -- scope validators --------------------------------------------------------


class ScopesValidator:
    def validate(self, scopes: set) -> None:
        raise NotImplementedError


class _RequireAll(ScopesValidator):
    def __init__(self, required: Iterable[str]):
        self.required = set(required)

    def validate(self, scopes: set) -> None:
        missing = self.required - scopes
        if missing:
            raise errors.permission_denied(
                "missing required scopes: " + ", ".join(sorted(missing))
            )


class _RequireAny(ScopesValidator):
    def __init__(self, accepted: Iterable[str]):
        self.accepted = set(accepted)

    def validate(self, scopes: set) -> None:
        if not (self.accepted & scopes):
            raise errors.permission_denied(
                "missing any of required scopes: "
                + ", ".join(sorted(self.accepted))
            )


def require_all_scopes(*scopes: str) -> ScopesValidator:
    return _RequireAll(scopes)


def require_any_scope(*scopes: str) -> ScopesValidator:
    return _RequireAny(scopes)


# -- key resolvers -----------------------------------------------------------


class StaticKeyResolver:
    """Fixed public keys from PEM blobs/files (auth.go FromFileKeyResolver)."""

    def __init__(self, pems: List[bytes]):
        self._keys = [jwtlib.load_public_key(p) for p in pems]

    @classmethod
    def from_files(cls, paths: List[str]) -> "StaticKeyResolver":
        pems = []
        for p in paths:
            with open(p, "rb") as f:
                pems.append(f.read())
        return cls(pems)

    def resolve(self) -> list:
        return list(self._keys)


def _jwk_to_public_key(jwk: dict):
    """RSA JWK {n, e} -> public key object."""
    from cryptography.hazmat.primitives.asymmetric import rsa as _rsa

    def u64(s):
        return int.from_bytes(jwtlib._b64url_decode(s), "big")

    return _rsa.RSAPublicNumbers(u64(jwk["e"]), u64(jwk["n"])).public_key()


class JWKSResolver:
    """Public keys from a JWKS document (auth.go JWKSResolver).

    `fetch` is injectable (no-egress tests use a canned document);
    the default fetcher GETs the endpoint with urllib.
    """

    def __init__(
        self,
        endpoint: str,
        key_ids: Optional[List[str]] = None,
        fetch: Optional[Callable[[str], dict]] = None,
    ):
        self.endpoint = endpoint
        self.key_ids = set(key_ids) if key_ids else None
        self._fetch = fetch or self._default_fetch
    @staticmethod
    def _default_fetch(endpoint: str) -> dict:
        import json
        import urllib.request

        with urllib.request.urlopen(endpoint, timeout=10) as r:
            return json.loads(r.read())

    def resolve(self) -> list:
        doc = self._fetch(self.endpoint)
        keys = []
        for jwk in doc.get("keys", []):
            if jwk.get("kty") != "RSA":
                continue
            if self.key_ids is not None and jwk.get("kid") not in self.key_ids:
                continue
            keys.append(_jwk_to_public_key(jwk))
        if not keys:
            raise ValueError(f"no usable RSA keys in JWKS from {self.endpoint}")
        return keys


# -- authorizer --------------------------------------------------------------



def _same_keys(a: list, b: list) -> bool:
    """Key-set equality by public numbers (key objects are recreated
    on every JWKS resolve, so identity never matches)."""
    if len(a) != len(b):
        return False
    try:
        return [k.public_numbers() for k in a] == [
            k.public_numbers() for k in b
        ]
    except Exception:  # non-RSA key objects: be conservative
        return False


class Authorizer:
    """Validates bearer tokens and enforces per-operation scopes.

    scopes_table maps operation name (the reference's full RPC method
    name, e.g. "/ridpb.DiscoveryAndSynchronizationService/
    CreateIdentificationServiceArea") to a ScopesValidator.  Operations
    absent from the table require only a valid token (reference
    behavior: missing validator -> no scope check, auth.go:333-339).
    """

    def __init__(
        self,
        resolver,
        audiences: List[str],
        scopes_table: Optional[Dict[str, ScopesValidator]] = None,
        *,
        refresh_interval_s: Optional[float] = None,
        now: Callable[[], float] = time.time,
    ):
        self._resolver = resolver
        self.audiences = list(audiences)
        self.scopes_table = dict(scopes_table or {})
        self.now = now
        self._lock = threading.RLock()
        self._keys = resolver.resolve()
        # successful-signature cache: RS256 verify costs ~40 us of RSA
        # math per call and USS tokens repeat for up to an hour, so
        # cache token -> payload per key GENERATION (any key swap bumps
        # the generation and orphans old entries).  Claims (exp/nbf/
        # aud/scopes) are still validated on EVERY request downstream —
        # only the pure signature->payload function is cached.  Only
        # successes are cached (a flood of distinct bad tokens can't
        # grow it) and the size is capped.
        self._sig_gen = 0
        self._sig_cache: Dict[str, dict] = {}
        self._stop = threading.Event()
        self._refresher = None
        if refresh_interval_s:
            self._refresher = threading.Thread(
                target=self._refresh_loop,
                args=(refresh_interval_s,),
                daemon=True,
            )
            self._refresher.start()

    def close(self):
        self._stop.set()

    def _refresh_loop(self, interval: float):
        # key hot-swap goroutine analog (auth.go:258-277)
        while not self._stop.wait(interval):
            try:
                keys = self._resolver.resolve()
                with self._lock:
                    changed = not _same_keys(keys, self._keys)
                    self._keys = keys
                    if changed:
                        # flush only on a REAL rotation: periodic
                        # refreshes resolving the same keys must not
                        # discard an hour's worth of cached verifies
                        self._sig_gen += 1
                        self._sig_cache = {}
            except Exception:
                pass  # keep serving the previous keys

    def refresh_keys(self):
        keys = self._resolver.resolve()
        with self._lock:
            changed = not _same_keys(keys, self._keys)
            self._keys = keys
            if changed:
                self._sig_gen += 1
                self._sig_cache = {}

    # -- the per-request path ------------------------------------------------

    _SIG_CACHE_MAX = 4096

    def _verify_signature(self, token: str) -> dict:
        with self._lock:
            keys = list(self._keys)
            gen = self._sig_gen
            cache = self._sig_cache
        hit = cache.get(token)
        if hit is not None:
            return hit  # payload is treated read-only downstream
        last = None
        for key in keys:
            try:
                payload = jwtlib.verify_rs256(token, key)
            except jwtlib.JWTError as e:
                last = e
                continue
            with self._lock:
                if gen == self._sig_gen:  # keys unchanged since verify
                    if len(self._sig_cache) >= self._SIG_CACHE_MAX:
                        # evict the oldest ~25% (dict preserves
                        # insertion order) instead of flushing: a
                        # wholesale clear made every live token in the
                        # fleet re-pay the ~40us RSA verify at once — a
                        # periodic re-verification stampede at the cap
                        drop = max(1, self._SIG_CACHE_MAX // 4)
                        for k in list(self._sig_cache)[:drop]:
                            del self._sig_cache[k]
                    self._sig_cache[token] = payload
            return payload
        raise errors.unauthenticated(f"invalid token: {last}")

    def _validate_claims(self, payload: dict) -> None:
        if not payload.get("sub"):
            raise errors.unauthenticated("missing or empty subject")
        exp = payload.get("exp")
        if exp is None:
            raise errors.unauthenticated("missing token expiry")
        now = self.now()
        try:
            exp = float(exp)
        except (TypeError, ValueError):
            raise errors.unauthenticated("bad token expiry")
        if exp < now:
            raise errors.unauthenticated("token is expired")
        if exp > now + MAX_TOKEN_LIFETIME_S:
            raise errors.unauthenticated(
                "token expiration time is too far in the future, "
                "max token duration is 1 hour"
            )
        nbf = payload.get("nbf")
        if nbf is not None:
            try:
                nbf = float(nbf)
            except (TypeError, ValueError):
                raise errors.unauthenticated("bad token nbf")
            if nbf > now:
                raise errors.unauthenticated("token not yet valid")
        if not payload.get("iss"):
            raise errors.unauthenticated("missing Issuer URI")
        aud = payload.get("aud", "")
        if aud not in self.audiences:
            raise errors.unauthenticated(
                f'invalid token audience: "{aud}"'
            )

    @staticmethod
    def scopes_of(payload: dict) -> set:
        raw = payload.get("scope", "")
        if isinstance(raw, str):
            return {s for s in raw.split(" ") if s}
        if isinstance(raw, list):
            return set(raw)
        return set()

    def authorize(self, authorization_header: Optional[str], operation: str) -> str:
        """-> owner (the `sub` claim).  Raises StatusError on failure."""
        if not authorization_header:
            raise errors.unauthenticated("missing token")
        parts = authorization_header.split(" ")
        if len(parts) != 2 or parts[0].lower() != "bearer":
            raise errors.unauthenticated("missing or malformed bearer token")
        payload = self._verify_signature(parts[1])
        self._validate_claims(payload)
        validator = self.scopes_table.get(operation)
        if validator is not None:
            validator.validate(self.scopes_of(payload))
        return str(payload["sub"])
