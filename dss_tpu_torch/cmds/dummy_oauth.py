"""Dummy OAuth server: mints RS256 JWTs with caller-chosen claims.

Mirrors cmds/dummy-oauth/main.go:26-96 — GET /token with query params
grant_type, scope, intended_audience, issuer, expire, sub; responds
{"access_token": <jwt>}.  Test infrastructure only.

Run: python -m dss_tpu_torch.cmds.dummy_oauth --addr :8085 \
         --private_key_file build/test-certs/oauth.key
"""

from __future__ import annotations

import argparse
import time

from aiohttp import web

from dss_tpu_torch.auth import jwt as jwtlib


def mint_token(
    private_key,
    *,
    scope: str = "",
    intended_audience: str = "",
    issuer: str = "",
    expire: int = None,
    sub: str = "fake-user",
) -> str:
    claims = {
        "aud": intended_audience,
        "scope": scope,
        "iss": issuer,
        "exp": int(expire if expire is not None else time.time() + 3600),
        "sub": sub,
    }
    return jwtlib.sign_rs256(claims, private_key)


def build_app(private_key_pem: bytes) -> web.Application:
    key = jwtlib.load_private_key(private_key_pem)
    app = web.Application()

    async def token(request):
        q = request.query
        expire = None
        if q.get("expire"):
            try:
                expire = int(q["expire"])
            except ValueError:
                return web.json_response(
                    {"error": f"bad expire param: {q['expire']!r}"},
                    status=400,
                )
        return web.json_response(
            {
                "access_token": mint_token(
                    key,
                    scope=q.get("scope", ""),
                    intended_audience=q.get("intended_audience", ""),
                    issuer=q.get("issuer", ""),
                    expire=expire,
                    sub=q.get("sub", "fake-user"),
                )
            }
        )

    app.router.add_get("/token", token)
    return app


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--addr", default=":8085")
    p.add_argument("--private_key_file", required=True)
    args = p.parse_args()
    with open(args.private_key_file, "rb") as f:
        pem = f.read()
    host, _, port = args.addr.rpartition(":")
    web.run_app(build_app(pem), host=host or "0.0.0.0", port=int(port))


if __name__ == "__main__":
    main()
