"""Binaries: the DSS server and the dummy OAuth token minter
(analogs of cmds/grpc-backend + cmds/http-gateway and
cmds/dummy-oauth)."""

from __future__ import annotations


def make_ssl_context(tls_cert: str, tls_key: str):
    """An aiohttp server ssl_context from --tls_cert/--tls_key (None
    when TLS is off; both-or-neither enforced).  Lives here — not in
    cmds.server — so the region log server can use it without pulling
    the full serving stack (torch included) into its process."""
    if not tls_cert and not tls_key:
        return None
    if not (tls_cert and tls_key):
        raise SystemExit("--tls_cert and --tls_key must be given together")
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(tls_cert, tls_key)
    return ctx
