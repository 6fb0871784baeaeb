"""TLS listener support (``vmq_ssl.erl``): server SSLContext construction
from listener options and client-cert → username extraction
(``vmq_ssl.erl:4`` ``socket_to_common_name/1``)."""

from __future__ import annotations

import ssl
from typing import Any, Dict, Optional, Tuple


def make_server_context(opts: Dict[str, Any]) -> ssl.SSLContext:
    """Options follow the reference listener schema: certfile, keyfile,
    cafile, require_certificate, ciphers, tls_version."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    certfile = opts.get("certfile")
    if not certfile:
        raise ValueError("TLS listener needs certfile")
    ctx.load_cert_chain(certfile, opts.get("keyfile") or None)
    cafile = opts.get("cafile")
    if cafile:
        ctx.load_verify_locations(cafile)
    if opts.get("require_certificate"):
        ctx.verify_mode = ssl.CERT_REQUIRED
    elif cafile:
        ctx.verify_mode = ssl.CERT_OPTIONAL
    crl_file = opts.get("crl_file")
    if crl_file:
        # load at startup, not only at the first periodic refresh — a
        # revoked cert must not be accepted during the first
        # crl_refresh_interval window (vmq_crl_srv checks on listener start)
        ctx.load_verify_locations(cafile=crl_file)
        ctx.verify_flags |= ssl.VERIFY_CRL_CHECK_LEAF
    ciphers = opts.get("ciphers")
    if ciphers:
        ctx.set_ciphers(ciphers)
    tls_version = opts.get("tls_version")
    if tls_version:
        minimum = {
            "tlsv1.2": ssl.TLSVersion.TLSv1_2,
            "tlsv1.3": ssl.TLSVersion.TLSv1_3,
        }.get(str(tls_version).lower())
        if minimum is not None:
            ctx.minimum_version = minimum
    return ctx


def make_client_context(opts: Dict[str, Any]) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    cafile = opts.get("cafile")
    if cafile:
        ctx.load_verify_locations(cafile)
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if opts.get("certfile"):
        ctx.load_cert_chain(opts["certfile"], opts.get("keyfile") or None)
    if not opts.get("verify_hostname", False):
        ctx.check_hostname = False
    return ctx


def preauth_from_cert(writer, use_identity_as_username: bool,
                      ssl_context) -> "Tuple[bool, Optional[str]]":
    """Shared TLS identity-mapping policy for all listener types: when
    use_identity_as_username is on, a verified client cert CN is required —
    (ok, username). ok=False → the listener must drop the connection."""
    if not use_identity_as_username or ssl_context is None:
        return True, None
    cn = peer_common_name(writer)
    if cn is None:
        return False, None
    return True, cn


def peer_common_name(writer) -> Optional[str]:
    """CN of the verified client certificate on an asyncio TLS connection
    (socket_to_common_name)."""
    cert = writer.get_extra_info("peercert")
    if not cert:
        return None
    for rdn in cert.get("subject", ()):
        for key, value in rdn:
            if key == "commonName":
                return value
    return None
