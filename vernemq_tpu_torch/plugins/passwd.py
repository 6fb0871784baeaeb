"""Password-file auth plugin.

Mirrors ``apps/vmq_passwd/src/vmq_passwd.erl``: entries ``user:$6$<salt-b64>
$<hash-b64>`` where hash = base64(sha512(password ++ salt))
(``vmq_passwd.erl:126-137,164-172``; the on-disk format is written by the
C tool ``c_src/vmq_passwd.c:166``). ``check`` returns ``next`` for unknown
users (fall through to other auth plugins) and an ``invalid_credentials``
error for a known user with a wrong password (``vmq_passwd.erl:106-119``).
The matching C++ generator tool lives at ``native/vmq_passwd_tool``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import logging
import os
from typing import Dict, Optional, Sequence, Tuple

from ..broker.plugins import NEXT, OK

log = logging.getLogger("vernemq_tpu_torch.passwd")

SALT_LEN = 12


def hash_password(password: bytes, salt: bytes) -> bytes:
    """base64(sha512(password || salt)) — vmq_passwd.erl:167-172."""
    return base64.b64encode(hashlib.sha512(password + salt).digest())


def make_entry(user: str, password: str, salt: Optional[bytes] = None) -> str:
    """One passwd-file line in the reference's `user:$6$salt$hash` format."""
    if salt is None:
        salt = os.urandom(SALT_LEN)
    salt_b64 = base64.b64encode(salt).decode()
    return f"{user}:$6${salt_b64}${hash_password(password.encode(), salt).decode()}"


class PasswdPlugin:
    name = "vmq_passwd"

    def __init__(self, passwd_file: Optional[str] = None):
        self.passwd_file = passwd_file
        # user -> (salt_b64, hash_b64)
        self._entries: Dict[str, Tuple[str, str]] = {}
        if passwd_file:
            self.load_from_file(passwd_file)

    def load_from_file(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            self.load_from_lines(f.read().splitlines())

    def load_from_lines(self, lines: Sequence[str]) -> None:
        entries: Dict[str, Tuple[str, str]] = {}
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            try:
                user, rest = line.split(":", 1)
                if rest.startswith("$2"):
                    # bcrypt entry ($2a/$2b, native/bcrypt.cc) — the
                    # reference accepts these via vmq_diversity's bcrypt
                    from ..native import bcrypt as _bcrypt

                    if not _bcrypt.available():
                        # loud at load time: silently failing every
                        # check() later is an undiagnosable auth outage
                        log.error("passwd entry for %r uses bcrypt but "
                                  "the native bcrypt library is "
                                  "unavailable — this user CANNOT log in",
                                  user)
                    entries[user] = ("bcrypt", rest)
                    continue
                _, six, salt_b64, hash_b64 = rest.split("$")
                if six != "6":
                    raise ValueError(f"unknown hash id {six!r}")
            except ValueError as e:
                log.warning("unparsable passwd line %r: %s", line, e)
                continue
            entries[user] = (salt_b64, hash_b64)
        self._entries = entries

    def check(self, user: Optional[str], password) -> str:
        if user is None or password is None:
            return NEXT
        entry = self._entries.get(user)
        if entry is None:
            return NEXT
        salt_b64, hash_b64 = entry
        pw = password.encode() if isinstance(password, str) else password
        if salt_b64 == "bcrypt":
            from ..native import bcrypt as _bcrypt

            if _bcrypt.checkpw(pw.decode("utf-8", "surrogateescape"),
                               hash_b64):
                return OK
            return ("error", "invalid_credentials")
        want = hash_password(pw, base64.b64decode(salt_b64))
        if hmac.compare_digest(want.decode(), hash_b64):
            return OK
        return ("error", "invalid_credentials")

    # hook: auth_on_register(peer, sid, username, password, clean_start)
    def auth_on_register(self, peer, sid, username, password, clean_start):
        return self.check(username, password)

    def register(self, hooks) -> None:
        hooks.register("auth_on_register", self.auth_on_register)
        hooks.register("auth_on_register_m5", self.auth_on_register)

    def unregister(self, hooks) -> None:
        hooks.unregister("auth_on_register", self.auth_on_register)
        hooks.unregister("auth_on_register_m5", self.auth_on_register)
