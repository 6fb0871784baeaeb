"""MQTT5 demo plugin: reference implementation of the v5 hook surface,
including the enhanced-auth (AUTH frame) exchange.

Plays the role of ``vmq_mqtt5_demo_plugin`` (229 LoC,
``apps/vmq_mqtt5_demo_plugin/src/vmq_mqtt5_demo_plugin.erl``): a worked
example of ``on_auth_m5`` challenge/response (``:136-159``: method
"method1", data "client1" → CONTINUE with "server1", then "client2" →
SUCCESS with "server2", anything else → NOT_AUTHORIZED) plus
username-triggered special CONNACK outcomes in ``auth_on_register_m5``
(``:45-72``). Used by the v5 test suite the way the reference's
vmq_mqtt5_SUITE drives its demo plugin."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class Mqtt5DemoPlugin:
    AUTH_METHOD = "method1"

    def __init__(self, broker=None):
        self.broker = broker

    # --------------------------------------------------------------- hooks

    def auth_on_register_m5(self, peer, sid, username, password, clean_start):
        if username == "quota_exceeded":
            return ("error", "quota_exceeded")
        if username == "not_authorized":
            return ("error", "not_authorized")
        return "ok"

    def on_auth_m5(self, sid, method: Optional[str], data: Optional[bytes]):
        """Two-round challenge (vmq_mqtt5_demo_plugin.erl:140-159)."""
        if method != self.AUTH_METHOD:
            return ("error", "unexpected_authentication_attempt")
        if data == b"client1":
            return ("ok", {"continue_auth": True,
                           "authentication_data": b"server1"})
        if data == b"client2":
            return ("ok", {"authentication_data": b"server2"})
        return ("error", "not_authorized")

    # ------------------------------------------------------------ plumbing

    HOOKS = ("auth_on_register_m5", "on_auth_m5")

    def register(self, hooks) -> None:
        for name in self.HOOKS:
            hooks.register(name, getattr(self, name))

    def unregister(self, hooks) -> None:
        for name in self.HOOKS:
            hooks.unregister(name, getattr(self, name))
