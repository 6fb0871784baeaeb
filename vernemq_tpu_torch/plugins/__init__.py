"""Bundled plugins + the plugin manager.

The reference's plugin manager (``vmq_plugin_mgr.erl``) tracks enabled
app-/module-plugins, persists that set, and rebuilds the dispatch module.
Here the dispatch lives in ``HookRegistry``; the manager tracks enabled
plugin instances by name and drives register/unregister — the surface
behind ``vmq-admin plugin enable/disable/show``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class PluginManager:
    BUNDLED = ("vmq_acl", "vmq_passwd", "vmq_webhooks", "vmq_bridge",
               "vmq_diversity", "vmq_mqtt5_demo_plugin")

    def __init__(self, broker):
        self.broker = broker
        self._enabled: Dict[str, Any] = {}

    def enable(self, name: str, **opts) -> Any:
        """Instantiate + register a bundled plugin
        (vmq_plugin_mgr:enable_plugin)."""
        if name in self._enabled:
            raise ValueError(f"plugin {name} already enabled")
        if name == "vmq_acl":
            from .acl import AclPlugin

            plugin = AclPlugin(acl_file=opts.get("acl_file"))
        elif name == "vmq_passwd":
            from .passwd import PasswdPlugin

            plugin = PasswdPlugin(passwd_file=opts.get("passwd_file"))
        elif name == "vmq_webhooks":
            from .webhooks import WebhooksPlugin

            plugin = WebhooksPlugin(self.broker)
        elif name == "vmq_bridge":
            try:
                from .bridge import BridgePlugin
            except ImportError as e:
                raise ValueError(f"plugin {name} unavailable: {e}") from None
            plugin = BridgePlugin(self.broker, **opts)
        elif name == "vmq_diversity":
            from .scripting import ScriptingPlugin

            plugin = ScriptingPlugin(self.broker, **opts)
        elif name == "vmq_mqtt5_demo_plugin":
            from .mqtt5_demo import Mqtt5DemoPlugin

            plugin = Mqtt5DemoPlugin(self.broker)
        else:
            raise ValueError(f"unknown plugin {name!r}")
        plugin.register(self.broker.hooks)
        self._enabled[name] = plugin
        return plugin

    def disable(self, name: str) -> None:
        plugin = self._enabled.pop(name, None)
        if plugin is None:
            raise ValueError(f"plugin {name} not enabled")
        plugin.unregister(self.broker.hooks)

    async def stop_all(self) -> None:
        """Broker-shutdown hook: bring down every enabled plugin, awaiting
        plugins that hold network links (bridges) so their connections are
        gone before the listeners are reaped."""
        import logging

        for name, plugin in list(self._enabled.items()):
            try:
                stop = getattr(plugin, "stop_all", None)
                if stop is not None:
                    await stop()
                else:
                    plugin.unregister(self.broker.hooks)
            except Exception:
                logging.getLogger("vernemq_tpu_torch.plugins").exception(
                    "plugin %s failed to stop cleanly", name)
            self._enabled.pop(name, None)

    def get(self, name: str) -> Optional[Any]:
        return self._enabled.get(name)

    def show(self) -> List[Tuple[str, str]]:
        return [(name, type(p).__module__) for name, p in self._enabled.items()]
