"""Plugin hook engine: registry + the three call conventions.

Mirrors the reference hook dispatcher semantics (``vmq_plugin.erl`` /
``vmq_plugin_mgr.erl``): named hook points, multiple handlers in priority
order, and the call conventions ``only`` (first registered handler),
``all`` (every handler, results ignored), ``all_till_ok`` (auth chains —
first ``ok``/``(ok, changes)`` wins, ``"next"`` falls through, an error
stops the chain; ``vmq_plugin.erl:16-20``). The reference recompiles the
dispatch module at runtime via smerl (``vmq_plugin_mgr.erl:729-747``);
table-driven dispatch is the idiomatic Python equivalent — same observable
behavior, no codegen.

Hook names follow the reference behaviours (vernemq_dev): auth_on_register,
auth_on_publish, auth_on_subscribe, on_register, on_publish, on_subscribe,
on_unsubscribe, on_deliver, on_offline_message, on_client_wakeup,
on_client_offline, on_client_gone, on_message_drop, plus the `_m5` variants
and on_auth_m5. Handlers may be sync or async; the broker awaits async ones.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Tuple

# sentinel return values
NEXT = "next"  # fall through to the next handler in an all_till_ok chain
OK = "ok"


class HookError(Exception):
    def __init__(self, reason: Any):
        super().__init__(str(reason))
        self.reason = reason


class HookRegistry:
    def __init__(self) -> None:
        self._hooks: Dict[str, List[Tuple[int, Callable]]] = {}

    def register(self, name: str, fn: Callable, priority: int = 0) -> None:
        """Register a handler; lower priority runs first (the reference
        orders by plugin registration order)."""
        self._hooks.setdefault(name, []).append((priority, fn))
        self._hooks[name].sort(key=lambda t: t[0])

    def unregister(self, name: str, fn: Callable) -> bool:
        lst = self._hooks.get(name, [])
        for i, (_, f) in enumerate(lst):
            if f is fn:
                del lst[i]
                return True
        return False

    def handlers(self, name: str) -> List[Callable]:
        return [f for _, f in self._hooks.get(name, [])]

    def has(self, name: str) -> bool:
        return bool(self._hooks.get(name))

    async def _call(self, fn: Callable, args: tuple) -> Any:
        res = fn(*args)
        if inspect.isawaitable(res):
            res = await res
        return res

    async def only(self, name: str, *args: Any) -> Any:
        """Call the first registered handler (vmq_plugin:only/2).
        Raises HookError('no_matching_hook_found') when none registered."""
        lst = self._hooks.get(name)
        if not lst:
            raise HookError("no_matching_hook_found")
        return await self._call(lst[0][1], args)

    async def all(self, name: str, *args: Any) -> List[Any]:
        """Call every handler, collect results (vmq_plugin:all/2)."""
        return [await self._call(f, args) for _, f in self._hooks.get(name, [])]

    async def all_till_ok(self, name: str, *args: Any) -> Any:
        """Auth-chain convention (vmq_plugin:all_till_ok/2): handlers return
        ``"ok"`` (accept), ``("ok", modifiers_dict)`` (accept with changes),
        ``"next"`` (ask the next handler), or ``("error", reason)`` /
        raise to reject. No handler registered, or every handler says
        ``next`` → HookError('no_matching_hook_found') — the caller decides
        the default (default-deny for auth, vmq_auth.erl:3-8)."""
        for _, f in self._hooks.get(name, []):
            res = await self._call(f, args)
            if res == NEXT:
                continue
            if res == OK or res is True:
                return OK
            if isinstance(res, tuple) and len(res) == 2 and res[0] == OK:
                return res
            if isinstance(res, tuple) and len(res) == 2 and res[0] == "error":
                raise HookError(res[1])
            raise HookError(res)
        raise HookError("no_matching_hook_found")
