"""Hot code upgrade for a running broker.

Reference analog: ``vmq_updo.erl`` — ``updated_modules/0`` diffs every
loaded module's version against the beam file on disk
(vmq_updo.erl:60-71), builds a high-level upgrade script from the
changed set, and ``run/0`` executes it through the release handler;
``dry_run/0`` returns the plan without acting (vmq_updo.erl:25-33).

The BEAM swaps code at the VM level: after a load, every process
executes the new code at its next fully-qualified call, with
``code_change`` migrating state.  CPython has no code server, so this
module reproduces the *effect* with in-place object patching:

1. ``diff()`` — like ``updated_modules/0``: hash each loaded
   ``vernemq_tpu`` module's source on disk against the digest recorded
   when it was loaded/upgraded; return the changed set.
2. ``run(dry_run=True)`` — the upgrade plan without acting
   (``vmq_updo:dry_run/0``).
3. ``run()`` — for each changed module: execute the new source into a
   *scratch* module, then graft it onto the live one.  Functions get
   their ``__code__`` / ``__defaults__`` / ``__kwdefaults__`` swapped
   in place and classes are patched member-by-member, so the OLD
   function/class objects stay canonical; every live reference —
   bound methods on live Session/Queue instances, registered hook
   callables, scheduled timer callbacks — runs the new code on its
   next call, exactly like an Erlang process returning through a
   fully-qualified call after a code swap.

Module-level data follows the BEAM split between code and state:
immutable values (the constants that live in code) are adopted from
the new version; mutable containers and instances (live state — the
process/ETS analog) are kept.  A module may define
``__updo__(old_namespace)`` for anything beyond that — the
``code_change`` analog, run after the graft with the pre-upgrade
namespace (the reference's extra-instruction script file,
vmq_updo.erl:38-47, serves the same role).

What cannot be hot-swapped is reported, never guessed: functions whose
closure cell layout changed (a ``__code__`` swap would corrupt the
cells) land in ``failed`` with the old code left active — mirroring
the release handler refusing a bad instruction rather than
half-applying it.  Native extensions (the ``.so`` codec/kvstore) need
a restart, like NIFs.

Scope note: like the reference's ``vmq-admin`` (which acts on the node
it talks to), an upgrade applies to the PROCESS serving the command.
In multi-process workers mode (broker/workers.py) run ``updo run``
against each worker's admin endpoint — or restart workers one at a
time, which the supervisor already handles.

Top-level side-effect constraint: ``run()`` RE-EXECUTES each changed
module's top-level code (with live siblings visible in ``sys.modules``)
to obtain the new definitions.  Module top-levels must therefore be
side-effect-free beyond defining names — a top-level that registers
hooks/metrics, starts threads, or mutates an imported live registry
would do so a SECOND time against live broker state on every
``updo run``.  This is the same contract the BEAM imposes (module
loading runs no user code; registrations happen in ``start`` callbacks)
— put such effects in an init function or guard them with an
idempotence check, and use ``__updo__`` for upgrade-time migrations.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import sys
import types
from typing import Any

log = logging.getLogger("vernemq_tpu_torch.updo")

# packages under upgrade management; tests may extend temporarily
PREFIXES: tuple = ("vernemq_tpu_torch",)

_IMMUTABLE = (int, float, complex, bool, str, bytes, tuple, frozenset,
              type(None))

_MISSING = object()  # distinguishes "absent in v1" from "was None"

# module name -> digest of the source that produced the loaded code
_loaded_digests: dict[str, str] = {}


def _source_path(mod: types.ModuleType) -> str | None:
    f = getattr(mod, "__file__", None)
    if f and f.endswith(".py"):
        return f
    return None  # native extensions need a restart, like NIFs


def _source_digest(mod: types.ModuleType) -> str | None:
    f = _source_path(mod)
    if not f:
        return None
    try:
        with open(f, "rb") as fh:
            return hashlib.sha1(fh.read()).hexdigest()
    except OSError:
        return None


def _tracked_modules() -> list[tuple[str, types.ModuleType]]:
    out = []
    for name, mod in list(sys.modules.items()):
        if mod is None or name == __name__:
            continue  # the upgrader itself is sticky (code:is_sticky)
        if not any(name == p or name.startswith(p + ".")
                   for p in PREFIXES):
            continue
        if _source_path(mod) is not None:
            out.append((name, mod))
    # parents before children, then stable by name
    out.sort(key=lambda kv: (kv[0].count("."), kv[0]))
    return out


def baseline() -> int:
    """Record the on-disk digest of every loaded module as 'current'.

    Called at boot (and implicitly per-module after each upgrade);
    ``diff()`` is relative to it.  Returns tracked-module count.
    """
    n = 0
    for name, mod in _tracked_modules():
        d = _source_digest(mod)
        if d:
            _loaded_digests[name] = d
            n += 1
    return n


def diff() -> list[str]:
    """Modules whose on-disk source differs from the loaded version
    (``vmq_updo:updated_modules/0``).  Modules first seen now are
    adopted as-loaded (nothing to upgrade)."""
    changed = []
    for name, mod in _tracked_modules():
        d = _source_digest(mod)
        if d is None:
            continue
        if name not in _loaded_digests:
            _loaded_digests[name] = d
        elif _loaded_digests[name] != d:
            changed.append(name)
    return changed


def _patch_function(old: types.FunctionType, new: types.FunctionType,
                    failures: list[str], where: str) -> bool:
    if old.__code__.co_freevars != new.__code__.co_freevars:
        failures.append(f"{where}: closure layout changed "
                        f"({old.__code__.co_freevars} -> "
                        f"{new.__code__.co_freevars})")
        return False
    old.__code__ = new.__code__
    old.__defaults__ = new.__defaults__
    old.__kwdefaults__ = new.__kwdefaults__
    old.__doc__ = new.__doc__
    old.__dict__.update(new.__dict__)
    old.__annotations__ = dict(getattr(new, "__annotations__", {}))
    return True


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, (staticmethod, classmethod)):
        return obj.__func__
    return obj


def _rebind(obj: Any, live_globals: dict, scratch_globals: dict,
            failures: list[str] | None = None, where: str = "?",
            alias: dict[int, Any] | None = None) -> Any:
    """Re-home an object defined during the scratch exec onto the LIVE
    module's globals.  Without this, newly-added functions (and the
    methods of newly-added classes) would read and write the scratch
    namespace — invisible to the running broker.  Only objects whose
    ``__globals__`` IS the scratch dict are touched: functions imported
    from other modules keep their own namespaces.  (Patched old
    functions don't need this: their ``__globals__`` is already the
    live dict and only ``__code__`` is swapped.)  A scratch-global
    CLOSURE cannot be re-homed (its cells would be lost) — it is kept
    as-is but recorded in ``failures`` so the module lands in the
    failed/retryable set instead of reading invisible state silently.
    """
    if isinstance(obj, staticmethod):
        return staticmethod(_rebind(obj.__func__, live_globals,
                                    scratch_globals, failures, where,
                                    alias))
    if isinstance(obj, classmethod):
        return classmethod(_rebind(obj.__func__, live_globals,
                                   scratch_globals, failures, where,
                                   alias))
    if isinstance(obj, property):
        return property(*(f and _rebind(f, live_globals, scratch_globals,
                                        failures, where, alias)
                          for f in (obj.fget, obj.fset, obj.fdel)),
                        doc=obj.__doc__)
    if isinstance(obj, type):
        # a class born in the scratch exec is a fresh object — safe to
        # fix up in place: every scratch-global method gets re-homed,
        # and bases pointing at scratch counterparts of LIVE classes
        # (class New(Existing)) re-parent onto the live ones
        for attr, val in list(vars(obj).items()):
            fixed = _rebind(val, live_globals, scratch_globals,
                            failures, f"{where}.{attr}", alias)
            if fixed is not val:
                try:
                    setattr(obj, attr, fixed)
                except (AttributeError, TypeError):
                    pass
        if alias:
            new_bases = tuple(alias.get(id(b), b) for b in obj.__bases__)
            if new_bases != obj.__bases__:
                try:
                    obj.__bases__ = new_bases
                except TypeError as e:
                    if failures is not None:
                        failures.append(
                            f"{where}: new class inherits a live class "
                            f"but cannot be re-parented onto it: {e}")
        return obj
    if not isinstance(obj, types.FunctionType) \
            or obj.__globals__ is not scratch_globals:
        return obj  # data and foreign functions pass through
    if obj.__closure__ is not None:
        if failures is not None:
            failures.append(
                f"{where}: new closure-bearing function cannot be "
                f"re-homed onto the live module globals")
        return obj
    fn = types.FunctionType(obj.__code__, live_globals, obj.__name__,
                            obj.__defaults__, obj.__closure__)
    fn.__kwdefaults__ = obj.__kwdefaults__
    fn.__qualname__ = obj.__qualname__
    fn.__doc__ = obj.__doc__
    fn.__dict__.update(obj.__dict__)
    fn.__annotations__ = dict(getattr(obj, "__annotations__", {}))
    fn.__module__ = obj.__module__
    return fn


def _is_mutable_data(v: Any) -> bool:
    """Live-state heuristic: plain data that can be mutated in place
    (registries, caches) — the process/ETS analog the graft preserves."""
    return not isinstance(v, (types.FunctionType, type, staticmethod,
                              classmethod, property)) \
        and not isinstance(v, _IMMUTABLE)


def _patch_class(old: type, new: type, failures: list[str],
                 where: str, live_globals: dict,
                 scratch_globals: dict,
                 alias: dict[int, Any] | None = None) -> None:
    for attr, new_val in list(vars(new).items()):
        if attr in ("__dict__", "__weakref__"):
            continue
        old_val = vars(old).get(attr)
        nf, of = _unwrap(new_val), _unwrap(old_val)
        if isinstance(nf, types.FunctionType) \
                and isinstance(of, types.FunctionType) \
                and type(new_val) is type(old_val):
            # in-place __code__ graft only when the wrapper kind matches:
            # a @classmethod -> plain-method (or the reverse) change must
            # adopt the NEW descriptor, or the grafted code runs with the
            # wrong first-argument binding (cls where it expects self)
            _patch_function(of, nf, failures, f"{where}.{attr}")
        elif isinstance(new_val, type) and isinstance(old_val, type):
            _patch_class(old_val, new_val, failures, f"{where}.{attr}",
                         live_globals, scratch_globals, alias)
        elif attr in vars(old) and _is_mutable_data(old_val) \
                and _is_mutable_data(new_val):
            # class-level live state (e.g. a class-attribute registry)
            # is preserved, same rule as module-level data
            pass
        else:
            # new methods, properties, descriptors, constants
            try:
                setattr(old, attr,
                        _rebind(new_val, live_globals, scratch_globals,
                                failures, f"{where}.{attr}", alias))
            except (AttributeError, TypeError) as e:
                failures.append(f"{where}.{attr}: {e}")
    for attr in set(vars(old)) - set(vars(new)):
        if attr.startswith("__") and attr.endswith("__"):
            continue
        try:
            delattr(old, attr)
        except (AttributeError, TypeError):
            pass
    # base-class changes: map scratch-born bases to their live
    # counterparts and swap __bases__; CPython refuses incompatible
    # layouts — that refusal is reported, not guessed around
    new_bases = tuple((alias or {}).get(id(b), b) for b in new.__bases__)
    if old.__bases__ != new_bases:
        try:
            old.__bases__ = new_bases
        except TypeError as e:
            failures.append(f"{where}: base classes changed "
                            f"({old.__bases__} -> {new_bases}) and cannot "
                            f"be swapped live: {e}")


def _exec_fresh(mod: types.ModuleType) -> types.ModuleType:
    """Execute the on-disk source into a scratch module (the loaded
    one is untouched until the graft)."""
    spec = importlib.util.spec_from_file_location(
        mod.__name__, _source_path(mod),
        submodule_search_locations=getattr(mod, "__path__", None))
    fresh = importlib.util.module_from_spec(spec)
    # imports inside the fresh exec must resolve siblings to the LIVE
    # modules (sys.modules), so cross-module references keep identity
    spec.loader.exec_module(fresh)
    return fresh


def _upgrade_module(name: str, report: dict) -> None:
    mod = sys.modules[name]
    old_ns = dict(vars(mod))
    try:
        fresh = _exec_fresh(mod)
    except Exception as e:  # syntax/import error: nothing was touched
        report["failed"][name] = [f"load: {type(e).__name__}: {e}"]
        return

    failures: list[str] = []
    scratch = vars(fresh)
    # scratch object -> live counterpart, for every same-module pair the
    # graft will patch in place; lets base-class swaps resolve a scratch
    # base (class B(A)) to the LIVE patched A
    alias: dict[int, Any] = {
        id(nv): ov
        for attr, nv in scratch.items()
        if not attr.startswith("__")
        for ov in (old_ns.get(attr),)
        # kinds must MATCH: a function->class (or reverse) change is an
        # adoption, not an in-place patch pair
        if (isinstance(ov, type) and isinstance(nv, type))
        or (isinstance(ov, types.FunctionType)
            and isinstance(nv, types.FunctionType))
        if getattr(ov, "__module__", None) == name
    }
    for attr, new_val in scratch.items():
        if attr.startswith("__") and attr != "__updo__":
            continue
        old_val = old_ns.get(attr, _MISSING)
        if new_val is old_val:
            continue  # e.g. an imported live sibling module/object
        if isinstance(old_val, types.FunctionType) \
                and isinstance(new_val, types.FunctionType) \
                and old_val.__module__ == name:
            # old object stays canonical; module keeps exporting it
            _patch_function(old_val, new_val, failures, f"{name}.{attr}")
        elif isinstance(old_val, type) and isinstance(new_val, type) \
                and old_val.__module__ == name:
            _patch_class(old_val, new_val, failures, f"{name}.{attr}",
                         vars(mod), scratch, alias)
        elif attr in old_ns \
                and _is_mutable_data(old_val) and _is_mutable_data(new_val):
            # mutable module state (registries, caches) is preserved;
            # an immutable old value (CONN = None -> CONN = {}) is NOT
            # live state and adopts the new initialiser below
            pass
        else:
            # everything else is the new version's code/constants: new
            # names, changed immutables, and KIND changes (imported
            # helper -> local def, constant -> function, ...) all adopt
            # the new binding
            setattr(mod, attr, _rebind(new_val, vars(mod), scratch,
                                       failures, f"{name}.{attr}", alias))

    removed = []
    for attr, old_val in old_ns.items():
        if attr.startswith("__") or attr in vars(fresh):
            continue
        if getattr(old_val, "__module__", None) == name and \
                isinstance(old_val, (types.FunctionType, type)):
            removed.append(attr)
        try:
            delattr(mod, attr)
        except AttributeError:
            pass

    hook = vars(fresh).get("__updo__")
    if callable(hook):
        try:
            _rebind(hook, vars(mod), scratch,
                    failures, f"{name}.__updo__")(old_ns)
        except Exception as e:
            failures.append(f"{name}.__updo__: {type(e).__name__}: {e}")

    if removed:
        report["removed"][name] = removed
    if failures:
        # partially applied (the patched parts ARE live) — keep the old
        # digest so `updo diff` stays dirty and a fixed source can be
        # re-run; the release handler likewise refuses to mark a bad
        # instruction done
        report["failed"][name] = failures
        return
    d = _source_digest(mod)
    if d:
        _loaded_digests[name] = d
    report["upgraded"].append(name)


def run(dry_run: bool = False) -> dict:
    """Upgrade every changed module (``vmq_updo:run/0``); with
    ``dry_run=True`` return the plan only (``vmq_updo:dry_run/0``)."""
    changed = diff()
    report: dict = {"changed": changed, "upgraded": [], "failed": {},
                    "removed": {}, "dry_run": dry_run}
    if dry_run:
        return report
    for name in changed:
        _upgrade_module(name, report)
        if name in report["failed"]:
            log.warning("updo: %s NOT fully applied: %s", name,
                        "; ".join(report["failed"][name]))
        else:
            log.info("updo: upgraded %s", name)
    return report
