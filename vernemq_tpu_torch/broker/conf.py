"""``vernemq.conf``-style configuration file loader.

The reference translates a flat ``key = value`` file through cuttlefish
schemas (``apps/vmq_server/priv/vmq_server.schema``, 217 mappings) into
app envs. This loader keeps the same operator surface — the same knob
names, ``on``/``off`` flags, the full ``listener.*`` tree (global, kind
and per-name option scopes), ``plugins.<name>`` switches, duration
strings (``1w``), millisecond-typed intervals — mapped onto
:class:`~vernemq_tpu.broker.config.Config` without the schema-compiler
machinery. The mapping classification (aliases, unit conversions,
deliberate gaps, compat no-ops) lives in
:mod:`vernemq_tpu.broker.schema`; every documented reference conf line
either works or errors with a reason.

Grammar (one setting per line)::

    # comment                     (also '%%' like the reference's erlang-isms)
    allow_anonymous = off
    listener.max_connections = 10000          # global default
    listener.tcp.proxy_protocol = on          # kind-level default
    listener.tcp.default = 127.0.0.1:1883     # instance address
    listener.tcp.default.allowed_protocol_versions = 3,4,5
    listener.ssl.default.certfile = /etc/ssl/cert.pem
    plugins.vmq_passwd = on
    vmq_passwd.password_file = /etc/vmq.passwd

Listener kinds follow ``vmq_ranch_config.erl:224-227``: ``tcp``/``ssl``
(MQTT), ``ws``/``wss`` (WebSocket), ``http``/``https`` (admin), ``vmq``/
``vmqs`` (cluster data plane).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from . import schema
from .config import DEFAULTS, Config

log = logging.getLogger(__name__)

# conf-file listener kind -> ListenerManager kind (single source:
# schema.INTERNAL_KINDS, shared with the key classifier)
LISTENER_KINDS = schema.INTERNAL_KINDS

# plugin-opt spellings from the reference schemas -> our enable() kwargs
_PLUGIN_OPT_ALIASES = {
    ("vmq_passwd", "password_file"): "passwd_file",
    ("vmq_acl", "acl_file"): "acl_file",
    ("vmq_diversity", "script_dir"): "script_dir",
}

# reference metadata_plugin values -> our backend names
_METADATA_IMPLS = {"vmq_plumtree": "lww", "vmq_swc": "swc",
                   "lww": "lww", "swc": "swc"}


class ConfError(ValueError):
    def __init__(self, lineno: int, line: str, why: str):
        super().__init__(f"conf line {lineno}: {why}: {line!r}")
        self.lineno = lineno


def _strip_listish(raw: str) -> str:
    """The reference writes list values as erlang lists
    (``[vmq_metrics_http, vmq_status_http]``); tolerate the brackets."""
    s = raw.strip()
    if s.startswith("[") and s.endswith("]"):
        s = s[1:-1]
    return s


def _coerce(key: str, raw: str, lineno: int, line: str) -> Any:
    """Coerce ``raw`` to the type of ``DEFAULTS[key]`` (cuttlefish's
    datatype step), honoring the schema layer's unit conversions."""
    if key in schema.DURATION_KEYS:
        try:
            return schema.parse_duration(raw)
        except ValueError as e:
            raise ConfError(lineno, line, str(e)) from None
    proto = DEFAULTS[key]
    if isinstance(proto, bool):
        low = raw.lower()
        if low in ("on", "true", "1", "yes"):
            return True
        if low in ("off", "false", "0", "no"):
            return False
        raise ConfError(lineno, line, f"expected on/off for {key}")
    if isinstance(proto, int) and not isinstance(proto, bool):
        try:
            return int(raw)
        except ValueError:
            raise ConfError(lineno, line,
                            f"expected integer for {key}") from None
    if isinstance(proto, float):
        try:
            return float(raw)
        except ValueError:
            raise ConfError(lineno, line,
                            f"expected number for {key}") from None
    if isinstance(proto, list):
        items = [p.strip() for p in _strip_listish(raw).split(",")
                 if p.strip()]
        if key == "http_modules":
            items = [schema.HTTP_MODULE_ALIASES.get(m, m) for m in items]
        elif key == "reg_views":
            out = []
            for m in items:
                v = schema.REG_VIEW_ALIASES.get(m)
                if v is None:
                    raise ConfError(
                        lineno, line,
                        f"unknown reg view {m!r} (valid: "
                        f"{', '.join(sorted(schema.REG_VIEW_ALIASES))})")
                out.append(v)
            items = out
        return items
    return raw


def _host_port(raw: str, lineno: int, line: str) -> Tuple[str, int]:
    host, sep, port = raw.rpartition(":")
    if not sep:
        raise ConfError(lineno, line, "expected host:port")
    try:
        return host, int(port)
    except ValueError:
        raise ConfError(lineno, line, "bad port") from None


def _listener_opt_value(opt: str, value: str) -> Any:
    if opt == "allowed_protocol_versions":
        return [int(v) for v in _strip_listish(value).split(",")
                if v.strip()]
    if opt in schema.INT_LISTENER_OPTS:
        return int(value)  # ValueError -> ConfError in the caller
    if value.lower() in ("on", "true"):
        return True
    if value.lower() in ("off", "false"):
        return False
    try:
        return int(value)
    except ValueError:
        return value


def parse_conf(text: str) -> Dict[str, Any]:
    """Parse conf text into Config kwargs (including the ``listeners`` and
    ``plugins`` structured keys)."""
    settings: Dict[str, Any] = {}
    listeners: Dict[Tuple[str, str], Dict[str, Any]] = {}
    global_opts: Dict[str, Any] = {}
    kind_opts: Dict[str, Dict[str, Any]] = {}
    plugins: Dict[str, Dict[str, Any]] = {}
    plugin_opts: Dict[str, Dict[str, Any]] = {}

    # first pass: collect declared plugin names so a typo'd option tree
    # (vmq_paswd.password_file) fails loudly instead of being stashed for a
    # plugin that will never exist
    declared_plugins = set()
    for rawline in text.splitlines():
        line = rawline.strip()
        if line.startswith("plugins.") and "=" in line:
            declared_plugins.add(line.split("=")[0].strip().split(".", 1)[1])

    for lineno, rawline in enumerate(text.splitlines(), 1):
        line = rawline.strip()
        if not line or line.startswith("#") or line.startswith("%%"):
            continue
        key, sep, value = line.partition("=")
        if not sep:
            raise ConfError(lineno, line, "expected key = value")
        key = key.strip()
        value = value.strip()
        # strip a trailing comment ('cert.pem  # prod cert')
        if " #" in value:
            value = value.split(" #", 1)[0].strip()

        if key.startswith("listener."):
            try:
                scope, kind, name, opt = schema.classify_listener_key(key)
            except KeyError as e:
                raise ConfError(lineno, line, e.args[0]) from None
            try:
                if scope == "global-opt":
                    global_opts[opt] = _listener_opt_value(opt, value)
                elif scope == "kind-opt":
                    kind_opts.setdefault(kind, {})[opt] = \
                        _listener_opt_value(opt, value)
                elif scope == "addr":
                    ent = listeners.setdefault((kind, name), {"opts": {}})
                    ent["addr"], ent["port"] = _host_port(value, lineno,
                                                          line)
                else:  # name-opt
                    ent = listeners.setdefault((kind, name), {"opts": {}})
                    ent["opts"][opt] = _listener_opt_value(opt, value)
            except ConfError:
                raise
            except ValueError:
                raise ConfError(lineno, line,
                                f"bad value for listener option {opt}") \
                    from None
            continue

        if key.startswith("plugins."):
            rest = key.split(".", 1)[1]
            if "." in rest:
                # plugins.<name>.path / plugins.<name>.priority
                # (vmq_plugin.schema tree): external-plugin load options
                name, popt = rest.split(".", 1)
                if popt not in ("path", "priority"):
                    raise ConfError(lineno, line,
                                    f"unknown plugin option {popt!r} "
                                    "(valid: path, priority)")
                pv: Any = value
                if popt == "priority":
                    try:
                        pv = int(value)
                    except ValueError:
                        raise ConfError(lineno, line,
                                        "expected integer priority") \
                            from None
                plugin_opts.setdefault(name, {})[popt] = pv
                if name in plugins:
                    plugins[name] = plugin_opts[name]
                continue
            name = rest
            low = value.lower()
            if low in ("on", "true"):
                plugins[name] = plugin_opts.setdefault(name, {})
            elif low in ("off", "false"):
                plugins.pop(name, None)
            else:
                raise ConfError(lineno, line, "expected on/off")
            continue

        head = key.split(".", 1)[0]
        if (head.startswith("vmq_") and head not in DEFAULTS
                and key not in schema.FLAT_ALIASES):
            # plugin option tree (vmq_passwd.password_file = ...)
            if head not in declared_plugins:
                raise ConfError(lineno, line,
                                f"options for undeclared plugin {head} "
                                f"(missing plugins.{head} = on?)")
            opt = key.split(".", 1)[1]
            opt = _PLUGIN_OPT_ALIASES.get((head, opt), opt)
            plugin_opts.setdefault(head, {})[opt] = value
            if head in plugins:
                plugins[head] = plugin_opts[head]
            continue

        if key == "vmq_swc.db_backend" or key == "swc_db_backend":
            # reference engine names map onto the default native engine;
            # kvstore/bucketed select ours explicitly (cluster/swc_db.py)
            val = {"leveldb": "kvstore", "rocksdb": "kvstore",
                   "leveled": "kvstore", "kvstore": "kvstore",
                   "bucketed": "bucketed"}.get(value)
            if val is None:
                raise ConfError(lineno, line, "unknown swc db backend")
            settings["swc_db_backend"] = val
            continue

        if key == "metadata_plugin":
            impl = _METADATA_IMPLS.get(value)
            if impl is None:
                raise ConfError(lineno, line, "unknown metadata_plugin")
            settings[key] = impl
            continue

        if key in ("plugins", "listeners"):
            # loader-internal structured keys — only the dotted forms
            # (plugins.<name>, listener.<kind>.<name>) are valid conf lines
            raise ConfError(lineno, line,
                            f"'{key}' is not settable directly; use "
                            f"{'plugins.<name> = on' if key == 'plugins' else 'listener.<kind>.<name> = ip:port'}")
        gap = schema.GAPS.get(key)
        if gap is not None:
            raise ConfError(lineno, line, f"deliberate gap: {gap}")
        key = schema.FLAT_ALIASES.get(key, key)
        if key not in DEFAULTS:
            raise ConfError(lineno, line, f"unknown config key {key}")
        if key in schema.COMPAT_NOOPS:
            log.info("conf: %s accepted for compatibility: %s",
                     key, schema.COMPAT_NOOPS[key])
        coerced = _coerce(key, value, lineno, line)
        if key in schema.MS_TO_SECONDS:
            # reference datatype is milliseconds; internal knob is
            # seconds. 0 stays 0 (= disabled in the reference schema);
            # any non-zero value rounds to at least 1s
            if isinstance(DEFAULTS[key], float):
                coerced = coerced / 1000.0
            elif coerced <= 0:
                coerced = 0
            else:
                coerced = max(1, int(round(coerced / 1000.0)))
        settings[key] = coerced

    if (global_opts or kind_opts) and not listeners:
        # option defaults with no listener address line are legal
        # cuttlefish (they set app envs), but here nothing will consume
        # them — warn loudly instead of leaving the operator's cap inert
        orphan = list(global_opts) + [k for d in kind_opts.values()
                                      for k in d]
        log.warning("conf: listener option default(s) %s given but no "
                    "listener address line (listener.<kind>.<name> = "
                    "ip:port) — they apply to no listener",
                    ", ".join(sorted(set(orphan))))
    if listeners or global_opts or kind_opts:
        for (kind, name), ent in listeners.items():
            if "port" not in ent:
                # opts-only listener = typo'd name or missing address line;
                # refuse rather than bind an unconfigured ephemeral socket
                raise ConfError(
                    0, f"listener.{kind}.{name}",
                    "listener has options but no address line")
        settings["listeners"] = [
            {"kind": LISTENER_KINDS[kind], "name": name,
             "addr": ent.get("addr", "127.0.0.1"), "port": ent["port"],
             # option precedence: instance > kind default > global default
             "opts": {**global_opts, **kind_opts.get(kind, {}),
                      **ent["opts"]}}
            for (kind, name), ent in listeners.items()
        ]
    if plugins:
        settings["plugins"] = [
            {"name": n, "opts": o} for n, o in plugins.items()
        ]
    return settings


def load_conf_file(path: str) -> Config:
    with open(path, "r", encoding="utf-8") as fh:
        return Config(**parse_conf(fh.read()))
