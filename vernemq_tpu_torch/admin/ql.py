"""vmq_ql — SQL-ish SELECT over live broker rows.

The reference ships a small query language (``apps/vmq_ql``,
``vmq_ql_query.erl:146-178``) used by ``vmq-admin session show``: rows are
built lazily from live sessions/queues/subscriptions via row initializers
(``vmq_info.erl:24-66``) and filtered by a WHERE expression. This module
reproduces that: ``session_rows`` is the row initializer; ``query`` parses
``SELECT f1,f2 FROM sessions WHERE x=1 AND (y>2 OR z!=3) LIMIT n``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional


def session_rows(broker) -> Iterator[Dict[str, Any]]:
    """One row per (queue, session) pair — offline queues included, like the
    reference's session listing which walks queues (vmq_info.erl:24-66)."""
    for sid, queue in list(broker.registry.queues.items()):
        mountpoint, client_id = sid
        base = {
            "client_id": client_id,
            "mountpoint": mountpoint,
            "node": broker.node_name,
            "queue_state": queue.state,
            "offline_messages": len(queue.offline),
            "queue_size": len(queue.offline),
            "deliver_mode": queue.opts.deliver_mode,
            "queue_started_at": queue.created,
            "is_offline": queue.state == "offline",
            "num_sessions": len(queue.sessions),
        }
        session = broker.sessions.get(sid)
        if session is None:
            yield {**base, "is_online": False, "user": None,
                   "peer_host": None, "peer_port": None, "protocol": None,
                   "clean_session": queue.opts.clean_session,
                   "waiting_acks": 0}
        else:
            info = session.info()
            yield {**base, "is_online": True, **info}


def subscription_rows(broker) -> Iterator[Dict[str, Any]]:
    for sid, subs in list(broker.registry.subscriptions.items()):
        rec = broker.registry.db.read(sid)
        node = rec.node if rec is not None else broker.node_name
        for words, opts in subs.items():
            yield {
                "client_id": sid[1], "mountpoint": sid[0],
                "topic": "/".join(words), "qos": opts.qos, "node": node,
                "no_local": getattr(opts, "no_local", False),
                "rap": getattr(opts, "retain_as_published", False),
            }


def retain_rows(broker) -> Iterator[Dict[str, Any]]:
    for mp, words, rm in broker.retain.items(None):  # every mountpoint
        payload = getattr(rm, "payload", b"")
        yield {"mountpoint": mp, "topic": "/".join(words),
               "payload": payload.decode("latin1"),
               "payload_size": len(payload),
               "qos": getattr(rm, "qos", 0)}


def retained_index_rows(broker) -> Iterator[Dict[str, Any]]:
    """Device retained-index rows (vernemq_tpu_torch/retained/): one row per
    mirrored retained topic, with its device slot and sync state —
    operators diff this against the ``retain`` table (the host store) to
    inspect device-vs-host convergence. Overflow (> L level) topics show
    slot -1: they are host-matched by design."""
    eng = getattr(broker, "_retained_engine", None)
    if eng is None:
        return
    for mp, idx in list(eng._indexes.items()):
        with idx.lock:
            entries = list(idx.table.entries)
            dirty = set(idx.table.dirty)
            overflow = list(idx.table.overflow)
            resized = idx.table.resized  # same snapshot as the rows
        for slot, e in enumerate(entries):
            if e is None:
                continue
            topic, _value = e
            yield {"mountpoint": mp, "slot": slot,
                   "topic": "/".join(topic),
                   "synced": slot not in dirty and not resized}
        for topic in overflow:
            yield {"mountpoint": mp, "slot": -1, "topic": "/".join(topic),
                   "synced": False}


def queue_rows(broker) -> Iterator[Dict[str, Any]]:
    """Queue-level rows without the session join (the reference's
    ``queues`` table over queue_base, vmq_info.erl:34-50)."""
    for sid, queue in list(broker.registry.queues.items()):
        mountpoint, client_id = sid
        yield {
            "client_id": client_id,
            "mountpoint": mountpoint,
            "node": broker.node_name,
            "statename": queue.state,
            "queue_size": len(queue.offline),
            "offline_messages": len(queue.offline),
            "online_messages": sum(
                len(getattr(s, "inflight", ())) for s in queue.sessions),
            "deliver_mode": queue.opts.deliver_mode,
            "is_offline": queue.state == "offline",
            "is_online": queue.state != "offline",
            "num_sessions": len(queue.sessions),
            "clean_session": queue.opts.clean_session,
            "started_at": queue.created,
        }


def message_rows(broker) -> Iterator[Dict[str, Any]]:
    """Offline message rows (the reference's ``message_refs`` +
    ``messages`` tables, vmq_info.erl:69-81)."""
    for sid, queue in list(broker.registry.queues.items()):
        mountpoint, client_id = sid
        for msg in list(queue.offline):
            yield {
                "client_id": client_id,
                "mountpoint": mountpoint,
                "node": broker.node_name,
                "msg_ref": msg.msg_ref.hex(),
                "msg_qos": msg.qos,
                "routing_key": "/".join(msg.topic),
                "dup": msg.dup,
                "payload": msg.payload.decode("latin1"),
                "payload_size": len(msg.payload),
            }


def payload_schema_rows(broker) -> Iterator[Dict[str, Any]]:
    """Registered payload schemas (vernemq_tpu_torch/filters/): one row per
    (mountpoint, topic filter) with the field layout predicates
    compile against."""
    sr = getattr(broker, "schema_registry", None)
    if sr is None:
        return
    for s in sr.schemas():
        yield {"mountpoint": s.mountpoint, "topic": s.filter_str,
               "fields": s.fields_spec(), "width": s.width}


def filter_window_rows(broker) -> Iterator[Dict[str, Any]]:
    """Open aggregation windows: one row per (subscription, topic)
    accumulator slot — count/sum/min/max as currently folded."""
    eng = getattr(broker, "filter_engine", None)
    if eng is None:
        return
    with eng._lock:
        win = eng._win
        items = list(win.slot_of.items())
        acc = win.acc.copy()
    for _key, slot in items:
        meta = win.meta[slot]
        if meta is None:
            continue
        c = float(acc[slot][0])
        yield {"mountpoint": meta.mountpoint,
               "topic": "/".join(meta.topic),
               "subscriber": str(meta.sub_key),
               "filter": meta.expr,
               "window": meta.agg.window_label,
               "count": int(c),
               "sum": round(float(acc[slot][1]), 6),
               "min": round(float(acc[slot][2]), 6) if c else None,
               "max": round(float(acc[slot][3]), 6) if c else None}


def event_rows(broker) -> Iterator[Dict[str, Any]]:
    """Control-plane journal events (observability/events.py): one row
    per state-machine transition — queryable by code/subsystem/time,
    e.g. ``SELECT * FROM events WHERE code = 'breaker_open'``."""
    from ..observability import events as _events

    for e in _events.journal().snapshot():
        sub, _help = _events.KNOWN_EVENTS.get(e["code"], ("?", ""))
        yield {"t": round(e["t"], 6), "ts": round(e["ts"], 3),
               "code": e["code"], "subsystem": sub,
               "detail": e["detail"], "value": e["value"],
               "pid": e["pid"]}


def cluster_health_rows(broker) -> Iterator[Dict[str, Any]]:
    """Membership health plane (cluster/health.py): one row per member
    with the failure detector's verdict, suspicion phi, gossiped load
    score and last-heartbeat age — e.g. ``SELECT node, phi FROM
    cluster_health WHERE state != 'alive'``."""
    health = getattr(broker.cluster, "health", None) \
        if getattr(broker, "cluster", None) is not None else None
    if health is None:
        return
    quorum = health.quorum_ok()
    for r in health.status_rows():
        yield {**r, "quorum": quorum}


TABLES: Dict[str, Callable[[Any], Iterator[Dict[str, Any]]]] = {
    "sessions": session_rows,
    "subscriptions": subscription_rows,
    "retain": retain_rows,
    "retained_index": retained_index_rows,
    "queues": queue_rows,
    "messages": message_rows,
    "payload_schemas": payload_schema_rows,
    "filter_windows": filter_window_rows,
    "events": event_rows,
    "cluster_health": cluster_health_rows,
}


# --------------------------------------------------------------- QL parser

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<kw>SELECT|FROM|WHERE|ORDER\s+BY|ASC|DESC|LIMIT|AND|OR|NOT)\b
    | (?P<op><=|>=|!=|=|<|>)
    | (?P<num>-?\d+(?:\.\d+)?)
    | (?P<str>"[^"]*"|'[^']*')
    | (?P<word>[\w\$\#\+\/\.\*-]+)
    | (?P<punc>[(),])
    )""", re.VERBOSE | re.IGNORECASE)


class QLError(Exception):
    pass


def _tokenize(text: str) -> List[tuple]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip():
                raise QLError(f"bad token at: {text[pos:pos+20]!r}")
            break
        pos = m.end()
        for kind in ("kw", "op", "num", "str", "word", "punc"):
            v = m.group(kind)
            if v is not None:
                if kind == "kw":
                    v = re.sub(r"\s+", " ", v).upper()
                if kind == "str":
                    v = v[1:-1]
                if kind == "num":
                    v = float(v) if "." in v else int(v)
                out.append((kind, v))
                break
    return out


class _Parser:
    """Recursive-descent over: expr := term (OR term)*; term := factor
    (AND factor)*; factor := NOT factor | '(' expr ')' | field op value."""

    def __init__(self, tokens: List[tuple]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expr(self) -> Callable[[Dict], bool]:
        left = self.term()
        while self.peek() == ("kw", "OR"):
            self.next()
            right = self.term()
            l = left
            left = lambda row, l=l, r=right: l(row) or r(row)
        return left

    def term(self) -> Callable[[Dict], bool]:
        left = self.factor()
        while self.peek() == ("kw", "AND"):
            self.next()
            right = self.factor()
            l = left
            left = lambda row, l=l, r=right: l(row) and r(row)
        return left

    def factor(self) -> Callable[[Dict], bool]:
        kind, val = self.peek()
        if (kind, val) == ("kw", "NOT"):
            self.next()
            inner = self.factor()
            return lambda row: not inner(row)
        if (kind, val) == ("punc", "("):
            self.next()
            inner = self.expr()
            if self.next() != ("punc", ")"):
                raise QLError("expected )")
            return inner
        return self.comparison()

    def comparison(self) -> Callable[[Dict], bool]:
        kind, field = self.next()
        if kind not in ("word", "str"):
            raise QLError(f"expected field name, got {field!r}")
        opk, op = self.next()
        if opk != "op":
            raise QLError(f"expected operator after {field}, got {op!r}")
        vk, value = self.next()
        if vk not in ("num", "str", "word"):
            raise QLError(f"expected value, got {value!r}")
        if vk == "word" and isinstance(value, str):
            low = value.lower()
            if low in ("true", "false"):
                value = low == "true"
            elif low in ("null", "undefined"):
                value = None

        def cmp(row: Dict, f=field, o=op, v=value) -> bool:
            rv = row.get(f)
            try:
                if o == "=":
                    return rv == v
                if o == "!=":
                    return rv != v
                if rv is None or v is None:
                    return False
                if o == "<":
                    return rv < v
                if o == ">":
                    return rv > v
                if o == "<=":
                    return rv <= v
                if o == ">=":
                    return rv >= v
            except TypeError:
                return False
            return False

        return cmp


def parse(text: str) -> Dict[str, Any]:
    toks = _tokenize(text)
    p = _Parser(toks)
    if p.next() != ("kw", "SELECT"):
        raise QLError("query must start with SELECT")
    fields: List[str] = []
    while True:
        kind, v = p.next()
        if kind == "word" and v == "*":
            fields = []
        elif kind in ("word", "str"):
            fields.append(str(v))
        else:
            raise QLError(f"bad select field: {v!r}")
        if p.peek() == ("punc", ","):
            p.next()
            continue
        break
    if p.next() != ("kw", "FROM"):
        raise QLError("expected FROM")
    kind, table = p.next()
    if kind != "word":
        raise QLError("expected table name")
    where: Optional[Callable[[Dict], bool]] = None
    order_by: List[tuple] = []
    limit = None
    if p.peek() == ("kw", "WHERE"):
        p.next()
        where = p.expr()
    if p.peek() == ("kw", "ORDER BY"):
        # field list with per-field ASC/DESC (vmq_ql_query.erl:333-337
        # orders by the field-value tuple; DESC is a superset)
        p.next()
        while True:
            kind, f = p.next()
            if kind not in ("word", "str"):
                raise QLError(f"bad ORDER BY field: {f!r}")
            direction = 1
            if p.peek() in (("kw", "ASC"), ("kw", "DESC")):
                direction = -1 if p.next()[1] == "DESC" else 1
            order_by.append((str(f), direction))
            if p.peek() == ("punc", ","):
                p.next()
                continue
            break
    if p.peek() == ("kw", "LIMIT"):
        p.next()
        kind, limit = p.next()
        if kind != "num":
            raise QLError("LIMIT needs a number")
    if p.peek() != (None, None):
        raise QLError(f"trailing tokens: {p.peek()[1]!r}")
    return {"fields": fields, "table": str(table).lower(), "where": where,
            "order_by": order_by,
            "limit": int(limit) if limit is not None else None}


def _sort_key(v: Any) -> tuple:
    """Total order over heterogeneous row values (None < bool < number
    < str < other) so ORDER BY never TypeErrors on mixed columns."""
    if v is None:
        return (0, 0)
    if isinstance(v, bool):
        return (1, int(v))
    if isinstance(v, (int, float)):
        return (2, float(v))
    if isinstance(v, str):
        return (3, v)
    return (4, str(v))


def run_query(broker, table: str, fields: Optional[List[str]] = None,
              where: Optional[Callable[[Dict], bool]] = None,
              order_by: Optional[List[tuple]] = None,
              limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Filter/sort/project rows from one table — the shared engine
    behind :func:`query` and the admin commands (``session show``).
    ``order_by`` is ``[(field, direction)]`` with direction 1/-1; order
    fields are pulled from the full row, so sorting works even when
    they're not selected."""
    init = TABLES.get(table)
    if init is None:
        raise QLError(f"unknown table {table!r}; "
                      f"tables: {', '.join(sorted(TABLES))}")
    order_by = order_by or []
    out: List[Dict[str, Any]] = []
    for row in init(broker):
        # with ORDER BY every matching row must be seen before the cut
        if not order_by and limit is not None and len(out) >= limit:
            break
        if where is not None and not where(row):
            continue
        if fields:
            proj = {f: row.get(f) for f in fields}
            if order_by:
                proj["__sort__"] = tuple(row.get(f) for f, _ in order_by)
            out.append(proj)
        else:
            out.append(dict(row))
    if order_by:
        # per-field direction: stable multi-pass sort, last key first
        for idx, (field, direction) in reversed(list(enumerate(order_by))):
            if fields:
                out.sort(key=lambda r, i=idx: _sort_key(r["__sort__"][i]),
                         reverse=direction < 0)
            else:
                out.sort(key=lambda r, f=field: _sort_key(r.get(f)),
                         reverse=direction < 0)
        for r in out:
            r.pop("__sort__", None)
        if limit is not None:
            out = out[:limit]
    return out


def query(broker, text: str) -> List[Dict[str, Any]]:
    """Run a QL query against live broker state (fold_query equivalent,
    vmq_ql_query_mgr)."""
    q = parse(text)
    return run_query(broker, q["table"], q["fields"], q["where"],
                     q["order_by"], q["limit"])
