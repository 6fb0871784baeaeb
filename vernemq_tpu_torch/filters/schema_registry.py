"""Per-mountpoint payload schemas, replicated through the metadata plane.

A schema names the fields a topic family's JSON payloads carry —
``value:number,unit:enum(c|f),ok:bool`` — so publishes decode into
fixed-width float32 feature rows (``predicate.encode_features``) and
predicates compile to device rows against stable column indexes.

Schemas live in the replicated
:class:`~vernemq_tpu.cluster.metadata.MetadataStore` under the
``payload_schema`` prefix, exactly like the mesh slice map: every
``vmq-admin schema set`` gossips cluster-wide, reconnects reconcile via
anti-entropy, LWW resolves concurrent writes, and every node's engine
sees the same field layout (a predicate compiled here evaluates the
same columns there). Keys are ``(mountpoint, filter_string)``; lookup
matches a concrete publish topic against the schema's (possibly
wildcarded) topic filter, first match in sorted-filter order wins —
deterministic across nodes by construction.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..protocol.topic import TopicError, match, validate_topic

log = logging.getLogger("vernemq_tpu_torch.filters")

PREFIX = "payload_schema"

_KINDS = ("number", "bool", "enum")


@dataclass(frozen=True)
class FieldDef:
    name: str
    kind: str                      # number | bool | enum
    enum: Tuple[str, ...] = ()

    @property
    def codes(self) -> Dict[str, int]:
        return {label: i for i, label in enumerate(self.enum)}

    def spec(self) -> str:
        if self.kind == "enum":
            return f"{self.name}:enum({'|'.join(self.enum)})"
        return f"{self.name}:{self.kind}"


class TopicSchema:
    """One registered schema: mountpoint + topic filter + ordered
    fields. ``width`` includes the trailing guaranteed-NaN column that
    unknown-field predicates compile against."""

    __slots__ = ("mountpoint", "filter_str", "filter_words", "fields",
                 "_index")

    def __init__(self, mountpoint: str, filter_str: str,
                 fields: Sequence[FieldDef]):
        self.mountpoint = mountpoint
        self.filter_str = filter_str
        self.filter_words = tuple(validate_topic("subscribe", filter_str))
        self.fields: Tuple[FieldDef, ...] = tuple(fields)
        self._index = {fd.name: i for i, fd in enumerate(self.fields)}

    @property
    def width(self) -> int:
        return len(self.fields) + 1

    @property
    def nan_index(self) -> int:
        return len(self.fields)

    def field_index(self, name: str) -> Optional[int]:
        return self._index.get(name)

    def enum_code(self, field: str, label: str) -> Optional[int]:
        i = self._index.get(field)
        if i is None:
            return None
        return self.fields[i].codes.get(label)

    def fields_spec(self) -> str:
        return ",".join(fd.spec() for fd in self.fields)

    def to_term(self) -> Dict[str, Any]:
        return {"fields": [
            {"name": fd.name, "kind": fd.kind, "enum": list(fd.enum)}
            for fd in self.fields]}

    @classmethod
    def from_term(cls, mountpoint: str, filter_str: str,
                  term: Dict[str, Any]) -> "TopicSchema":
        fields = [FieldDef(f["name"], f["kind"],
                           tuple(f.get("enum") or ()))
                  for f in term.get("fields", [])]
        return cls(mountpoint, filter_str, fields)


def parse_fields_spec(spec: str) -> List[FieldDef]:
    """``value:number,unit:enum(c|f),ok:bool`` → field list."""
    out: List[FieldDef] = []
    seen = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, kind = part.partition(":")
        name = name.strip()
        kind = kind.strip() or "number"
        if not sep:
            kind = "number"
        if not name or name in seen:
            raise ValueError(f"bad or duplicate field name in {part!r}")
        seen.add(name)
        if kind.startswith("enum(") and kind.endswith(")"):
            labels = tuple(v.strip() for v in kind[5:-1].split("|")
                           if v.strip())
            if not labels:
                raise ValueError(f"enum field {name!r} needs labels")
            out.append(FieldDef(name, "enum", labels))
        elif kind in ("number", "bool"):
            out.append(FieldDef(name, kind))
        else:
            raise ValueError(
                f"unknown field kind {kind!r} for {name!r} "
                f"(valid: number, bool, enum(a|b|…))")
    if not out:
        raise ValueError("schema needs at least one field")
    return out


class SchemaRegistry:
    def __init__(self, metadata, node_name: str):
        self.metadata = metadata
        self.node_name = node_name
        self._lock = threading.Lock()
        # mountpoint -> [(filter_str, TopicSchema)] sorted by filter_str
        self._by_mp: Dict[str, List[Tuple[str, TopicSchema]]] = {}
        #: bumped on every change — engines key their compile caches
        #: and per-topic lookup caches on it
        self.generation = 0
        self._listeners: List[Callable[[], None]] = []
        metadata.subscribe(PREFIX, self._on_change)
        # warm-load whatever the (persisted / already-replicated) plane
        # holds — boot order vs gossip arrival must not matter
        for key, term in metadata.fold(PREFIX):
            self._install(key[0], key[1], term)

    # ------------------------------------------------------------- writes

    def set_schema(self, mountpoint: str, filter_str: str,
                   fields_spec: str) -> TopicSchema:
        fields = parse_fields_spec(fields_spec)
        schema = TopicSchema(mountpoint, filter_str, fields)
        # the local write fires _on_change synchronously
        # (read-your-writes) and broadcasts to every peer
        self.metadata.put(PREFIX, (mountpoint, filter_str),
                          schema.to_term())
        return schema

    def delete_schema(self, mountpoint: str, filter_str: str) -> bool:
        with self._lock:
            known = any(f == filter_str
                        for f, _ in self._by_mp.get(mountpoint, ()))
        if not known:
            return False
        self.metadata.delete(PREFIX, (mountpoint, filter_str))
        return True

    def boot_install(self, specs: Sequence[Dict[str, Any]]) -> None:
        """Install the ``payload_schemas`` config list at boot:
        ``[{mountpoint, topic, fields}]`` dicts."""
        for s in specs or ():
            try:
                self.set_schema(s.get("mountpoint", ""), s["topic"],
                                s["fields"])
            except (KeyError, ValueError, TopicError):
                log.exception("invalid payload_schemas entry %r "
                              "(skipped)", s)

    # ------------------------------------------------------------- events

    def _install(self, mountpoint: str, filter_str: str,
                 term: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            rows = self._by_mp.setdefault(mountpoint, [])
            rows[:] = [(f, s) for f, s in rows if f != filter_str]
            if term is not None:
                try:
                    rows.append((filter_str, TopicSchema.from_term(
                        mountpoint, filter_str, term)))
                except (TopicError, KeyError, TypeError):
                    log.exception("bad replicated schema %s %s",
                                  mountpoint, filter_str)
            rows.sort(key=lambda fs: fs[0])
            if not rows:
                self._by_mp.pop(mountpoint, None)
            self.generation += 1
        for fn in list(self._listeners):
            try:
                fn()
            except Exception:
                log.exception("schema-change listener failed")

    def _on_change(self, key: Any, old: Any, new: Any, origin: str) -> None:
        self._install(key[0], key[1], new)

    def on_change(self, fn: Callable[[], None]) -> None:
        self._listeners.append(fn)

    # -------------------------------------------------------------- reads

    def has_schemas(self, mountpoint: str) -> bool:
        return mountpoint in self._by_mp

    def lookup(self, mountpoint: str,
               topic: Sequence[str]) -> Optional[TopicSchema]:
        """Schema for a concrete publish topic: first match in
        sorted-filter order (deterministic across nodes)."""
        rows = self._by_mp.get(mountpoint)
        if not rows:
            return None
        t = list(topic)
        for _f, schema in rows:
            if match(t, list(schema.filter_words)):
                return schema
        return None

    def schemas(self, mountpoint: Optional[str] = None
                ) -> List[TopicSchema]:
        with self._lock:
            if mountpoint is None:
                return [s for rows in self._by_mp.values()
                        for _f, s in rows]
            return [s for _f, s in self._by_mp.get(mountpoint, ())]
