"""MQTT+ filter-suffix grammar: parse, compile, and the exact host
evaluator twin of the device kernel.

Syntax (MQTT+ "Enhanced Syntax" style, PAPERS.md): a subscription topic
filter may carry a ``?``-separated suffix of ``$``-operators —

    sensors/+/temp?$gt(value,30)
    plant/press/#?$range(value,10,80)&$eq(unit,bar)
    sensors/+/temp?$avg(value,100)          (count window: 100 msgs)
    sensors/+/temp?$max(value,10s)          (time window: 10 seconds)

- comparisons: ``$gt``/``$ge``/``$lt``/``$le``/``$eq``/``$ne`` (field,
  number-or-enum-label), ``$range(field,lo,hi)``, ``$in(field,v1,v2,…)``
  (enum membership), ``$exists(field)``, ``$null(field)``;
- aggregations: ``$avg``/``$min``/``$max``/``$sum`` (field, window) and
  ``$count(window)`` — window is a message count (``100``) or a
  duration (``10s``/``500ms``/``2m``). The subscriber receives
  synthesized PUBLISHes when windows close instead of per-message
  fanout (telemetry downsampling);
- terms conjoin with ``&``; at most one aggregation per filter.
- operator names are case-insensitive (``$AVG`` per the paper, ``$avg``
  per the lazy thumb).

Compilation resolves field names and enum labels against a
:class:`~vernemq_tpu.filters.schema_registry.TopicSchema` into the
predicate-row representation of :mod:`vernemq_tpu.ops.predicate_kernel`.
A single comparison compiles to one device row; conjunctions and
``$in`` alphabets past 64 codes are **unrepresentable** — those pairs
escape to the host evaluator per-row, exactly like the retained index's
``None`` escapes. :func:`eval_compiled_row` is the bit-identical host
twin of the kernel's pair verdict (same opcodes, float32 semantics).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Predicate opcodes — defined HERE (jax-free: sessions and worker
# processes import this module; they must never pull the JAX runtime
# in) and imported by ops/predicate_kernel.py, so the two executors
# share ONE opcode table.
OP_PAD = 0
OP_GT = 1
OP_GE = 2
OP_LT = 3
OP_LE = 4
OP_EQ = 5
OP_NE = 6
OP_RANGE = 7   # a <= x <= b
OP_IN = 8      # enum code membership in the (mlo, mhi) bitmask
OP_EXISTS = 9  # field present (non-NaN)
OP_NULL = 10   # field absent (NaN)
OP_TRUE = 11   # unconditional keep (unpredicated aggregation gates)

#: feature value for "missing" — comparisons on NaN are false on both
#: executors, OP_NULL alone is true
MISSING = np.float32(np.nan)

#: suffix separator: '?' begins a filter suffix only when followed by a
#: '$'-operator — a plain '?' stays part of the topic (MQTT allows it)
_SUFFIX_RE = re.compile(r"\?(?=\$)")

_TERM_RE = re.compile(r"^\$([a-zA-Z_]+)\(([^()]*)\)$")

_COMPARISONS = {
    "gt": OP_GT, "ge": OP_GE, "lt": OP_LT, "le": OP_LE,
    "eq": OP_EQ, "ne": OP_NE,
}
_AGGS = ("avg", "min", "max", "sum", "count")

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h)$")
_DUR_S = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


class FilterError(ValueError):
    """Invalid filter suffix; ``.reason`` is a stable slug."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass(frozen=True)
class Pred:
    """One parsed comparison term (field names/labels unresolved)."""

    op: str                 # gt/ge/lt/le/eq/ne/range/in/exists/null
    field: str
    args: Tuple[str, ...]   # raw argument strings past the field


@dataclass(frozen=True)
class Agg:
    """One parsed aggregation term."""

    fn: str                      # avg/min/max/sum/count
    field: Optional[str]         # None for $count
    count_n: int                 # >0: count window
    time_s: float                # >0: time window

    @property
    def window_label(self) -> str:
        return (f"{self.count_n}" if self.count_n
                else f"{self.time_s:g}s")


@dataclass(frozen=True)
class FilterSpec:
    """A parsed filter suffix: zero-or-more predicates, at most one
    aggregation, plus the verbatim source (the replicated identity)."""

    preds: Tuple[Pred, ...]
    agg: Optional[Agg]
    raw: str


def split_filter_suffix(topic_str: str) -> Tuple[str, Optional[str]]:
    """Split ``a/b?$gt(v,1)`` into ``("a/b", "$gt(v,1)")``; topics
    without a ``?$`` come back unchanged with ``None``."""
    m = _SUFFIX_RE.search(topic_str)
    if m is None:
        return topic_str, None
    return topic_str[:m.start()], topic_str[m.end():]


def _num(raw: str, reason: str) -> float:
    try:
        return float(raw)
    except ValueError:
        raise FilterError(reason) from None


def _parse_window(raw: str) -> Tuple[int, float]:
    raw = raw.strip()
    if raw.isdigit():
        n = int(raw)
        if n <= 0:
            raise FilterError("window_must_be_positive")
        return n, 0.0
    m = _DUR_RE.match(raw)
    if m is None:
        raise FilterError("bad_window_spec")
    secs = float(m.group(1)) * _DUR_S[m.group(2)]
    if secs <= 0:
        raise FilterError("window_must_be_positive")
    return 0, secs


def parse_filter(expr: str) -> FilterSpec:
    """Parse a filter suffix (without the leading ``?``)."""
    expr = expr.strip()
    if not expr:
        raise FilterError("empty_filter")
    preds: List[Pred] = []
    agg: Optional[Agg] = None
    for term in expr.split("&"):
        term = term.strip()
        m = _TERM_RE.match(term)
        if m is None:
            raise FilterError("bad_filter_term")
        name = m.group(1).lower()
        args = [a.strip() for a in m.group(2).split(",")] \
            if m.group(2).strip() else []
        if name in _COMPARISONS:
            if len(args) != 2 or not args[0]:
                raise FilterError(f"{name}_needs_field_and_value")
            preds.append(Pred(name, args[0], (args[1],)))
        elif name == "range":
            if len(args) != 3 or not args[0]:
                raise FilterError("range_needs_field_lo_hi")
            lo = _num(args[1], "range_bounds_must_be_numeric")
            hi = _num(args[2], "range_bounds_must_be_numeric")
            if lo > hi:
                raise FilterError("range_lo_above_hi")
            preds.append(Pred("range", args[0], (args[1], args[2])))
        elif name == "in":
            if len(args) < 2 or not args[0]:
                raise FilterError("in_needs_field_and_values")
            preds.append(Pred("in", args[0], tuple(args[1:])))
        elif name in ("exists", "null"):
            if len(args) != 1 or not args[0]:
                raise FilterError(f"{name}_needs_field")
            preds.append(Pred(name, args[0], ()))
        elif name in _AGGS:
            if agg is not None:
                raise FilterError("multiple_aggregations")
            if name == "count":
                if len(args) != 1:
                    raise FilterError("count_needs_window")
                n, secs = _parse_window(args[0])
                agg = Agg("count", None, n, secs)
            else:
                if len(args) != 2 or not args[0]:
                    raise FilterError(f"{name}_needs_field_and_window")
                n, secs = _parse_window(args[1])
                agg = Agg(name, args[0], n, secs)
        else:
            raise FilterError(f"unknown_operator_{name}")
    return FilterSpec(tuple(preds), agg, expr)


# ------------------------------------------------------------- compilation

@dataclass(frozen=True)
class CompiledPred:
    """One predicate resolved against a schema: the kernel-row fields
    plus the host-escape alternative for unrepresentable terms."""

    op_code: int
    field_idx: int          # schema column; schemas append a NaN column,
                            # so unknown fields index real (always-NaN) data
    a: float                # np.float32-quantized threshold / range lo
    b: float                # range hi
    mlo: int                # enum bitmask (codes 0..31)
    mhi: int                # enum bitmask (codes 32..63)
    device_ok: bool         # representable as one kernel row
    in_codes: Tuple[int, ...] = ()  # host eval for escaped $in


@dataclass(frozen=True)
class CompiledFilter:
    spec: FilterSpec
    preds: Tuple[CompiledPred, ...]
    #: the single kernel row when the whole predicate side is ONE
    #: device-representable comparison; None → per-pair host escape
    #: (conjunctions, $in past 64 codes)
    device_row: Optional[Tuple[int, int, float, float, int, int]]


def compile_pred(pred: Pred, schema) -> CompiledPred:
    """Resolve one predicate against ``schema`` (None → every field
    missing: the no-schema publish still has defined semantics)."""
    fi = schema.field_index(pred.field) if schema is not None else None
    if fi is None:
        fi = schema.nan_index if schema is not None else 0
    op = pred.op
    a = b = 0.0
    mlo = mhi = 0
    device_ok = True
    in_codes: Tuple[int, ...] = ()
    if op in _COMPARISONS:
        raw = pred.args[0]
        try:
            a = float(raw)
        except ValueError:
            # enum label: resolve to its code; an unknown label can
            # never match — compile an impossible threshold (-1: codes
            # are non-negative) so eq is always false / ne always true
            code = (schema.enum_code(pred.field, raw)
                    if schema is not None else None)
            if code is None:
                if op not in ("eq", "ne"):
                    raise FilterError("non_numeric_comparison_value")
                a = -1.0
            else:
                a = float(code)
        return CompiledPred(_COMPARISONS[op], fi, float(np.float32(a)),
                            0.0, 0, 0, True)
    if op == "range":
        a = float(np.float32(float(pred.args[0])))
        b = float(np.float32(float(pred.args[1])))
        return CompiledPred(OP_RANGE, fi, a, b, 0, 0, True)
    if op == "in":
        codes: List[int] = []
        for raw in pred.args:
            try:
                v = float(raw)
                code = int(v) if v == int(v) and v >= 0 else -1
            except ValueError:
                c = (schema.enum_code(pred.field, raw)
                     if schema is not None else None)
                code = -1 if c is None else c
            if code >= 0:
                codes.append(code)
        for c in codes:
            if c < 32:
                mlo |= 1 << c
            elif c < 64:
                mhi |= 1 << (c - 32)
            else:
                device_ok = False  # alphabet past the mask: host escape
        if not device_ok:
            in_codes = tuple(sorted(set(codes)))
        return CompiledPred(OP_IN, fi, 0.0, 0.0, mlo, mhi, device_ok,
                            in_codes)
    if op == "exists":
        return CompiledPred(OP_EXISTS, fi, 0.0, 0.0, 0, 0, True)
    if op == "null":
        return CompiledPred(OP_NULL, fi, 0.0, 0.0, 0, 0, True)
    raise FilterError(f"unknown_operator_{op}")


def compile_filter(spec: FilterSpec, schema) -> CompiledFilter:
    preds = tuple(compile_pred(p, schema) for p in spec.preds)
    device_row = None
    if len(preds) == 1 and preds[0].device_ok:
        p = preds[0]
        device_row = (p.op_code, p.field_idx, p.a, p.b, p.mlo, p.mhi)
    return CompiledFilter(spec, preds, device_row)


# ---------------------------------------------------------- host evaluator

def eval_compiled_row(op_code: int, field_idx: int, a: float, b: float,
                      mlo: int, mhi: int, feat_row: np.ndarray,
                      in_codes: Sequence[int] = ()) -> bool:
    """The host twin of the kernel's per-pair verdict: identical opcode
    semantics on the identical float32 feature row — a comparison on a
    missing (NaN) value is false, only OP_NULL survives it."""
    x = np.float32(feat_row[field_idx])
    missing = bool(np.isnan(x))
    if op_code == OP_NULL:
        return missing
    if op_code == OP_EXISTS:
        return not missing
    if missing:
        return False
    af = np.float32(a)
    if op_code == OP_GT:
        return bool(x > af)
    if op_code == OP_GE:
        return bool(x >= af)
    if op_code == OP_LT:
        return bool(x < af)
    if op_code == OP_LE:
        return bool(x <= af)
    if op_code == OP_EQ:
        return bool(x == af)
    if op_code == OP_NE:
        return bool(x != af)
    if op_code == OP_RANGE:
        return bool((x >= af) & (x <= np.float32(b)))
    if op_code == OP_IN:
        if x != np.floor(x) or x < 0:
            return False
        code = int(x)
        if in_codes:
            return code in in_codes
        if code < 32:
            return bool((mlo >> code) & 1)
        if code < 64:
            return bool((mhi >> (code - 32)) & 1)
        return False
    return False


def eval_filter_host(cf: CompiledFilter, feat_row: np.ndarray) -> bool:
    """Exact predicate verdict for one (publish, subscription) pair —
    the conjunction of every compiled term (the device path only ever
    carries single-term filters; this is the oracle AND the escape)."""
    for p in cf.preds:
        if not eval_compiled_row(p.op_code, p.field_idx, p.a, p.b,
                                 p.mlo, p.mhi, feat_row, p.in_codes):
            return False
    return True


# ---------------------------------------------------------- feature encode

def encode_features(schema, payload: bytes) -> np.ndarray:
    """Decode a publish payload against ``schema`` into the fixed-width
    float32 feature row the kernel gathers from: numbers as-is, bools
    as 0/1, enum labels as their code, anything missing/undecodable as
    NaN. The trailing column is the guaranteed-NaN slot unknown-field
    predicates index."""
    row = np.full(schema.width, MISSING, dtype=np.float32)
    try:
        import json

        obj = json.loads(payload.decode("utf-8"))
    except Exception:
        return row
    if not isinstance(obj, dict):
        return row
    for i, fd in enumerate(schema.fields):
        v = obj.get(fd.name)
        if v is None:
            continue
        if fd.kind == "enum":
            if isinstance(v, str):
                code = fd.codes.get(v)
                if code is not None:
                    row[i] = np.float32(code)
            continue
        if isinstance(v, bool):
            row[i] = np.float32(1.0 if v else 0.0)
        elif isinstance(v, (int, float)):
            row[i] = np.float32(v)
    return row


# ------------------------------------------------------- host aggregation

def host_partials(feats: np.ndarray, agg_slot: np.ndarray,
                  agg_pub: np.ndarray, agg_field: np.ndarray,
                  agg_valid: np.ndarray, W: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Exact host twin of the kernel's per-slot partial reductions
    (float32, same pair order): the degraded path folds windows on the
    same arithmetic whichever executor served the batch."""
    cnt = np.zeros(W, np.float32)
    sm = np.zeros(W, np.float32)
    mn = np.full(W, np.inf, np.float32)
    mx = np.full(W, -np.inf, np.float32)
    for k in range(len(agg_slot)):
        if not agg_valid[k]:
            continue
        fi = int(agg_field[k])
        if fi >= 0:
            v = np.float32(feats[int(agg_pub[k]), fi])
            if np.isnan(v):
                continue
        else:
            v = np.float32(0)
        s = int(agg_slot[k])
        cnt[s] = np.float32(cnt[s] + np.float32(1))
        sm[s] = np.float32(sm[s] + v)
        if v < mn[s]:
            mn[s] = v
        if v > mx[s]:
            mx[s] = v
    return cnt, sm, mn, mx
