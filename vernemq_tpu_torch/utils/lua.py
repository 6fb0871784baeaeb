"""A self-contained Lua 5.1 interpreter (lexer + recursive-descent parser
+ tree-walking evaluator) for the scripting plugin.

Role: the reference embeds the ``luerl`` Lua VM so operators script the
broker's hook surface in Lua (``vmq_diversity_plugin.erl:18-50``, engine
under ``apps/vmq_diversity``); its bundled auth scripts
(``priv/auth/{postgres,mysql,mongodb,redis}.lua``) are plain Lua 5.1.
This module provides the language itself; the broker-facing bridge
(hook tables, ``auth_cache``/``kv``/datastore connector modules) lives in
``plugins/lua_bridge.py``. Implemented from the Lua 5.1 reference manual
— no code is taken from luerl (Erlang) or any Lua implementation.

Supported language (everything the reference's bundled scripts and
typical operator auth scripts use, and then some):

- values: nil, booleans, numbers (Lua 5.1 unified number = float, with
  integral rendering), strings, tables, functions; multiple return
  values and multiple assignment; varargs ``...``
- statements: assignment, ``local``, function/method definitions
  (``function a.b.c()``, ``function obj:m()``), ``if/elseif/else``,
  ``while``, ``repeat/until``, numeric and generic ``for``, ``do`` blocks,
  ``break``, ``return``
- expressions: full operator set with 5.1 precedence (incl. ``..`` and
  ``^`` right-assoc, ``#``, ``not``), table constructors (array part,
  ``k = v``, ``[expr] = v``), method calls, string-literal and
  table-constructor call sugar (``require "x"``, ``f{...}``), long
  strings/comments ``[[ ]]`` / ``[=[ ]=]``
- metatables: ``__index`` (table or function), ``__newindex``,
  ``__call``, ``__tostring`` (enough for idiomatic module/OO scripts)
- stdlib: ``print type tostring tonumber assert error pcall ipairs pairs
  next select unpack require rawget rawset rawequal setmetatable
  getmetatable``; ``string`` (len sub upper lower rep reverse byte char
  format find match gmatch gsub) with Lua-pattern support; ``table``
  (insert remove concat sort getn); ``math``; ``os.time/clock``; string
  methods on values (``("x"):upper()``)

Sandboxing: no ``io``, no ``os.execute``/``os.getenv``, no ``load``/
``loadstring``/``dofile`` — scripts get only what the host injects
(same trust posture as the reference: operator-provided scripts run
in-process, but the surface is the hook API, not the OS).
"""

from __future__ import annotations

import math as _math
import re as _re
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["LuaError", "LuaTable", "LuaFunction", "LuaRuntime",
           "lua_tostring", "from_lua", "to_lua"]


class LuaError(Exception):
    """A Lua-level error (``error()``, or a runtime fault). ``value`` is
    the Lua error value (usually a string with position info)."""

    def __init__(self, value):
        self.value = value
        super().__init__(lua_tostring(value))


# --------------------------------------------------------------------- values


class LuaTable:
    """Lua table: unified array+hash. Keys are Lua values (nil invalid);
    integral floats normalise to int keys (Lua 5.1 semantics).
    ``_border`` caches a lower bound on the array border so repeated
    ``append``/``length`` (list construction in ``to_lua``, ``#t`` in
    loops) is O(1) amortised instead of O(n) probing per call."""

    __slots__ = ("hash", "metatable", "_border")

    def __init__(self, pairs_=None):
        self.hash: Dict[Any, Any] = {}
        self.metatable: Optional[LuaTable] = None
        self._border = 0
        if pairs_:
            for k, v in pairs_:
                self.set(k, v)

    @staticmethod
    def _norm(key):
        if isinstance(key, float) and key.is_integer():
            return int(key)
        if isinstance(key, bool):  # bool is not int in Lua
            return ("<bool>", key)
        return key

    def get(self, key):
        return self.hash.get(self._norm(key))

    def set(self, key, value):
        if key is None:
            raise LuaError("table index is nil")
        k = self._norm(key)
        if value is None:
            self.hash.pop(k, None)
            if type(k) is int and 0 < k <= self._border:
                self._border = k - 1  # hole below the cached border
        else:
            self.hash[k] = value

    def length(self) -> int:
        # border: consecutive integer keys from 1, resuming from the
        # cached lower bound (set() keeps it a valid lower bound)
        n = self._border
        while (n + 1) in self.hash:
            n += 1
        self._border = n
        return n

    def append(self, value):
        self.set(self.length() + 1, value)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"LuaTable({self.hash!r})"


class LuaFunction:
    """A Lua closure: proto (params, is_vararg, body) + captured scope."""

    __slots__ = ("params", "is_vararg", "body", "env", "name", "runtime")

    def __init__(self, params, is_vararg, body, env, runtime, name="?"):
        self.params = params
        self.is_vararg = is_vararg
        self.body = body
        self.env = env
        self.runtime = runtime
        self.name = name

    def __call__(self, *args):
        """Callable from Python: returns a single value (first result) —
        the bridge uses call_multi for full result lists."""
        res = self.runtime.call(self, list(args))
        return res[0] if res else None


def lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, (int, float)):
        return _num_str(v)
    if isinstance(v, str):
        return v
    if isinstance(v, LuaTable):
        mt = v.metatable
        if mt is not None:
            f = mt.get("__tostring")
            if f is not None:
                return f(v)
        return f"table: 0x{id(v):012x}"
    if isinstance(v, (LuaFunction,)) or callable(v):
        return f"function: 0x{id(v):012x}"
    return str(v)


def _num_str(v) -> str:
    if isinstance(v, int):
        return str(v)
    if v != v:
        return "nan"
    if v == _math.inf:
        return "inf"
    if v == -_math.inf:
        return "-inf"
    if v.is_integer() and abs(v) < 1e16:
        return str(int(v))
    return repr(v)


def _truthy(v) -> bool:
    return v is not None and v is not False


def _tonum(v, base=None):
    if base is not None:
        try:
            return int(str(v).strip(), int(base))
        except (ValueError, TypeError):
            return None
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        s = v.strip()
        try:
            if s.lower().startswith(("0x", "-0x")):
                return int(s, 16)
            f = float(s)
            return int(f) if f.is_integer() and ("e" not in s.lower()
                                                 and "." not in s) else f
        except ValueError:
            return None
    return None


def _arith_num(v, what="perform arithmetic on"):
    n = _tonum(v)
    if n is None or isinstance(v, bool):
        raise LuaError(f"attempt to {what} a {_typename(v)} value")
    return n


def _typename(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    return "function" if callable(v) else "userdata"


# --------------------------------------------------------------------- lexer

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for",
    "function", "if", "in", "local", "nil", "not", "or", "repeat",
    "return", "then", "true", "until", "while",
}

_TOKEN_RE = _re.compile(r"""
    (?P<ws>\s+)
  | (?P<longcomment>--\[(?P<lceq>=*)\[)
  | (?P<comment>--[^\n]*)
  | (?P<longstr>\[(?P<lseq>=*)\[)
  | (?P<name>[A-Za-z_]\w*)
  | (?P<number>0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<dots>\.\.\.|\.\.)
  | (?P<op>==|~=|<=|>=|[+\-*/%^#<>=(){}\[\];:,.])
  | (?P<str>"|')
""", _re.VERBOSE)


class _Tok:
    __slots__ = ("kind", "val", "line")

    def __init__(self, kind, val, line):
        self.kind = kind
        self.val = val
        self.line = line

    def __repr__(self):  # pragma: no cover
        return f"Tok({self.kind},{self.val!r},l{self.line})"


def _lex(src: str, chunkname: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, line, n = 0, 1, len(src)
    # a leading '#!' line is skipped (Lua does this)
    if src.startswith("#"):
        nl = src.find("\n")
        i = n if nl < 0 else nl
    while i < n:
        m = _TOKEN_RE.match(src, i)
        if m is None:
            raise LuaError(f"{chunkname}:{line}: unexpected symbol near "
                           f"{src[i:i+10]!r}")
        kind = m.lastgroup
        text = m.group(0)
        if kind == "ws" or kind == "comment":
            line += text.count("\n")
            i = m.end()
            continue
        if kind in ("longcomment", "longstr"):
            eq = m.group("lceq" if kind == "longcomment" else "lseq")
            close = "]" + eq + "]"
            j = src.find(close, m.end())
            if j < 0:
                raise LuaError(f"{chunkname}:{line}: unfinished long "
                               f"{'comment' if kind=='longcomment' else 'string'}")
            body = src[m.end():j]
            if kind == "longstr":
                if body.startswith("\n"):
                    body = body[1:]
                toks.append(_Tok("str", body, line))
            line += src.count("\n", i, j)
            i = j + len(close)
            continue
        if kind == "str":
            q = text
            j = m.end()
            buf = []
            while True:
                if j >= n:
                    raise LuaError(f"{chunkname}:{line}: unfinished string")
                c = src[j]
                if c == q:
                    j += 1
                    break
                if c == "\n":
                    raise LuaError(f"{chunkname}:{line}: unfinished string")
                if c == "\\":
                    j += 1
                    if j >= n:
                        raise LuaError(f"{chunkname}:{line}: unfinished string")
                    e = src[j]
                    mapping = {"n": "\n", "t": "\t", "r": "\r", "a": "\a",
                               "b": "\b", "f": "\f", "v": "\v", "\\": "\\",
                               '"': '"', "'": "'", "\n": "\n"}
                    if e in mapping:
                        buf.append(mapping[e])
                        if e == "\n":
                            line += 1
                        j += 1
                    elif e.isdigit():
                        d = e
                        j += 1
                        for _ in range(2):
                            if j < n and src[j].isdigit():
                                d += src[j]
                                j += 1
                        buf.append(chr(int(d)))
                    elif e == "x":
                        h = src[j + 1:j + 3]
                        buf.append(chr(int(h, 16)))
                        j += 3
                    else:
                        raise LuaError(
                            f"{chunkname}:{line}: invalid escape \\{e}")
                else:
                    buf.append(c)
                    j += 1
            toks.append(_Tok("str", "".join(buf), line))
            i = j
            continue
        if kind == "name":
            toks.append(_Tok(text if text in _KEYWORDS else "name",
                             text, line))
        elif kind == "number":
            v = int(text, 16) if text[:2].lower() == "0x" else (
                int(text) if _re.fullmatch(r"\d+", text) else float(text))
            toks.append(_Tok("number", v, line))
        elif kind == "dots":
            toks.append(_Tok(text, text, line))
        else:
            toks.append(_Tok(text, text, line))
        i = m.end()
    toks.append(_Tok("<eof>", None, line))
    return toks


# -------------------------------------------------------------------- parser
# AST: tuples (op, ...). Statements and expressions share the namespace.


class _Parser:
    def __init__(self, toks: List[_Tok], chunkname: str):
        self.toks = toks
        self.pos = 0
        self.chunk = chunkname

    # helpers
    def peek(self) -> _Tok:
        return self.toks[self.pos]

    def next(self) -> _Tok:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def check(self, kind) -> bool:
        return self.peek().kind == kind

    def accept(self, kind) -> Optional[_Tok]:
        if self.check(kind):
            return self.next()
        return None

    def expect(self, kind) -> _Tok:
        t = self.peek()
        if t.kind != kind:
            raise LuaError(f"{self.chunk}:{t.line}: '{kind}' expected "
                           f"near '{t.val}'")
        return self.next()

    def err(self, msg):
        t = self.peek()
        raise LuaError(f"{self.chunk}:{t.line}: {msg} near '{t.val}'")

    # grammar
    def parse_chunk(self):
        body = self.block()
        self.expect("<eof>")
        return body

    _BLOCK_END = {"end", "else", "elseif", "until", "<eof>"}

    def block(self):
        stats = []
        while True:
            t = self.peek()
            if t.kind in self._BLOCK_END:
                return stats
            if t.kind == ";":
                self.next()
                continue
            if t.kind == "return":
                line = self.next().line
                exps = []
                if not (self.peek().kind in self._BLOCK_END
                        or self.check(";")):
                    exps = self.explist()
                self.accept(";")
                stats.append(("return", exps, line))
                return stats
            if t.kind == "break":
                self.next()
                stats.append(("break", t.line))
                # 5.1: break must end the block; tolerate trailing ';'
                self.accept(";")
                return stats
            # wrap with the source line so runtime errors (step budget,
            # runaway loops) can point at real code, not "line 0"
            stats.append(("@", t.line, self.statement()))

    def statement(self):
        t = self.peek()
        k = t.kind
        if k == "do":
            self.next()
            body = self.block()
            self.expect("end")
            return ("do", body)
        if k == "while":
            self.next()
            cond = self.expr()
            self.expect("do")
            body = self.block()
            self.expect("end")
            return ("while", cond, body)
        if k == "repeat":
            self.next()
            body = self.block()
            self.expect("until")
            cond = self.expr()
            return ("repeat", body, cond)
        if k == "if":
            self.next()
            arms = []
            cond = self.expr()
            self.expect("then")
            arms.append((cond, self.block()))
            els = None
            while True:
                if self.accept("elseif"):
                    c2 = self.expr()
                    self.expect("then")
                    arms.append((c2, self.block()))
                elif self.accept("else"):
                    els = self.block()
                    self.expect("end")
                    break
                else:
                    self.expect("end")
                    break
            return ("if", arms, els)
        if k == "for":
            self.next()
            name = self.expect("name").val
            if self.accept("="):
                start = self.expr()
                self.expect(",")
                stop = self.expr()
                step = self.expr() if self.accept(",") else ("const", 1)
                self.expect("do")
                body = self.block()
                self.expect("end")
                return ("fornum", name, start, stop, step, body)
            names = [name]
            while self.accept(","):
                names.append(self.expect("name").val)
            self.expect("in")
            exps = self.explist()
            self.expect("do")
            body = self.block()
            self.expect("end")
            return ("forin", names, exps, body)
        if k == "function":
            line = self.next().line
            # funcname: Name {'.' Name} [':' Name]
            target = ("name", self.expect("name").val, line)
            is_method = False
            while True:
                if self.accept("."):
                    target = ("index", target,
                              ("const", self.expect("name").val), line)
                elif self.accept(":"):
                    target = ("index", target,
                              ("const", self.expect("name").val), line)
                    is_method = True
                    break
                else:
                    break
            fn = self.funcbody(is_method, line)
            return ("assign", [target], [fn])
        if k == "local":
            self.next()
            if self.accept("function"):
                line = t.line
                name = self.expect("name").val
                fn = self.funcbody(False, line)
                return ("localfunc", name, fn)
            names = [self.expect("name").val]
            while self.accept(","):
                names.append(self.expect("name").val)
            exps = self.explist() if self.accept("=") else []
            return ("local", names, exps)
        # exprstat: either a call or an assignment
        e = self.suffixedexp()
        if self.check("=") or self.check(","):
            targets = [e]
            while self.accept(","):
                targets.append(self.suffixedexp())
            self.expect("=")
            exps = self.explist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    self.err("syntax error (cannot assign)")
            return ("assign", targets, exps)
        if e[0] not in ("call", "method"):
            self.err("syntax error")
        return ("exprstat", e)

    def funcbody(self, is_method: bool, line: int):
        self.expect("(")
        params = ["self"] if is_method else []
        is_vararg = False
        if not self.check(")"):
            while True:
                if self.accept("..."):
                    is_vararg = True
                    break
                params.append(self.expect("name").val)
                if not self.accept(","):
                    break
        self.expect(")")
        body = self.block()
        self.expect("end")
        return ("function", params, is_vararg, body, line)

    def explist(self):
        exps = [self.expr()]
        while self.accept(","):
            exps.append(self.expr())
        return exps

    _BINPRI = {
        "or": (1, 1), "and": (2, 2),
        "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3),
        "~=": (3, 3), "==": (3, 3),
        "..": (5, 4),  # right assoc
        "+": (6, 6), "-": (6, 6),
        "*": (7, 7), "/": (7, 7), "%": (7, 7),
        "^": (10, 9),  # right assoc, binds tighter than unary
    }
    _UNARY_PRI = 8

    def expr(self, limit=0):
        t = self.peek()
        if t.kind in ("not", "-", "#"):
            op = self.next().kind
            e = self.expr(self._UNARY_PRI)
            left = ("unop", op, e, t.line)
        else:
            left = self.simpleexp()
        while True:
            op = self.peek().kind
            pri = self._BINPRI.get(op)
            if pri is None or pri[0] <= limit:
                return left
            line = self.next().line
            right = self.expr(pri[1])
            left = ("binop", op, left, right, line)

    def simpleexp(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ("const", t.val)
        if t.kind == "str":
            self.next()
            return ("const", t.val)
        if t.kind == "nil":
            self.next()
            return ("const", None)
        if t.kind == "true":
            self.next()
            return ("const", True)
        if t.kind == "false":
            self.next()
            return ("const", False)
        if t.kind == "...":
            self.next()
            return ("vararg", t.line)
        if t.kind == "function":
            self.next()
            return self.funcbody(False, t.line)
        if t.kind == "{":
            return self.tablector()
        return self.suffixedexp()

    def primaryexp(self):
        t = self.peek()
        if t.kind == "(":
            self.next()
            e = self.expr()
            self.expect(")")
            return ("paren", e)
        if t.kind == "name":
            self.next()
            return ("name", t.val, t.line)
        self.err("unexpected symbol")

    def suffixedexp(self):
        e = self.primaryexp()
        while True:
            t = self.peek()
            if t.kind == ".":
                self.next()
                name = self.expect("name").val
                e = ("index", e, ("const", name), t.line)
            elif t.kind == "[":
                self.next()
                k = self.expr()
                self.expect("]")
                e = ("index", e, k, t.line)
            elif t.kind == ":":
                self.next()
                name = self.expect("name").val
                args = self.callargs()
                e = ("method", e, name, args, t.line)
            elif t.kind in ("(", "str", "{"):
                args = self.callargs()
                e = ("call", e, args, t.line)
            else:
                return e

    def callargs(self):
        t = self.peek()
        if t.kind == "str":
            self.next()
            return [("const", t.val)]
        if t.kind == "{":
            return [self.tablector()]
        self.expect("(")
        args = [] if self.check(")") else self.explist()
        self.expect(")")
        return args

    def tablector(self):
        line = self.expect("{").line
        items = []  # ("item", exp) | ("kv", kexp, vexp)
        while not self.check("}"):
            t = self.peek()
            if t.kind == "[":
                self.next()
                k = self.expr()
                self.expect("]")
                self.expect("=")
                items.append(("kv", k, self.expr()))
            elif (t.kind == "name"
                  and self.toks[self.pos + 1].kind == "="):
                self.next()
                self.next()
                items.append(("kv", ("const", t.val), self.expr()))
            else:
                items.append(("item", self.expr()))
            if not (self.accept(",") or self.accept(";")):
                break
        self.expect("}")
        return ("table", items, line)


# ----------------------------------------------------------------- evaluator


class _Env:
    """Lexical scope: dict chain. Globals live in runtime.globals."""

    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def find(self, name) -> Optional["_Env"]:
        e = self
        while e is not None:
            if name in e.vars:
                return e
            e = e.parent
        return None


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values


class LuaRuntime:
    """One Lua state: globals + stdlib. ``execute(src)`` runs a chunk in
    the global env; ``call`` invokes a LuaFunction with Python args."""

    def __init__(self, chunk_loader: Optional[Callable[[str], str]] = None,
                 max_steps: int = 50_000_000):
        self.globals = LuaTable()
        self.chunk_loader = chunk_loader  # for require()
        self._loaded: Dict[str, Any] = {}
        self._steps = 0
        # Re-entrancy depth of execute()/call().  The step budget is
        # per top-level invocation, not per runtime lifetime: a hook
        # runtime lives for the broker's lifetime and would otherwise
        # exhaust max_steps cumulatively and deny every later call.
        # Nested entries (a Lua callback passed back into call() from a
        # host function, e.g. a gsub repl) share the outer invocation's
        # budget, so a script can't launder steps through callbacks.
        self._depth = 0
        self._line = 0  # source line of the statement being executed
        self.max_steps = max_steps  # runaway-script guard
        self._install_stdlib()

    # ------------------------------------------------------------- public

    def execute(self, src: str, chunkname: str = "script"):
        if self._depth == 0:
            self._steps = 0
        self._depth += 1
        try:
            toks = _lex(src, chunkname)
            ast = _Parser(toks, chunkname).parse_chunk()
            env = _Env()
            self._exec_block(ast, env, [])
        except _Return as r:
            return r.values
        except RecursionError:
            # pathological nesting/recursion must surface as a Lua error
            # (hooks run these scripts in-process — a raw RecursionError
            # would escape the hook error handling)
            raise LuaError(f"{chunkname}: stack overflow") from None
        except LuaError:
            raise
        except Exception as e:
            # defense in depth: NOTHING but LuaError may escape the
            # interpreter into the broker (an interpreter bug must fail
            # the one script, not the hook machinery); the original
            # traceback survives on __cause__
            raise LuaError(f"{chunkname}: internal error: "
                           f"{type(e).__name__}: {e}") from e
        finally:
            self._depth -= 1
        return []

    def call(self, fn, args: List[Any]) -> List[Any]:
        """Call a Lua (or Python) function value with a Python arg list,
        returning the full result list."""
        if self._depth == 0:
            self._steps = 0
        self._depth += 1
        try:
            return self._call(fn, list(args), 0)
        except RecursionError:
            raise LuaError("stack overflow") from None
        except LuaError:
            raise
        except Exception as e:  # same escape barrier as execute()
            raise LuaError(f"internal error: {type(e).__name__}: {e}") \
                from e
        finally:
            self._depth -= 1

    def get_global(self, name: str):
        return self.globals.get(name)

    def set_global(self, name: str, value):
        self.globals.set(name, value)

    # ------------------------------------------------------- control plumbing

    def _tick(self, line):
        self._steps += 1
        if self._steps > self.max_steps:
            raise LuaError(f"script exceeded {self.max_steps} steps "
                           f"(line {line})")

    def _call(self, fn, args: List[Any], line) -> List[Any]:
        if isinstance(fn, LuaFunction):
            env = _Env(fn.env)
            for i, p in enumerate(fn.params):
                env.vars[p] = args[i] if i < len(args) else None
            varargs = args[len(fn.params):] if fn.is_vararg else []
            caller_line = self._line  # restore after: loop ticks at the
            # call site must report the caller's line, not the callee's
            try:
                self._exec_block(fn.body, env, varargs)
            except _Return as r:
                return r.values
            finally:
                self._line = caller_line
            return []
        if isinstance(fn, LuaTable):
            mt = fn.metatable
            if mt is not None:
                h = mt.get("__call")
                if h is not None:
                    return self._call(h, [fn] + args, line)
            raise LuaError(f"attempt to call a table value (line {line})")
        if callable(fn):
            try:
                res = fn(*args)
            except (LuaError, _Break, _Return):
                raise
            except Exception as e:
                # any Python fault in a host function (arity TypeError,
                # math-domain ValueError, OverflowError, MemoryError from
                # string.rep('a', 1e18), ...) surfaces as a Lua error —
                # catchable with pcall, never a raw Python exception
                # escaping into the broker's hook machinery. Chained
                # `from e` so the original traceback survives on
                # __cause__ for host-side debugging (a genuine bug in a
                # connector body is still loggable with exc_info).
                raise LuaError(
                    f"host function error (line {line}): "
                    f"{type(e).__name__}: {e}") from e
            if isinstance(res, tuple):
                return list(res)
            return [] if res is None else [res]
        raise LuaError(f"attempt to call a {_typename(fn)} value "
                       f"(line {line})")

    # --------------------------------------------------------------- indexing

    def _index(self, obj, key, line):
        if isinstance(obj, LuaTable):
            v = obj.hash.get(LuaTable._norm(key))
            if v is not None:
                return v
            mt = obj.metatable
            if mt is not None:
                h = mt.get("__index")
                if isinstance(h, LuaTable):
                    return self._index(h, key, line)
                if h is not None:
                    r = self._call(h, [obj, key], line)
                    return r[0] if r else None
            return None
        if isinstance(obj, str):
            strlib = self.globals.get("string")
            return strlib.get(key) if strlib is not None else None
        raise LuaError(f"attempt to index a {_typename(obj)} value "
                       f"(line {line})")

    def _setindex(self, obj, key, value, line):
        if isinstance(obj, LuaTable):
            if obj.hash.get(LuaTable._norm(key)) is None and obj.metatable:
                h = obj.metatable.get("__newindex")
                if isinstance(h, LuaTable):
                    return self._setindex(h, key, value, line)
                if h is not None:
                    self._call(h, [obj, key, value], line)
                    return
            obj.set(key, value)
            return
        raise LuaError(f"attempt to index a {_typename(obj)} value "
                       f"(line {line})")

    # ------------------------------------------------------------- statements

    def _exec_block(self, stats, env, varargs):
        for st in stats:
            self._exec_stat(st, env, varargs)

    def _exec_stat(self, st, env, varargs):
        if st[0] == "@":  # line-annotated wrapper from the parser
            self._line = st[1]
            st = st[2]
        op = st[0]
        self._tick(self._line)
        if op == "exprstat":
            self._eval_multi(st[1], env, varargs)
        elif op == "assign":
            _, targets, exps = st
            vals = self._eval_explist(exps, env, varargs, len(targets))
            for tgt, v in zip(targets, vals):
                if tgt[0] == "name":
                    name = tgt[1]
                    e = env.find(name)
                    if e is not None:
                        e.vars[name] = v
                    else:
                        self.globals.set(name, v)
                else:  # index
                    obj = self._eval(tgt[1], env, varargs)
                    key = self._eval(tgt[2], env, varargs)
                    self._setindex(obj, key, v, tgt[3])
        elif op == "local":
            _, names, exps = st
            vals = self._eval_explist(exps, env, varargs, len(names))
            for n, v in zip(names, vals):
                env.vars[n] = v
        elif op == "localfunc":
            _, name, fnexp = st
            env.vars[name] = None  # visible to itself (recursion)
            fn = self._eval(fnexp, env, varargs)
            fn.name = name
            env.vars[name] = fn
        elif op == "if":
            _, arms, els = st
            for cond, body in arms:
                if _truthy(self._eval(cond, env, varargs)):
                    self._exec_block(body, _Env(env), varargs)
                    return
            if els is not None:
                self._exec_block(els, _Env(env), varargs)
        elif op == "while":
            _, cond, body = st
            while _truthy(self._eval(cond, env, varargs)):
                self._tick(self._line)
                try:
                    self._exec_block(body, _Env(env), varargs)
                except _Break:
                    break
        elif op == "repeat":
            _, body, cond = st
            while True:
                self._tick(self._line)
                scope = _Env(env)
                try:
                    self._exec_block(body, scope, varargs)
                except _Break:
                    break
                # until's scope includes the body's locals (5.1 rule)
                if _truthy(self._eval(cond, scope, varargs)):
                    break
        elif op == "fornum":
            _, name, e1, e2, e3, body = st
            i = _arith_num(self._eval(e1, env, varargs), "initialise with")
            stop = _arith_num(self._eval(e2, env, varargs), "limit with")
            step = _arith_num(self._eval(e3, env, varargs), "step with")
            if step == 0:
                raise LuaError("'for' step is zero")
            while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                self._tick(self._line)
                scope = _Env(env)
                scope.vars[name] = i
                try:
                    self._exec_block(body, scope, varargs)
                except _Break:
                    break
                i += step
        elif op == "forin":
            _, names, exps, body = st
            vals = self._eval_explist(exps, env, varargs, 3)
            f, s, ctl = vals[0], vals[1], vals[2]
            while True:
                self._tick(self._line)
                rs = self._call(f, [s, ctl], 0)
                if not rs or rs[0] is None:
                    break
                ctl = rs[0]
                scope = _Env(env)
                for i, n in enumerate(names):
                    scope.vars[n] = rs[i] if i < len(rs) else None
                try:
                    self._exec_block(body, scope, varargs)
                except _Break:
                    break
        elif op == "do":
            self._exec_block(st[1], _Env(env), varargs)
        elif op == "return":
            raise _Return(self._eval_explist(st[1], env, varargs, -1))
        elif op == "break":
            raise _Break()
        else:  # pragma: no cover
            raise LuaError(f"unknown statement {op}")

    # ------------------------------------------------------------ expressions

    def _eval_explist(self, exps, env, varargs, want: int) -> List[Any]:
        """Evaluate an expression list with Lua multi-value adjustment:
        every expression but the last yields one value; the last expands
        if it is a call/vararg. ``want`` < 0 = keep all."""
        vals: List[Any] = []
        for i, e in enumerate(exps):
            if i == len(exps) - 1:
                vals.extend(self._eval_multi(e, env, varargs))
            else:
                vals.append(self._eval(e, env, varargs))
        if want >= 0:
            while len(vals) < want:
                vals.append(None)
            del vals[want:]
        return vals

    def _eval_multi(self, e, env, varargs) -> List[Any]:
        op = e[0]
        if op == "call":
            fn = self._eval(e[1], env, varargs)
            args = self._eval_explist(e[2], env, varargs, -1)
            return self._call(fn, args, e[3])
        if op == "method":
            obj = self._eval(e[1], env, varargs)
            fn = self._index(obj, e[2], e[4])
            args = self._eval_explist(e[3], env, varargs, -1)
            return self._call(fn, [obj] + args, e[4])
        if op == "vararg":
            return list(varargs)
        return [self._eval(e, env, varargs)]

    def _eval(self, e, env, varargs):
        op = e[0]
        if op == "const":
            return e[1]
        if op == "name":
            name = e[1]
            scope = env.find(name)
            if scope is not None:
                return scope.vars[name]
            return self.globals.get(name)
        if op == "paren":
            return self._eval(e[1], env, varargs)
        if op == "index":
            obj = self._eval(e[1], env, varargs)
            key = self._eval(e[2], env, varargs)
            return self._index(obj, key, e[3])
        if op in ("call", "method", "vararg"):
            r = self._eval_multi(e, env, varargs)
            return r[0] if r else None
        if op == "function":
            _, params, is_va, body, _line = e
            return LuaFunction(params, is_va, body, env, self)
        if op == "table":
            t = LuaTable()
            items = e[1]
            for i, it in enumerate(items):
                if it[0] == "kv":
                    k = self._eval(it[1], env, varargs)
                    t.set(k, self._eval(it[2], env, varargs))
                else:
                    if i == len(items) - 1:
                        for v in self._eval_multi(it[1], env, varargs):
                            t.append(v)
                    else:
                        t.append(self._eval(it[1], env, varargs))
            return t
        if op == "binop":
            return self._binop(e, env, varargs)
        if op == "unop":
            _, o, sub, line = e
            v = self._eval(sub, env, varargs)
            if o == "-":
                return -_arith_num(v)
            if o == "not":
                return not _truthy(v)
            if o == "#":
                if isinstance(v, str):
                    return len(v)
                if isinstance(v, LuaTable):
                    return v.length()
                raise LuaError(f"attempt to get length of a "
                               f"{_typename(v)} value (line {line})")
        raise LuaError(f"unknown expression {op}")  # pragma: no cover

    def _binop(self, e, env, varargs):
        _, o, le, re_, line = e
        if o == "and":
            l = self._eval(le, env, varargs)
            return self._eval(re_, env, varargs) if _truthy(l) else l
        if o == "or":
            l = self._eval(le, env, varargs)
            return l if _truthy(l) else self._eval(re_, env, varargs)
        l = self._eval(le, env, varargs)
        r = self._eval(re_, env, varargs)
        if o == "==":
            return self._eq(l, r)
        if o == "~=":
            return not self._eq(l, r)
        if o == "..":
            for v in (l, r):
                if not isinstance(v, (str, int, float)) \
                        or isinstance(v, bool):
                    raise LuaError(f"attempt to concatenate a "
                                   f"{_typename(v)} value (line {line})")
            return (lua_tostring(l) if not isinstance(l, str) else l) + \
                   (lua_tostring(r) if not isinstance(r, str) else r)
        if o in ("<", "<=", ">", ">="):
            if isinstance(l, str) and isinstance(r, str):
                pass
            elif isinstance(l, (int, float)) and isinstance(r, (int, float)) \
                    and not isinstance(l, bool) and not isinstance(r, bool):
                pass
            else:
                raise LuaError(f"attempt to compare "
                               f"{_typename(l)} with {_typename(r)} "
                               f"(line {line})")
            if o == "<":
                return l < r
            if o == "<=":
                return l <= r
            if o == ">":
                return l > r
            return l >= r
        ln = _arith_num(l)
        rn = _arith_num(r)
        if o == "+":
            return ln + rn
        if o == "-":
            return ln - rn
        if o == "*":
            return ln * rn
        if o == "/":
            if rn == 0:
                return _math.inf if ln > 0 else (
                    -_math.inf if ln < 0 else _math.nan)
            res = ln / rn
            return res
        if o == "%":
            if rn == 0:
                return _math.nan
            try:
                return ln - _math.floor(ln / rn) * rn
            except (OverflowError, ValueError):
                return _math.nan  # inf/nan operand: no integral quotient
        if o == "^":
            try:
                return float(ln) ** float(rn)
            except OverflowError:
                # C pow semantics (Lua 5.1): huge results saturate to
                # ±inf (sign = negative base with odd integer exponent)
                neg = (ln < 0 and float(rn).is_integer()
                       and int(rn) % 2 == 1)
                return -_math.inf if neg else _math.inf
            except ZeroDivisionError:  # 0 ^ negative
                return _math.inf
        raise LuaError(f"unknown operator {o}")  # pragma: no cover

    @staticmethod
    def _eq(l, r) -> bool:
        if type(l) is bool or type(r) is bool:
            return l is r
        if isinstance(l, (int, float)) and isinstance(r, (int, float)):
            return l == r
        if isinstance(l, str) and isinstance(r, str):
            return l == r
        return l is r

    # ---------------------------------------------------------------- stdlib

    def _install_stdlib(self):
        g = self.globals

        def _print(*args):
            print("\t".join(lua_tostring(a) for a in args))

        def _assert(*args):
            if not args or not _truthy(args[0]):
                msg = args[1] if len(args) > 1 else "assertion failed!"
                raise LuaError(msg)
            return tuple(args)

        def _error(msg=None, _level=1):
            raise LuaError(msg)

        def _pcall(f, *args):
            try:
                res = self._call(f, list(args), 0)
                return tuple([True] + res)
            except LuaError as exc:
                return (False, exc.value)
            except (_Break, _Return):
                raise
            except Exception as exc:  # python-level fault
                return (False, str(exc))

        def _ipairs(t):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument #1 to 'ipairs' (table expected)")

            def it(tbl, i):
                i = int(i) + 1
                v = tbl.get(i)
                if v is None:
                    return None
                return (i, v)
            return (it, t, 0)

        def _next(t, key=None):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument #1 to 'next' (table expected)")
            keys = list(t.hash.keys())
            if key is None:
                i = 0
            else:
                try:
                    i = keys.index(LuaTable._norm(key)) + 1
                except ValueError:
                    return None
            if i >= len(keys):
                return None
            k = keys[i]
            if isinstance(k, tuple) and len(k) == 2 and k[0] == "<bool>":
                out_k = k[1]
            else:
                out_k = k
            return (out_k, t.hash[k])

        def _pairs(t):
            return (_next, t, None)

        def _select(n, *args):
            if n == "#":
                return len(args)
            n = int(n)
            if n < 1:
                raise LuaError("bad argument #1 to 'select'")
            return tuple(args[n - 1:])

        def _unpack(t, i=1, j=None):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument #1 to 'unpack'")
            i = int(i)
            j = t.length() if j is None else int(j)
            return tuple(t.get(x) for x in range(i, j + 1))

        def _rawget(t, k):
            return t.hash.get(LuaTable._norm(k))

        def _rawset(t, k, v):
            t.set(k, v)
            return t

        def _rawequal(a, b):
            return a is b or (isinstance(a, (int, float, str))
                              and type(a) is type(b) and a == b)

        def _setmetatable(t, mt):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument #1 to 'setmetatable'")
            t.metatable = mt
            return t

        def _getmetatable(t):
            return t.metatable if isinstance(t, LuaTable) else None

        def _require(name):
            if name in self._loaded:
                return self._loaded[name]
            if self.chunk_loader is None:
                raise LuaError(f"module '{name}' not found "
                               "(no loader configured)")
            src = self.chunk_loader(name)
            if src is None:
                raise LuaError(f"module '{name}' not found")
            # like the reference's diversity scripts: required chunks run
            # in the same global namespace; return value memoised
            res = self.execute(src, name)
            val = res[0] if res else True
            self._loaded[name] = val
            return val

        g.set("print", _print)
        g.set("type", lambda v=None: _typename(v))
        g.set("tostring", lambda v=None: lua_tostring(v))
        g.set("tonumber", lambda v=None, base=None: _tonum(v, base))
        g.set("assert", _assert)
        g.set("error", _error)
        g.set("pcall", _pcall)
        g.set("ipairs", _ipairs)
        g.set("pairs", _pairs)
        g.set("next", _next)
        g.set("select", _select)
        g.set("unpack", _unpack)
        g.set("rawget", _rawget)
        g.set("rawset", _rawset)
        g.set("rawequal", _rawequal)
        g.set("setmetatable", _setmetatable)
        g.set("getmetatable", _getmetatable)
        g.set("require", _require)
        g.set("_G", g)
        g.set("_VERSION", "Lua 5.1")

        # ---- string ----
        s = LuaTable()

        def _checkstr(v, fname):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return _num_str(v)
            if not isinstance(v, str):
                raise LuaError(f"bad argument #1 to '{fname}' "
                               f"(string expected, got {_typename(v)})")
            return v

        def _stridx(st, i, default):
            if i is None:
                i = default
            i = int(i)
            if i < 0:
                i = max(len(st) + i + 1, 1)
            elif i == 0:
                i = 1
            return i

        def _sub(st, i=1, j=-1):
            st = _checkstr(st, "sub")
            i = _stridx(st, i, 1)
            j = int(j)
            if j < 0:
                j = len(st) + j + 1
            j = min(j, len(st))
            if i > j:
                return ""
            return st[i - 1:j]

        def _format(fmt, *args):
            fmt = _checkstr(fmt, "format")
            out = []
            ai = 0
            i = 0
            while i < len(fmt):
                c = fmt[i]
                if c != "%":
                    out.append(c)
                    i += 1
                    continue
                j = i + 1
                while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                    j += 1
                if j >= len(fmt):
                    raise LuaError("invalid format string")
                spec = fmt[i:j + 1]
                conv = fmt[j]
                i = j + 1
                if conv == "%":
                    out.append("%")
                    continue
                arg = args[ai] if ai < len(args) else None
                ai += 1
                if conv in "di":
                    out.append((spec[:-1] + "d") % int(_arith_num(arg)))
                elif conv in "uc":
                    out.append((spec[:-1] + "d") % int(_arith_num(arg)))
                elif conv in "eEfgG":
                    out.append(spec % float(_arith_num(arg)))
                elif conv in "xX":
                    out.append(spec % int(_arith_num(arg)))
                elif conv == "q":
                    st = lua_tostring(arg)
                    out.append('"' + st.replace("\\", "\\\\")
                               .replace('"', '\\"').replace("\n", "\\n") + '"')
                elif conv == "s":
                    out.append(spec % lua_tostring(arg))
                else:
                    raise LuaError(f"invalid option '%{conv}' to 'format'")
            return "".join(out)

        s.set("len", lambda st: len(_checkstr(st, "len")))
        s.set("sub", _sub)
        s.set("upper", lambda st: _checkstr(st, "upper").upper())
        s.set("lower", lambda st: _checkstr(st, "lower").lower())
        s.set("rep", lambda st, n: _checkstr(st, "rep") * max(int(n), 0))
        s.set("reverse", lambda st: _checkstr(st, "reverse")[::-1])
        s.set("byte", lambda st, i=1, j=None: tuple(
            ord(c) for c in _sub(st, i, i if j is None else j)))
        s.set("char", lambda *a: "".join(chr(int(x)) for x in a))
        s.set("format", _format)
        s.set("find", lambda st, pat, init=1, plain=None:
              _str_find(st, pat, init, plain))
        s.set("match", _str_match)
        s.set("gmatch", _str_gmatch)
        s.set("gsub", _str_gsub)
        g.set("string", s)

        # ---- table ----
        tb = LuaTable()

        def _tinsert(t, a, b=None):
            if b is None:
                t.append(a)
            else:
                pos = int(a)
                n = t.length()
                for i in range(n, pos - 1, -1):
                    t.set(i + 1, t.get(i))
                t.set(pos, b)

        def _tremove(t, pos=None):
            n = t.length()
            if n == 0:
                return None
            pos = n if pos is None else int(pos)
            v = t.get(pos)
            for i in range(pos, n):
                t.set(i, t.get(i + 1))
            t.set(n, None)
            return v

        def _tconcat(t, sep="", i=1, j=None):
            j = t.length() if j is None else int(j)
            parts = []
            for x in range(int(i), j + 1):
                v = t.get(x)
                if not isinstance(v, (str, int, float)) \
                        or isinstance(v, bool):
                    raise LuaError(f"invalid value (at index {x}) in "
                                   "table for 'concat'")
                parts.append(lua_tostring(v))
            return sep.join(parts)

        def _tsort(t, comp=None):
            n = t.length()
            items = [t.get(i) for i in range(1, n + 1)]
            if comp is None:
                items.sort()
            else:
                import functools

                def cmp(a, b):
                    r = self._call(comp, [a, b], 0)
                    if r and _truthy(r[0]):
                        return -1
                    r2 = self._call(comp, [b, a], 0)
                    return 1 if (r2 and _truthy(r2[0])) else 0
                items.sort(key=functools.cmp_to_key(cmp))
            for i, v in enumerate(items):
                t.set(i + 1, v)

        tb.set("insert", _tinsert)
        tb.set("remove", _tremove)
        tb.set("concat", _tconcat)
        tb.set("sort", _tsort)
        tb.set("getn", lambda t: t.length())
        g.set("table", tb)

        # ---- math ----
        m = LuaTable()
        for name in ("floor", "ceil", "sqrt", "sin", "cos", "tan", "asin",
                     "acos", "atan", "exp", "log"):
            m.set(name, (lambda fn: lambda x: fn(_arith_num(x)))(
                getattr(_math, name)))
        m.set("abs", lambda x: abs(_arith_num(x)))
        m.set("max", lambda *a: max(_arith_num(x) for x in a))
        m.set("min", lambda *a: min(_arith_num(x) for x in a))
        m.set("huge", _math.inf)
        m.set("pi", _math.pi)
        m.set("fmod", lambda a, b: _math.fmod(_arith_num(a), _arith_num(b)))
        m.set("modf", lambda x: (float(_math.floor(_arith_num(x)))
                                 if _arith_num(x) >= 0 else
                                 float(_math.ceil(_arith_num(x))),
                                 _arith_num(x) - int(_arith_num(x))))
        m.set("pow", lambda a, b: float(_arith_num(a)) ** float(_arith_num(b)))
        m.set("random", _lua_random)
        m.set("randomseed", lambda x=None: _RNG.seed(x))
        g.set("math", m)

        # ---- os (sandboxed subset) ----
        o = LuaTable()
        o.set("time", lambda t=None: int(_time.time()))
        o.set("clock", lambda: _time.process_time())
        g.set("os", o)


import random as _random_mod

_RNG = _random_mod.Random()


def _lua_random(m=None, n=None):
    if m is None:
        return _RNG.random()
    m = int(m)
    if n is None:
        return _RNG.randint(1, m)
    return _RNG.randint(m, int(n))


# ------------------------------------------------------------- lua patterns

_CLASS_MAP = {
    "a": "[a-zA-Z]", "A": "[^a-zA-Z]",
    "d": "[0-9]", "D": "[^0-9]",
    "l": "[a-z]", "L": "[^a-z]",
    "s": "[ \\t\\n\\r\\f\\v]", "S": "[^ \\t\\n\\r\\f\\v]",
    "u": "[A-Z]", "U": "[^A-Z]",
    "w": "[a-zA-Z0-9]", "W": "[^a-zA-Z0-9]",
    "x": "[0-9a-fA-F]", "X": "[^0-9a-fA-F]",
    "p": "[\\!-/\\:-@\\[-`\\{-~]", "P": "[^\\!-/\\:-@\\[-`\\{-~]",
    "c": "[\\x00-\\x1f]", "C": "[^\\x00-\\x1f]",
}


def _lua_pat_to_re(pat: str) -> str:
    """Translate a Lua 5.1 pattern to a Python regex (subset: classes,
    sets, anchors, quantifiers ``* + - ?``, captures, ``%b`` excluded)."""
    out = []
    i, n = 0, len(pat)
    if pat.startswith("^"):
        out.append("^")
        i = 1
    while i < n:
        c = pat[i]
        if c == "%":
            i += 1
            if i >= n:
                raise LuaError("malformed pattern (ends with '%')")
            e = pat[i]
            if e in _CLASS_MAP:
                out.append(_CLASS_MAP[e])
            elif e.isdigit():
                out.append("\\" + e)  # back-reference
            elif e in ("b", "f"):
                # %bxy balanced match / %f frontier have no regex
                # translation — fail loudly rather than silently match
                # a literal (decline-don't-guess)
                raise LuaError(f"unsupported pattern item %{e}")
            else:
                out.append(_re.escape(e))
            i += 1
        elif c == "[":
            j = i + 1
            neg = False
            if j < n and pat[j] == "^":
                neg = True
                j += 1
            setbuf = []
            first = True
            while j < n and (pat[j] != "]" or first):
                first = False
                if pat[j] == "%" and j + 1 < n:
                    e = pat[j + 1]
                    if e in _CLASS_MAP:
                        setbuf.append(_CLASS_MAP[e][1:-1])
                    else:
                        setbuf.append(_re.escape(e))
                    j += 2
                else:
                    ch = pat[j]
                    if j + 2 < n and pat[j + 1] == "-" and pat[j + 2] != "]":
                        setbuf.append(_re.escape(ch) + "-"
                                      + _re.escape(pat[j + 2]))
                        j += 3
                    else:
                        setbuf.append(_re.escape(ch))
                        j += 1
            if j >= n:
                raise LuaError("malformed pattern (missing ']')")
            out.append("[" + ("^" if neg else "") + "".join(setbuf) + "]")
            i = j + 1
        elif c == "(":
            if i + 1 < n and pat[i + 1] == ")":
                # () position captures return an index, which a regex
                # group can't express — fail loudly, don't return ""
                raise LuaError("unsupported pattern item () "
                               "(position capture)")
            out.append("(")
            i += 1
        elif c == ")":
            out.append(")")
            i += 1
        elif c == ".":
            out.append(".")
            i += 1
        elif c == "$" and i == n - 1:
            out.append("$")
            i += 1
        else:
            out.append(_re.escape(c))
            i += 1
        # quantifier following a single-char item
        if i < n and pat[i] in "*+-?" and out and out[-1] not in ("(", "^"):
            q = pat[i]
            out.append({"*": "*", "+": "+", "-": "*?", "?": "?"}[q])
            i += 1
    return "".join(out)


def _match_groups(m) -> Tuple:
    if m.lastindex:
        return tuple(m.group(i) for i in range(1, m.lastindex + 1))
    return (m.group(0),)


def _str_find(st, pat, init=1, plain=None):
    if not isinstance(st, str):
        st = lua_tostring(st)
    start = max(int(init) - 1, 0) if init else 0
    if _truthy(plain):
        idx = st.find(pat, start)
        if idx < 0:
            return None
        return (idx + 1, idx + len(pat))
    m = _re.compile(_lua_pat_to_re(pat), _re.DOTALL).search(st, start)
    if m is None:
        return None
    res = [m.start() + 1, m.end()]
    if m.lastindex:
        res.extend(m.group(i) for i in range(1, m.lastindex + 1))
    return tuple(res)


def _str_match(st, pat, init=1):
    if not isinstance(st, str):
        st = lua_tostring(st)
    start = max(int(init) - 1, 0) if init else 0
    m = _re.compile(_lua_pat_to_re(pat), _re.DOTALL).search(st, start)
    if m is None:
        return None
    g = _match_groups(m)
    return g if len(g) > 1 else g[0]


def _str_gmatch(st, pat):
    if not isinstance(st, str):
        st = lua_tostring(st)
    it = _re.compile(_lua_pat_to_re(pat), _re.DOTALL).finditer(st)

    def step(*_ignored):
        for m in it:
            g = _match_groups(m)
            return g if len(g) > 1 else g[0]
        return None
    return step


def _str_gsub(st, pat, repl, n=None):
    if not isinstance(st, str):
        st = lua_tostring(st)
    rx = _re.compile(_lua_pat_to_re(pat), _re.DOTALL)
    count = 0
    limit = -1 if n is None else int(n)
    out = []
    pos = 0
    while limit < 0 or count < limit:
        m = rx.search(st, pos)
        if m is None:
            break
        out.append(st[pos:m.start()])
        groups = _match_groups(m)
        if isinstance(repl, str):
            rep = []
            i = 0
            while i < len(repl):
                c = repl[i]
                if c == "%" and i + 1 < len(repl):
                    d = repl[i + 1]
                    if d == "0":
                        rep.append(m.group(0))
                    elif d.isdigit():
                        gi = int(d)
                        rep.append(groups[gi - 1] if gi <= len(groups)
                                   else "")
                    else:
                        rep.append(d)
                    i += 2
                else:
                    rep.append(c)
                    i += 1
            out.append("".join(rep))
        elif isinstance(repl, LuaTable):
            v = repl.get(groups[0])
            out.append(lua_tostring(v) if _truthy(v) else m.group(0))
        elif callable(repl) or isinstance(repl, LuaFunction):
            if isinstance(repl, LuaFunction):
                r = repl.runtime.call(repl, list(groups))
                v = r[0] if r else None
            else:
                v = repl(*groups)
                if isinstance(v, tuple):
                    v = v[0] if v else None
            out.append(lua_tostring(v) if _truthy(v) else m.group(0))
        else:
            raise LuaError("bad argument #3 to 'gsub'")
        count += 1
        new_pos = m.end()
        if new_pos == pos:  # empty match: advance one char
            if pos < len(st):
                out.append(st[pos])
            new_pos = pos + 1
        pos = new_pos
    out.append(st[pos:])
    return ("".join(out), count)


# --------------------------------------------------------------- conversion


def to_lua(v, _depth=0):
    """Python → Lua value: dicts/lists become tables (recursively)."""
    if _depth > 32:
        raise LuaError("to_lua: structure too deep")
    if v is None or isinstance(v, (bool, int, float, str, LuaTable,
                                   LuaFunction)):
        return v
    if callable(v):
        return v
    if isinstance(v, bytes):
        return v.decode("utf-8", "surrogateescape")
    if isinstance(v, dict):
        t = LuaTable()
        for k, val in v.items():
            t.set(to_lua(k, _depth + 1), to_lua(val, _depth + 1))
        return t
    if isinstance(v, (list, tuple)):
        t = LuaTable()
        for item in v:
            t.append(to_lua(item, _depth + 1))
        return t
    return str(v)


def from_lua(v, _depth=0):
    """Lua → Python value: array-shaped tables become lists, the rest
    dicts (string keys)."""
    if _depth > 32:
        raise LuaError("from_lua: structure too deep")
    if not isinstance(v, LuaTable):
        return v
    n = v.length()
    if n and len(v.hash) == n:
        return [from_lua(v.get(i), _depth + 1) for i in range(1, n + 1)]
    out = {}
    for k, val in v.hash.items():
        if isinstance(k, tuple) and len(k) == 2 and k[0] == "<bool>":
            k = k[1]
        out[k] = from_lua(val, _depth + 1)
    return out
