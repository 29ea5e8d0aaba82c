"""S3 Select SQL: lexer, recursive-descent parser, evaluator
(``minio_tpu/s3select/sql.py``).

pkg/s3select/sql/ (participle-generated parser in parser.go,
evaluation in evaluate.go, aggregates in aggregation.go, functions in
funceval.go).  Supported surface (the S3 Select dialect — one table, no
joins, no GROUP BY):

    SELECT <* | expr [AS alias], ...>
    FROM S3Object[.path] [[AS] alias]
    [WHERE <expr>] [LIMIT n]

Expressions: literals, column refs (names, "quoted", _N positional,
alias.col), arithmetic + - * / %, comparisons = != <> < <= > >=,
AND/OR/NOT, LIKE [ESCAPE], IN (...), BETWEEN, IS [NOT] NULL,
CAST(x AS t), COALESCE, NULLIF, string functions (LOWER/UPPER/TRIM/
CHAR_LENGTH/CHARACTER_LENGTH/SUBSTRING), and aggregates COUNT/SUM/AVG/
MIN/MAX.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Optional


class SQLError(Exception):
    pass


# ---------------------------------------------------------------- lexer ----

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+)
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<string>'(?:[^']|'')*')
  | (?P<op><>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.|\[|\])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
""", re.VERBOSE)

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "LIMIT", "AS", "AND", "OR", "NOT", "LIKE",
    "ESCAPE", "IN", "BETWEEN", "IS", "NULL", "TRUE", "FALSE", "CAST",
    "COALESCE", "NULLIF", "COUNT", "SUM", "AVG", "MIN", "MAX",
}


@dataclass
class Token:
    kind: str      # number|string|ident|qident|op|kw|eof
    value: str


def tokenize(text: str) -> list[Token]:
    out: list[Token] = []
    i = 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise SQLError(f"unexpected character {text[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        v = m.group()
        if kind == "ident" and v.upper() in KEYWORDS:
            out.append(Token("kw", v.upper()))
        else:
            out.append(Token(kind, v))
    out.append(Token("eof", ""))
    return out


# ------------------------------------------------------------------ AST ----

@dataclass
class Literal:
    value: Any


@dataclass
class Column:
    path: list[str]        # ["alias", "a", "b"] → row["a"]["b"] after alias


@dataclass
class Unary:
    op: str
    operand: Any


@dataclass
class Binary:
    op: str
    left: Any
    right: Any


@dataclass
class Between:
    expr: Any
    lo: Any
    hi: Any
    negate: bool


@dataclass
class Like:
    expr: Any
    pattern: Any
    escape: Optional[str]
    negate: bool


@dataclass
class InList:
    expr: Any
    items: list
    negate: bool


@dataclass
class IsNull:
    expr: Any
    negate: bool


@dataclass
class Cast:
    expr: Any
    type: str


@dataclass
class Func:
    name: str
    args: list
    star: bool = False     # COUNT(*)


@dataclass
class Projection:
    expr: Any              # None for SELECT *
    alias: str


@dataclass
class Query:
    projections: list[Projection]   # empty = SELECT *
    table_alias: str
    where: Any
    limit: Optional[int]
    aggregate: bool


AGGREGATES = {"COUNT", "SUM", "AVG", "MIN", "MAX"}
SCALAR_FUNCS = {"LOWER", "UPPER", "TRIM", "CHAR_LENGTH",
                "CHARACTER_LENGTH", "LENGTH", "SUBSTRING", "COALESCE",
                "NULLIF", "UTCNOW", "ABS"}


class Parser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: str | None = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: str | None = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            raise SQLError(f"expected {value or kind}, "
                           f"got {self.peek().value!r}")
        return t

    # -- grammar ----------------------------------------------------------

    def parse_query(self) -> Query:
        self.expect("kw", "SELECT")
        projections: list[Projection] = []
        if self.accept("op", "*"):
            pass
        else:
            while True:
                e = self.expr()
                alias = ""
                if self.accept("kw", "AS"):
                    alias = self._ident_name()
                elif self.peek().kind in ("ident", "qident"):
                    alias = self._ident_name()
                projections.append(Projection(e, alias))
                if not self.accept("op", ","):
                    break
        self.expect("kw", "FROM")
        table_alias = self._from_clause()
        where = None
        if self.accept("kw", "WHERE"):
            where = self.expr()
        limit = None
        if self.accept("kw", "LIMIT"):
            t = self.expect("number")
            limit = int(float(t.value))
        self.expect("eof")
        has_agg = any(self._has_aggregate(p.expr) for p in projections)
        if has_agg and not all(self._has_aggregate(p.expr)
                               for p in projections):
            raise SQLError("cannot mix aggregate and non-aggregate "
                           "projections")
        return Query(projections, table_alias, where, limit, has_agg)

    def _ident_name(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().value
        if t.kind == "qident":
            return self.next().value[1:-1].replace('""', '"')
        raise SQLError(f"expected identifier, got {t.value!r}")

    def _from_clause(self) -> str:
        name = self._ident_name()
        if name.lower() not in ("s3object", "s3objects"):
            raise SQLError("FROM must reference S3Object")
        if self.accept("op", "["):      # FROM S3Object[*] — the JSON
            self.expect("op", "*")      # document-array form
            self.expect("op", "]")
        while self.accept("op", "."):   # S3Object.path — path ignored for
            self._ident_name()          # flat records (JMESPath-ish)
        if self.accept("kw", "AS"):
            return self._ident_name()
        if self.peek().kind in ("ident", "qident"):
            return self._ident_name()
        return ""

    def _has_aggregate(self, node) -> bool:
        if isinstance(node, Func) and node.name in AGGREGATES:
            return True
        for f in getattr(node, "__dataclass_fields__", {}):
            v = getattr(node, f)
            if isinstance(v, list):
                if any(self._has_aggregate(x) for x in v
                       if hasattr(x, "__dataclass_fields__")):
                    return True
            elif hasattr(v, "__dataclass_fields__") and \
                    self._has_aggregate(v):
                return True
        return False

    def expr(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.accept("kw", "OR"):
            left = Binary("OR", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.accept("kw", "AND"):
            left = Binary("AND", left, self.not_expr())
        return left

    def not_expr(self):
        if self.accept("kw", "NOT"):
            return Unary("NOT", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        left = self.add_expr()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">",
                                          ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return Binary(op, left, self.add_expr())
        negate = False
        if t.kind == "kw" and t.value == "NOT" and \
                self.toks[self.i + 1].kind == "kw" and \
                self.toks[self.i + 1].value in ("LIKE", "IN", "BETWEEN"):
            self.next()
            negate = True
            t = self.peek()
        if self.accept("kw", "BETWEEN"):
            lo = self.add_expr()
            self.expect("kw", "AND")
            return Between(left, lo, self.add_expr(), negate)
        if self.accept("kw", "LIKE"):
            pattern = self.add_expr()
            esc = None
            if self.accept("kw", "ESCAPE"):
                e = self.expect("string")
                esc = e.value[1:-1].replace("''", "'")
            return Like(left, pattern, esc, negate)
        if self.accept("kw", "IN"):
            self.expect("op", "(")
            items = [self.expr()]
            while self.accept("op", ","):
                items.append(self.expr())
            self.expect("op", ")")
            return InList(left, items, negate)
        if self.accept("kw", "IS"):
            neg = bool(self.accept("kw", "NOT"))
            self.expect("kw", "NULL")
            return IsNull(left, neg)
        return left

    def add_expr(self):
        left = self.mul_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = Binary(t.value, left, self.mul_expr())
            else:
                return left

    def mul_expr(self):
        left = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = Binary(t.value, left, self.unary())
            else:
                return left

    def unary(self):
        t = self.peek()
        if t.kind == "op" and t.value in ("-", "+"):
            self.next()
            return Unary(t.value, self.unary())
        return self.primary()

    def primary(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.value)
            return Literal(int(v) if v.is_integer() and
                           "." not in t.value and "e" not in t.value.lower()
                           else v)
        if t.kind == "string":
            self.next()
            return Literal(t.value[1:-1].replace("''", "'"))
        if t.kind == "kw" and t.value in ("TRUE", "FALSE"):
            self.next()
            return Literal(t.value == "TRUE")
        if t.kind == "kw" and t.value == "NULL":
            self.next()
            return Literal(None)
        if t.kind == "kw" and t.value == "CAST":
            self.next()
            self.expect("op", "(")
            e = self.expr()
            self.expect("kw", "AS")
            ty = self._ident_name().upper()
            self.expect("op", ")")
            return Cast(e, ty)
        if t.kind == "kw" and t.value in AGGREGATES:
            self.next()
            self.expect("op", "(")
            if t.value == "COUNT" and self.accept("op", "*"):
                self.expect("op", ")")
                return Func("COUNT", [], star=True)
            arg = self.expr()
            self.expect("op", ")")
            return Func(t.value, [arg])
        if t.kind == "kw" and t.value in ("COALESCE", "NULLIF"):
            self.next()
            self.expect("op", "(")
            args = [self.expr()]
            while self.accept("op", ","):
                args.append(self.expr())
            self.expect("op", ")")
            return Func(t.value, args)
        if t.kind in ("ident", "qident"):
            name = self._ident_name()
            if self.peek().kind == "op" and self.peek().value == "(":
                if name.upper() not in SCALAR_FUNCS:
                    raise SQLError(f"unknown function {name}")
                self.next()
                args = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    # SUBSTRING(x FROM n FOR m) — also accept comma form
                    self.expect("op", ")")
                return Func(name.upper(), args)
            path = [name]
            while self.accept("op", "."):
                path.append(self._ident_name())
            return Column(path)
        if self.accept("op", "("):
            e = self.expr()
            self.expect("op", ")")
            return e
        raise SQLError(f"unexpected token {t.value!r}")


def parse_query(text: str) -> Query:
    return Parser(tokenize(text)).parse_query()


# ------------------------------------------------------------- evaluator ---

_MISSING = object()


def _lookup(row: dict, path: list[str], table_alias: str):
    # strip the table alias / S3Object prefix
    parts = list(path)
    if parts and (parts[0] == table_alias or
                  parts[0].lower() in ("s3object", "s3objects")):
        parts = parts[1:]
    cur: Any = row
    for p in parts:
        if isinstance(cur, dict):
            if p in cur:
                cur = cur[p]
            elif p.lower() in cur:
                cur = cur[p.lower()]
            elif re.fullmatch(r"_\d+", p):
                # positional fallback: _N addresses the Nth column even
                # when the reader produced named keys (FileHeaderInfo=USE)
                idx = int(p[1:]) - 1
                vals = list(cur.values())
                if 0 <= idx < len(vals):
                    cur = vals[idx]
                else:
                    return _MISSING
            else:
                return _MISSING
        elif isinstance(cur, list) and p.isdigit():
            idx = int(p)
            cur = cur[idx] if idx < len(cur) else _MISSING
        else:
            return _MISSING
    return cur


def _num(v):
    """Numeric coercion for arithmetic/comparison (CSV values are text)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        try:
            f = float(v)
            return int(f) if f.is_integer() and "." not in v \
                and "e" not in v.lower() else f
        except ValueError:
            return None
    return None


def _compare(op: str, a, b) -> Optional[bool]:
    if a is None or b is None or a is _MISSING or b is _MISSING:
        return None
    na, nb = _num(a), _num(b)
    if isinstance(a, str) and isinstance(b, str):
        pass                      # string-vs-string stays textual
    elif na is not None and nb is not None:
        a, b = na, nb             # mixed string/number: numeric coercion
    elif isinstance(a, str) or isinstance(b, str):
        a, b = str(a), str(b)
    try:
        if op == "=":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
    except TypeError:
        return None
    raise SQLError(f"bad comparison {op}")


def _like_to_re(pattern: str, escape: Optional[str]) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


class Evaluator:
    def __init__(self, query: Query):
        self.q = query

    def eval(self, node, row: dict):
        if isinstance(node, Literal):
            return node.value
        if isinstance(node, Column):
            v = _lookup(row, node.path, self.q.table_alias)
            return None if v is _MISSING else v
        if isinstance(node, Unary):
            v = self.eval(node.operand, row)
            if node.op == "NOT":
                b = self._truth(v)
                return None if b is None else not b
            n = _num(v)
            if n is None:
                return None
            return -n if node.op == "-" else n
        if isinstance(node, Binary):
            if node.op in ("AND", "OR"):
                a = self._truth(self.eval(node.left, row))
                b = self._truth(self.eval(node.right, row))
                if node.op == "AND":
                    if a is False or b is False:
                        return False
                    return None if a is None or b is None else True
                if a is True or b is True:
                    return True
                return None if a is None or b is None else False
            if node.op in ("=", "!=", "<", "<=", ">", ">="):
                return _compare(node.op, self.eval(node.left, row),
                                self.eval(node.right, row))
            a, b = _num(self.eval(node.left, row)), \
                _num(self.eval(node.right, row))
            if a is None or b is None:
                return None
            try:
                if node.op == "+":
                    return a + b
                if node.op == "-":
                    return a - b
                if node.op == "*":
                    return a * b
                if node.op == "/":
                    r = a / b
                    return int(r) if isinstance(a, int) and \
                        isinstance(b, int) and a % b == 0 else r
                if node.op == "%":
                    return a % b
            except ZeroDivisionError as e:
                raise SQLError("division by zero") from e
        if isinstance(node, Between):
            v = self.eval(node.expr, row)
            lo = _compare(">=", v, self.eval(node.lo, row))
            hi = _compare("<=", v, self.eval(node.hi, row))
            if lo is None or hi is None:
                return None
            res = lo and hi
            return not res if node.negate else res
        if isinstance(node, Like):
            v = self.eval(node.expr, row)
            p = self.eval(node.pattern, row)
            if v is None or p is None:
                return None
            res = bool(_like_to_re(str(p), node.escape).match(str(v)))
            return not res if node.negate else res
        if isinstance(node, InList):
            v = self.eval(node.expr, row)
            found = False
            for item in node.items:
                c = _compare("=", v, self.eval(item, row))
                if c:
                    found = True
                    break
            return not found if node.negate else found
        if isinstance(node, IsNull):
            v = self.eval(node.expr, row)
            res = v is None or v is _MISSING
            return not res if node.negate else res
        if isinstance(node, Cast):
            return self._cast(self.eval(node.expr, row), node.type)
        if isinstance(node, Func):
            return self._func(node, row)
        raise SQLError(f"cannot evaluate {node!r}")

    @staticmethod
    def _truth(v) -> Optional[bool]:
        if v is None or v is _MISSING:
            return None
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            if v.lower() == "true":
                return True
            if v.lower() == "false":
                return False
        return bool(v)

    @staticmethod
    def _cast(v, ty: str):
        if v is None:
            return None
        try:
            if ty in ("INT", "INTEGER"):
                return int(float(v))
            if ty in ("FLOAT", "DOUBLE", "DECIMAL", "NUMERIC"):
                return float(v)
            if ty in ("STRING", "VARCHAR", "CHAR"):
                return str(v)
            if ty in ("BOOL", "BOOLEAN"):
                if isinstance(v, str):
                    return v.lower() == "true"
                return bool(v)
        except (ValueError, TypeError) as e:
            raise SQLError(f"cannot CAST {v!r} to {ty}") from e
        raise SQLError(f"unknown CAST type {ty}")

    def _func(self, node: Func, row: dict):
        name = node.name
        args = [self.eval(a, row) for a in node.args]
        if name == "LOWER":
            return None if args[0] is None else str(args[0]).lower()
        if name == "UPPER":
            return None if args[0] is None else str(args[0]).upper()
        if name == "TRIM":
            return None if args[0] is None else str(args[0]).strip()
        if name in ("CHAR_LENGTH", "CHARACTER_LENGTH", "LENGTH"):
            return None if args[0] is None else len(str(args[0]))
        if name == "SUBSTRING":
            if args[0] is None:
                return None
            s = str(args[0])
            start = int(args[1]) if len(args) > 1 else 1
            start = max(start, 1)
            if len(args) > 2:
                return s[start - 1:start - 1 + int(args[2])]
            return s[start - 1:]
        if name == "COALESCE":
            for a in args:
                if a is not None:
                    return a
            return None
        if name == "NULLIF":
            return None if _compare("=", args[0], args[1]) else args[0]
        if name == "ABS":
            n = _num(args[0])
            return None if n is None else abs(n)
        if name == "UTCNOW":
            import datetime
            return datetime.datetime.now(
                datetime.timezone.utc).isoformat()
        raise SQLError(f"unknown function {name}")


# -- aggregation ------------------------------------------------------------

class _Agg:
    def __init__(self, kind: str):
        self.kind = kind
        self.count = 0
        self.total: Any = 0
        self.min: Any = None
        self.max: Any = None

    def add(self, v):
        if self.kind == "COUNT":
            if v is not None and v is not _MISSING:   # SQL: skip NULLs
                self.count += 1
            return
        if v is None or v is _MISSING:
            return
        n = _num(v)
        self.count += 1
        if n is not None:
            self.total += n
        if self.min is None or _compare("<", v, self.min):
            self.min = v
        if self.max is None or _compare(">", v, self.max):
            self.max = v

    def result(self):
        if self.kind == "COUNT":
            return self.count
        if self.count == 0:
            return None
        if self.kind == "SUM":
            return self.total
        if self.kind == "AVG":
            return self.total / self.count
        if self.kind == "MIN":
            return self.min
        if self.kind == "MAX":
            return self.max
        raise SQLError(f"unknown aggregate {self.kind}")


def execute(query: Query, rows: Iterable[dict]) -> Iterator[dict]:
    """Run the query over records; yields output rows (ordered dicts)."""
    ev = Evaluator(query)
    if query.aggregate:
        aggs: list[tuple[Projection, Func, _Agg]] = []
        for p in query.projections:
            if not isinstance(p.expr, Func) or p.expr.name not in AGGREGATES:
                raise SQLError("aggregate queries must project aggregates")
            aggs.append((p, p.expr, _Agg(p.expr.name)))
        for row in rows:
            if query.where is not None and \
                    ev.eval(query.where, row) is not True:
                continue
            for _, fn, st in aggs:
                if fn.star:
                    st.count += 1
                else:
                    st.add(ev.eval(fn.args[0], row))
        if query.limit == 0:
            return
        out = {}
        for idx, (p, fn, st) in enumerate(aggs):
            out[p.alias or f"_{idx + 1}"] = st.result()
        yield out
        return

    emitted = 0
    for row in rows:
        if query.limit is not None and emitted >= query.limit:
            return
        if query.where is not None and \
                ev.eval(query.where, row) is not True:
            continue
        if not query.projections:            # SELECT *
            yield row
        else:
            out = {}
            for idx, p in enumerate(query.projections):
                name = p.alias
                if not name and isinstance(p.expr, Column):
                    name = p.expr.path[-1]
                out[name or f"_{idx + 1}"] = ev.eval(p.expr, row)
            yield out
        emitted += 1
        if query.limit is not None and emitted >= query.limit:
            return
