"""SQL lexer. Token kinds: KEYWORD, IDENT, QIDENT ("quoted"), NUMBER,
STRING, OP, EOF. Keywords are case-insensitive; identifiers lowercase
unless quoted (Presto semantics)."""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, List

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "escape",
    "is", "null", "true", "false", "case", "when", "then", "else", "end",
    "cast", "join", "inner", "left", "right", "full", "outer", "cross",
    "on", "using", "union", "intersect", "except", "all", "distinct",
    "with", "values", "date",
    "time", "timestamp", "interval", "extract", "asc", "desc", "nulls",
    "first", "last", "offset", "fetch", "next", "rows", "row", "only",
    "explain", "analyze", "show", "tables", "schemas", "catalogs",
    "columns", "functions", "session", "set", "reset", "describe",
    "create", "table", "insert", "into", "drop", "if", "substring",
    "for", "year", "month", "day", "hour", "minute", "second", "quarter",
    "over", "partition", "range", "unbounded", "preceding", "following",
    "current", "exclude", "ties", "no", "others", "semi", "anti",
    "prepare", "execute", "deallocate", "input", "output",
}

MULTI_OPS = ["<>", "!=", ">=", "<=", "||", "->"]
SINGLE_OPS = "+-*/%(),.<>=;[]?"


@dataclasses.dataclass
class Token:
    kind: str   # keyword | ident | qident | number | string | op | eof
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


class LexError(Exception):
    pass


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated quoted identifier at {i}")
            out.append(Token("qident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            m = re.match(r"\d*\.?\d+([eE][+-]?\d+)?", sql[i:])
            out.append(Token("number", m.group(0), i))
            i += m.end()
            continue
        if c.isalpha() or c == "_":
            m = re.match(r"[A-Za-z_][A-Za-z0-9_$]*", sql[i:])
            word = m.group(0)
            low = word.lower()
            if low in KEYWORDS:
                out.append(Token("keyword", low, i))
            else:
                out.append(Token("ident", low, i))
            i += m.end()
            continue
        matched = False
        for op in MULTI_OPS:
            if sql.startswith(op, i):
                out.append(Token("op", op, i))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in SINGLE_OPS:
            out.append(Token("op", c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at {i}")
    out.append(Token("eof", "", n))
    return out
