"""SQL lexer.

The reference uses a packrat PEG tokenizer (duckdb/src/parser/peg/).
Ours is a straightforward hand-rolled scanner feeding a recursive-descent /
Pratt parser — simpler, fast enough (parse time is host-side noise next to
device execution), and easy to extend statement by statement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


class TokType:
    IDENT = "IDENT"
    NUMBER = "NUMBER"
    STRING = "STRING"
    OP = "OP"
    EOF = "EOF"


@dataclass
class Token:
    type: str
    value: str
    pos: int

    def __repr__(self):
        return f"{self.type}:{self.value}"


_FOUR_CHAR_OPS = {"!~~*"}
_THREE_CHAR_OPS = {"!~~", "~~*", "~~~", "<->", "<=>", "->>"}
_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "::", "||", "//", "->", "**",
                 "~~", "!~", "^@", "<@", "@>", "&&", "<<", ">>", ":=",
                 "=>"}
_ONE_CHAR_OPS = set("+-*/%(),.;=<>[]{}:?")


class LexError(ValueError):
    pass


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":  # string literal, '' escapes
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated string at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            out.append(Token(TokType.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == '"':  # quoted identifier
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated identifier at {i}")
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        buf.append('"')
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            out.append(Token(TokType.IDENT, "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_e = False
            while j < n:
                d = sql[j]
                if d.isdigit():
                    j += 1
                elif d == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif d in "eE" and not seen_e and j + 1 < n and (
                    sql[j + 1].isdigit() or sql[j + 1] in "+-"
                ):
                    seen_e = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            out.append(Token(TokType.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_" or sql[j] == "$"):
                j += 1
            out.append(Token(TokType.IDENT, sql[i:j], i))
            i = j
            continue
        four = sql[i : i + 4]
        if four in _FOUR_CHAR_OPS:
            out.append(Token(TokType.OP, four, i))
            i += 4
            continue
        three = sql[i : i + 3]
        if three in _THREE_CHAR_OPS:
            out.append(Token(TokType.OP, three, i))
            i += 3
            continue
        if c == "$" and i + 1 < n and sql[i + 1].isdigit():
            # $n prepared-statement parameter (one token; the parser turns
            # it into N.Parameter)
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            out.append(Token(TokType.OP, sql[i:j], i))
            i = j
            continue
        two = sql[i : i + 2]
        if two in _TWO_CHAR_OPS:
            out.append(Token(TokType.OP, two, i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS or c in "!~&|^#@":
            out.append(Token(TokType.OP, c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at position {i}")
    out.append(Token(TokType.EOF, "", n))
    return out
