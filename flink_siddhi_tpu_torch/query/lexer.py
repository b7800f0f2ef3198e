"""Tokenizer for the SiddhiQL-compatible language."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Optional


class SiddhiQLError(Exception):
    """Parse/compile error for a query plan (the analog of the reference's
    fail-fast plan validation, AbstractSiddhiOperator.java:291-299)."""

    def __init__(self, message: str, line: int = 0, col: int = 0):
        loc = f" at line {line}:{col}" if line else ""
        super().__init__(f"{message}{loc}")
        self.line = line
        self.col = col


@dataclass(frozen=True)
class Token:
    kind: str  # ID, INT, FLOAT, STRING, OP, EOF
    text: str
    line: int
    col: int

    def __repr__(self) -> str:
        return f"{self.kind}({self.text!r})"


_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+)
  | (?P<COMMENT>--[^\n]*|/\*.*?\*/)
  | (?P<ANNOT>@[A-Za-z_][A-Za-z0-9_]*)
  | (?P<FLOAT>\d+\.\d+([eE][+-]?\d+)?[fFdD]?|\d+[eE][+-]?\d+[fFdD]?|\d+[fFdD])
  | (?P<INT>\d+[lL]?)
  | (?P<STRING>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<ID>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<OP>==|!=|<=|>=|->|[-+*/%<>=\[\](){},;:#.?!])
    """,
    re.VERBOSE | re.DOTALL,
)


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    line = 1
    line_start = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SiddhiQLError(
                f"unexpected character {text[pos]!r}",
                line,
                pos - line_start + 1,
            )
        kind = m.lastgroup
        tok_text = m.group()
        if kind not in ("WS", "COMMENT"):
            tokens.append(
                Token(kind, tok_text, line, m.start() - line_start + 1)
            )
        nl = tok_text.count("\n")
        if nl:
            line += nl
            line_start = m.start() + tok_text.rfind("\n") + 1
        pos = m.end()
    tokens.append(Token("EOF", "", line, pos - line_start + 1))
    return tokens


class TokenStream:
    def __init__(self, tokens: List[Token]):
        self._tokens = tokens
        self._i = 0

    @property
    def current(self) -> Token:
        return self._tokens[self._i]

    def peek(self, offset: int = 1) -> Token:
        j = min(self._i + offset, len(self._tokens) - 1)
        return self._tokens[j]

    def advance(self) -> Token:
        tok = self._tokens[self._i]
        if tok.kind != "EOF":
            self._i += 1
        return tok

    def at_op(self, *ops: str) -> bool:
        return self.current.kind == "OP" and self.current.text in ops

    def at_keyword(self, *words: str) -> bool:
        return (
            self.current.kind == "ID"
            and self.current.text.lower() in words
        )

    def accept_op(self, *ops: str) -> Optional[Token]:
        if self.at_op(*ops):
            return self.advance()
        return None

    def accept_keyword(self, *words: str) -> Optional[Token]:
        if self.at_keyword(*words):
            return self.advance()
        return None

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            self.error(f"expected {op!r}, found {self.current.text!r}")
        return self.advance()

    def expect_keyword(self, word: str) -> Token:
        if not self.at_keyword(word):
            self.error(f"expected {word!r}, found {self.current.text!r}")
        return self.advance()

    def expect_id(self) -> Token:
        if self.current.kind != "ID":
            self.error(f"expected identifier, found {self.current.text!r}")
        return self.advance()

    def error(self, message: str) -> None:
        tok = self.current
        raise SiddhiQLError(message, tok.line, tok.col)
