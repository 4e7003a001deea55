"""JMESPath tokenizer (spec-conformant)."""

from __future__ import annotations

import json
import string
from dataclasses import dataclass

from .errors import LexerError

IDENT_START = set(string.ascii_letters + "_")
IDENT_CHARS = set(string.ascii_letters + string.digits + "_")
NUMBER_CHARS = set(string.digits)

SIMPLE_TOKENS = {
    ".": "dot",
    "*": "star",
    "]": "rbracket",
    ",": "comma",
    ":": "colon",
    "@": "current",
    "(": "lparen",
    ")": "rparen",
    "{": "lbrace",
    "}": "rbrace",
}


@dataclass
class Token:
    type: str
    value: object
    start: int


def tokenize(expression: str) -> list[Token]:
    tokens: list[Token] = []
    pos = 0
    n = len(expression)
    while pos < n:
        ch = expression[pos]
        if ch in SIMPLE_TOKENS:
            tokens.append(Token(SIMPLE_TOKENS[ch], ch, pos))
            pos += 1
        elif ch in " \t\n\r":
            pos += 1
        elif ch in IDENT_START:
            start = pos
            while pos < n and expression[pos] in IDENT_CHARS:
                pos += 1
            tokens.append(Token("unquoted_identifier", expression[start:pos], start))
        elif ch == "[":
            if pos + 1 < n and expression[pos + 1] == "]":
                tokens.append(Token("flatten", "[]", pos))
                pos += 2
            elif pos + 1 < n and expression[pos + 1] == "?":
                tokens.append(Token("filter", "[?", pos))
                pos += 2
            else:
                tokens.append(Token("lbracket", "[", pos))
                pos += 1
        elif ch == "'":
            start = pos
            pos += 1
            chunks = []
            while pos < n and expression[pos] != "'":
                if expression[pos] == "\\" and pos + 1 < n and expression[pos + 1] in "\\'":
                    chunks.append(expression[pos + 1])
                    pos += 2
                else:
                    chunks.append(expression[pos])
                    pos += 1
            if pos >= n:
                raise LexerError(f"unterminated raw string at {start}")
            pos += 1
            tokens.append(Token("literal", "".join(chunks), start))
        elif ch == '"':
            start = pos
            pos += 1
            while pos < n and expression[pos] != '"':
                if expression[pos] == "\\":
                    pos += 2
                else:
                    pos += 1
            if pos >= n:
                raise LexerError(f"unterminated quoted identifier at {start}")
            pos += 1
            raw = expression[start:pos]
            try:
                value = json.loads(raw)
            except ValueError as e:
                raise LexerError(f"invalid quoted identifier {raw!r}: {e}")
            tokens.append(Token("quoted_identifier", value, start))
        elif ch == "`":
            start = pos
            pos += 1
            chunks = []
            while pos < n and expression[pos] != "`":
                if expression[pos] == "\\" and pos + 1 < n and expression[pos + 1] == "`":
                    chunks.append("`")
                    pos += 2
                else:
                    chunks.append(expression[pos])
                    pos += 1
            if pos >= n:
                raise LexerError(f"unterminated literal at {start}")
            pos += 1
            raw = "".join(chunks)
            try:
                value = json.loads(raw)
            except ValueError:
                # the spec allows bare strings inside backticks
                value = raw.strip()
            tokens.append(Token("literal", value, start))
        elif ch == "-" or ch in NUMBER_CHARS:
            start = pos
            pos += 1
            while pos < n and expression[pos] in NUMBER_CHARS:
                pos += 1
            text = expression[start:pos]
            if text == "-":
                raise LexerError(f"unexpected '-' at position {start}")
            tokens.append(Token("number", int(text), start))
        elif ch == "|":
            if pos + 1 < n and expression[pos + 1] == "|":
                tokens.append(Token("or", "||", pos))
                pos += 2
            else:
                tokens.append(Token("pipe", "|", pos))
                pos += 1
        elif ch == "&":
            if pos + 1 < n and expression[pos + 1] == "&":
                tokens.append(Token("and", "&&", pos))
                pos += 2
            else:
                tokens.append(Token("expref", "&", pos))
                pos += 1
        elif ch == "=":
            if pos + 1 < n and expression[pos + 1] == "=":
                tokens.append(Token("eq", "==", pos))
                pos += 2
            else:
                raise LexerError(f"unexpected '=' at {pos}")
        elif ch == "!":
            if pos + 1 < n and expression[pos + 1] == "=":
                tokens.append(Token("ne", "!=", pos))
                pos += 2
            else:
                tokens.append(Token("not", "!", pos))
                pos += 1
        elif ch == "<":
            if pos + 1 < n and expression[pos + 1] == "=":
                tokens.append(Token("lte", "<=", pos))
                pos += 2
            else:
                tokens.append(Token("lt", "<", pos))
                pos += 1
        elif ch == ">":
            if pos + 1 < n and expression[pos + 1] == "=":
                tokens.append(Token("gte", ">=", pos))
                pos += 2
            else:
                tokens.append(Token("gt", ">", pos))
                pos += 1
        else:
            raise LexerError(f"unknown character {ch!r} at position {pos}")
    tokens.append(Token("eof", "", n))
    return tokens
