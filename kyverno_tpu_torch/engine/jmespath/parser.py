"""JMESPath Pratt parser producing tuple-AST nodes.

Node shapes (tag, *payload):
  ("field", name) ("index", i) ("slice", a, b, c) ("identity",)
  ("literal", v) ("subexpression", l, r) ("index_expression", l, r)
  ("projection", l, r) ("value_projection", l, r)
  ("flatten_projection", l, r) ("filter_projection", l, r, cond)
  ("comparator", op, l, r) ("or", l, r) ("and", l, r) ("not", e)
  ("pipe", l, r) ("multiselect_list", [e...]) ("multiselect_dict", [(k,e)...])
  ("function", name, [args]) ("expref", e) ("current",)
"""

from __future__ import annotations

from .errors import ParseError
from .lexer import Token, tokenize

BINDING_POWER = {
    "eof": 0,
    "unquoted_identifier": 0,
    "quoted_identifier": 0,
    "literal": 0,
    "rbracket": 0,
    "rparen": 0,
    "comma": 0,
    "rbrace": 0,
    "number": 0,
    "current": 0,
    "expref": 0,
    "colon": 0,
    "pipe": 1,
    "or": 2,
    "and": 3,
    "eq": 5,
    "gt": 5,
    "lt": 5,
    "gte": 5,
    "lte": 5,
    "ne": 5,
    "flatten": 9,
    "star": 20,
    "filter": 21,
    "dot": 40,
    "not": 45,
    "lbrace": 50,
    "lbracket": 55,
    "lparen": 60,
}

COMPARATORS = {"eq": "==", "ne": "!=", "lt": "<", "gt": ">", "lte": "<=", "gte": ">="}

_PROJECTION_STOP = 10


class Parser:
    def __init__(self, expression: str):
        self.expression = expression
        self.tokens = tokenize(expression)
        self.pos = 0

    # ------------------------------------------------------------- helpers

    @property
    def current(self) -> Token:
        return self.tokens[self.pos]

    def advance(self) -> Token:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def expect(self, ttype: str) -> Token:
        t = self.current
        if t.type != ttype:
            raise ParseError(
                f"expected {ttype} but got {t.type} at {t.start} in {self.expression!r}"
            )
        return self.advance()

    # --------------------------------------------------------------- pratt

    def parse(self):
        result = self.expression_rule(0)
        if self.current.type != "eof":
            t = self.current
            raise ParseError(f"unexpected token {t.type} at {t.start} in {self.expression!r}")
        return result

    def expression_rule(self, rbp: int):
        left = self.nud(self.advance())
        while rbp < BINDING_POWER[self.current.type]:
            left = self.led(self.advance(), left)
        return left

    # ---------------------------------------------------------------- nud

    def nud(self, token: Token):
        tt = token.type
        if tt == "unquoted_identifier":
            if self.current.type == "lparen":
                return self._parse_function(token.value)
            return ("field", token.value)
        if tt == "quoted_identifier":
            if self.current.type == "lparen":
                raise ParseError("quoted identifiers cannot be function names")
            return ("field", token.value)
        if tt == "literal":
            return ("literal", token.value)
        if tt == "star":
            return self._parse_value_projection(("identity",))
        if tt == "current":
            return ("current",)
        if tt == "expref":
            return ("expref", self.expression_rule(BINDING_POWER["expref"]))
        if tt == "not":
            return ("not", self.expression_rule(BINDING_POWER["not"]))
        if tt == "lparen":
            inner = self.expression_rule(0)
            self.expect("rparen")
            return inner
        if tt == "flatten":
            return self._parse_projection_rhs(("flatten_projection", ("identity",), None), BINDING_POWER["flatten"])
        if tt == "lbracket":
            return self._parse_bracket_nud()
        if tt == "filter":
            return self._parse_filter(("identity",))
        if tt == "lbrace":
            return self._parse_multiselect_dict()
        raise ParseError(f"unexpected token {tt} ({token.value!r}) at {token.start}")

    def _parse_bracket_nud(self):
        # "[" already consumed: [*] / [i] / [a:b] / [e1,e2]
        if self.current.type == "star" and self.tokens[self.pos + 1].type == "rbracket":
            self.advance()
            self.advance()
            return self._parse_projection_rhs(("projection", ("identity",), None), BINDING_POWER["star"])
        if self.current.type in ("number", "colon"):
            node = self._parse_index_or_slice()
            if node[0] == "slice":
                return self._parse_projection_rhs(
                    ("projection", ("index_expression", ("identity",), node), None),
                    BINDING_POWER["star"],
                )
            return ("index_expression", ("identity",), node)
        return self._parse_multiselect_list()

    # ---------------------------------------------------------------- led

    def led(self, token: Token, left):
        tt = token.type
        if tt == "dot":
            if self.current.type == "star":
                self.advance()
                return self._parse_value_projection(left)
            right = self._parse_dot_rhs(BINDING_POWER["dot"])
            return ("subexpression", left, right)
        if tt == "pipe":
            return ("pipe", left, self.expression_rule(BINDING_POWER["pipe"]))
        if tt == "or":
            return ("or", left, self.expression_rule(BINDING_POWER["or"]))
        if tt == "and":
            return ("and", left, self.expression_rule(BINDING_POWER["and"]))
        if tt in COMPARATORS:
            return ("comparator", COMPARATORS[tt], left, self.expression_rule(BINDING_POWER[tt]))
        if tt == "flatten":
            return self._parse_projection_rhs(("flatten_projection", left, None), BINDING_POWER["flatten"])
        if tt == "filter":
            return self._parse_filter(left)
        if tt == "lbracket":
            if self.current.type in ("number", "colon"):
                node = self._parse_index_or_slice()
                if node[0] == "slice":
                    return self._parse_projection_rhs(
                        ("projection", ("index_expression", left, node), None),
                        BINDING_POWER["star"],
                    )
                return ("index_expression", left, node)
            if self.current.type == "star" and self.tokens[self.pos + 1].type == "rbracket":
                self.advance()
                self.advance()
                return self._parse_projection_rhs(("projection", left, None), BINDING_POWER["star"])
            raise ParseError(f"unexpected token in brackets at {token.start}")
        raise ParseError(f"unexpected led token {tt} at {token.start}")

    # ------------------------------------------------------------ snippets

    def _parse_index_or_slice(self):
        parts = [None, None, None]
        idx = 0
        saw_colon = False
        if self.current.type == "number":
            parts[0] = self.advance().value
        while self.current.type == "colon":
            saw_colon = True
            idx += 1
            if idx > 2:
                raise ParseError("too many colons in slice")
            self.advance()
            if self.current.type == "number":
                parts[idx] = self.advance().value
        self.expect("rbracket")
        if not saw_colon:
            return ("index", parts[0])
        return ("slice", parts[0], parts[1], parts[2])

    def _parse_projection_rhs(self, projection, rbp: int):
        """RHS binds at the projection's own power so that chained dots and
        brackets fold INTO the projection, stopping only at pipe/or/and/
        comparators."""
        tag = projection[0]
        left = projection[1]
        cond = projection[3] if tag == "filter_projection" else None
        if BINDING_POWER[self.current.type] < _PROJECTION_STOP:
            right = ("identity",)
        elif self.current.type == "dot":
            self.advance()
            right = self._parse_dot_rhs(rbp)
        elif self.current.type in ("lbracket", "filter", "flatten"):
            right = self.expression_rule(rbp)
        else:
            t = self.current
            raise ParseError(f"unexpected token {t.type} after projection at {t.start}")
        if tag == "filter_projection":
            return (tag, left, right, cond)
        return (tag, left, right)

    def _parse_value_projection(self, left):
        rbp = BINDING_POWER["star"]
        if BINDING_POWER[self.current.type] < _PROJECTION_STOP:
            right = ("identity",)
        elif self.current.type == "dot":
            self.advance()
            right = self._parse_dot_rhs(rbp)
        elif self.current.type in ("lbracket", "filter", "flatten"):
            right = self.expression_rule(rbp)
        else:
            t = self.current
            raise ParseError(f"unexpected token {t.type} after '*' at {t.start}")
        return ("value_projection", left, right)

    def _parse_dot_rhs(self, rbp: int):
        tt = self.current.type
        if tt in ("unquoted_identifier", "quoted_identifier", "star"):
            return self.expression_rule(rbp)
        if tt == "lbracket":
            self.advance()
            return self._parse_multiselect_list()
        if tt == "lbrace":
            self.advance()
            return self._parse_multiselect_dict()
        raise ParseError(f"unexpected token {tt} after '.' at {self.current.start}")

    def _parse_multiselect_list(self):
        nodes = []
        while True:
            nodes.append(self.expression_rule(0))
            if self.current.type == "rbracket":
                break
            self.expect("comma")
        self.expect("rbracket")
        return ("multiselect_list", nodes)

    def _parse_multiselect_dict(self):
        pairs = []
        while True:
            key_token = self.current
            if key_token.type not in ("unquoted_identifier", "quoted_identifier"):
                raise ParseError(f"expected identifier key at {key_token.start}")
            self.advance()
            self.expect("colon")
            pairs.append((key_token.value, self.expression_rule(0)))
            if self.current.type == "rbrace":
                break
            self.expect("comma")
        self.expect("rbrace")
        return ("multiselect_dict", pairs)

    def _parse_filter(self, left):
        cond = self.expression_rule(0)
        self.expect("rbracket")
        return self._parse_projection_rhs(("filter_projection", left, None, cond), BINDING_POWER["filter"])

    def _parse_function(self, name: str):
        self.expect("lparen")
        args = []
        if self.current.type != "rparen":
            while True:
                args.append(self.expression_rule(0))
                if self.current.type == "rparen":
                    break
                self.expect("comma")
        self.expect("rparen")
        return ("function", name, args)


_cache: dict[str, tuple] = {}


def compile(expression: str):
    """Parse with memoization (expressions repeat heavily across policies)."""
    ast = _cache.get(expression)
    if ast is None:
        ast = Parser(expression).parse()
        if len(_cache) > 4096:
            _cache.clear()
        _cache[expression] = ast
    return ast
