"""JMESPath dialect for the policy engine.

A from-scratch JMESPath implementation (the pip package is not available in
the image) following the public JMESPath spec, extended with the 19 custom
functions registered by the reference dialect
(kyverno/pkg/engine/jmespath/functions.go:57-215): compare,
equal_fold, replace, replace_all, to_upper, to_lower, trim, split,
regex_replace_all, regex_replace_all_literal, regex_match, label_match,
add, subtract, multiply, divide, modulo, base64_decode, base64_encode.
"""

from .errors import JMESPathError, NotFoundError
from .parser import compile as compile_expr
from .interpreter import search

__all__ = ["search", "compile_expr", "JMESPathError", "NotFoundError"]
