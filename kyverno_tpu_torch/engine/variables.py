"""Variable `{{...}}` and relative-reference `$(...)` substitution.

Mirrors kyverno/pkg/engine/variables/vars.go: rewrites variables
anywhere in a rule (values AND map keys), resolving JMESPath expressions
against the JSON context, looping until no variables remain (variables may
resolve to strings containing more variables). Supports:

  - escaping:  \\{{...}} and \\$(...) pass through un-substituted
  - {{@}}    :  the value at the current position in request.object
  - DELETE requests rewrite request.object -> request.oldObject
  - $(../sibling) relative references with operator prefixes
  - preconditions resolver: unresolved variables become "" instead of errors

In the accelerated tier, rules whose variables depend only on
compile-time-known context evaluate once per (policy, request-class) at
compile time; request-object-dependent variables route the rule to the CPU
lane (SURVEY.md section 7 step 4).
"""

from __future__ import annotations

import json
import re

from .anchors import remove_anchors_from_path
from .context import Context, InvalidVariableError
from .jsonutils import traverse_leaves_and_keys
from .pattern import get_operator

REGEX_VARIABLES = re.compile(r"^\{\{[^{}]*\}\}|[^\\]\{\{[^{}]*\}\}")
REGEX_ESCP_VARIABLES = re.compile(r"\\\{\{[^{}]*\}\}")
REGEX_REFERENCES = re.compile(r"^\$\(.[^ ]*\)|[^\\]\$\(.[^ ]*\)")
REGEX_ESCP_REFERENCES = re.compile(r"\\\$\(.[^ ]*\)")
REGEX_VARIABLE_INIT = re.compile(r"^\{\{[^{}]*\}\}")
_REGEX_PATH_DIGIT = re.compile(r"\.?(\d)\.?")


class VariableResolutionError(Exception):
    def __init__(self, variable: str, path: str, reason: str = ""):
        self.variable = variable
        self.path = path
        super().__init__(
            f"failed to resolve {variable} at path {path}"
            + (f": {reason}" if reason else "")
        )


class NotResolvedReferenceError(VariableResolutionError):
    pass


def is_variable(value: str) -> bool:
    return bool(REGEX_VARIABLES.findall(value))


def is_reference(value: str) -> bool:
    return bool(REGEX_REFERENCES.findall(value))


def _find_all(regex: re.Pattern, s: str) -> list[str]:
    """re.findall with groups disabled — we need whole matches, and Go's
    FindAllString semantics (non-overlapping, leftmost)."""
    return [m.group(0) for m in regex.finditer(s)]


def default_resolver(ctx: Context, variable: str):
    return ctx.query(variable)


def preconditions_resolver(ctx: Context, variable: str):
    """vars.go:62: unresolved precondition variables become empty strings."""
    try:
        value = ctx.query(variable)
    except InvalidVariableError:
        return ""
    return value


def substitute_all(ctx: Context, document, resolver=default_resolver):
    """vars.go:78 SubstituteAll: references first, then variables."""
    document = substitute_references(document)
    return substitute_vars(ctx, document, resolver)


def substitute_all_in_preconditions(ctx: Context, document):
    return substitute_all(ctx, document, preconditions_resolver)


def substitute_all_force_mutate(ctx: Context | None, document):
    """vars.go:182 SubstituteAllForceMutate (CLI dry-runs): references, then
    either real substitution or placeholder replacement when no context."""
    document = substitute_references(document)
    if ctx is None:
        return _replace_with_placeholders(document)
    return substitute_vars(ctx, document, default_resolver)


def _replace_with_placeholders(document):
    raw = json.dumps(document)
    regex = re.compile(r"\{\{[^{}]*\}\}")
    while regex.search(raw):
        raw = regex.sub("placeholderValue", raw)
    return json.loads(raw)


def substitute_vars(ctx: Context, document, resolver=default_resolver):
    is_delete = _is_delete_request(ctx)

    def action(element, path, doc):
        if not isinstance(element, str):
            return element
        value = element
        variables = _find_all(REGEX_VARIABLES, value)
        while variables:
            original = value
            for var_match in variables:
                initial = bool(REGEX_VARIABLE_INIT.match(var_match))
                old = var_match
                v = var_match if initial else var_match[1:]
                variable = v.replace("{{", "").replace("}}", "").strip()

                if variable == "@":
                    jp = _get_jmespath(path)
                    if jp.startswith("["):
                        variable = f"request.object{jp}"
                    else:
                        variable = f"request.object.{jp}" if jp else "request.object"
                if is_delete:
                    variable = variable.replace("request.object", "request.oldObject")

                try:
                    substituted = resolver(ctx, variable)
                except InvalidVariableError as e:
                    raise VariableResolutionError(variable, path, str(e))

                if original == v:
                    # the whole string was one variable: keep the JSON type
                    return substituted

                prefix = "" if initial else old[0]
                value = _substitute_in_pattern(prefix, value, v, substituted)
            variables = _find_all(REGEX_VARIABLES, value)

        for esc in _find_all(REGEX_ESCP_VARIABLES, value):
            value = value.replace(esc, esc[1:])
        return value

    return traverse_leaves_and_keys(document, action)


def _substitute_in_pattern(prefix: str, pattern: str, variable: str, value) -> str:
    if isinstance(value, str):
        s = value
    else:
        s = json.dumps(value, separators=(",", ":"))
    return pattern.replace(prefix + variable, prefix + s, 1)


def _is_delete_request(ctx: Context | None) -> bool:
    if ctx is None:
        return False
    try:
        return ctx.query("request.operation") == "DELETE"
    except InvalidVariableError:
        return False


def _get_jmespath(raw_path: str) -> str:
    """vars.go:415 getJMESPath: strip the rule-prefix (first 3 segments,
    e.g. /validate/pattern) and convert to JMESPath with [n] indexes."""
    tokens = raw_path.split("/")[3:]
    path = ".".join(tokens)
    path = _REGEX_PATH_DIGIT.sub(r"[\1].", path)
    return path.strip(".")


# -------------------------------------------------------------- references


def substitute_references(document):
    """$(...) sibling references resolved against the document itself."""

    def action(element, path, doc):
        if not isinstance(element, str):
            return element
        value = element
        for ref_match in _find_all(REGEX_REFERENCES, value):
            initial = ref_match.startswith("$(")
            old = ref_match
            v = ref_match if initial else ref_match[1:]

            resolved = _resolve_reference(doc, v, path)
            if resolved is None:
                raise NotResolvedReferenceError(v, path)
            if isinstance(resolved, str):
                replacement = ("" if initial else old[0]) + resolved
                value = value.replace(old, replacement, 1)
                continue
            raise NotResolvedReferenceError(v, path)

        for esc in _find_all(REGEX_ESCP_REFERENCES, value):
            value = value.replace(esc, esc[1:])
        return value

    return traverse_leaves_and_keys(document, action)


def _resolve_reference(full_document, reference: str, absolute_path: str):
    """vars.go:450 resolveReference: relative path -> absolute, fetch value,
    re-apply any operator prefix."""
    path = reference.strip("$()")
    operation = get_operator(path)
    path = path[len(operation.value):]
    if not path:
        raise VariableResolutionError(reference, absolute_path, "empty reference")

    path = _form_absolute_path(path, absolute_path)
    value = _get_value_from_reference(full_document, path)
    if operation.value == "":
        return value
    if isinstance(value, str):
        return operation.value + value
    if isinstance(value, bool):
        raise VariableResolutionError(reference, absolute_path, "non-scalar reference")
    if isinstance(value, int):
        return operation.value + str(value)
    if isinstance(value, float):
        return operation.value + f"{value:f}"
    raise VariableResolutionError(reference, absolute_path, "non-scalar reference")


def _form_absolute_path(reference_path: str, absolute_path: str) -> str:
    if reference_path.startswith("/"):
        return _normalize(reference_path)
    return _normalize(f"{absolute_path}/{reference_path}")


def _normalize(path: str) -> str:
    parts: list[str] = []
    for seg in path.split("/"):
        if seg in ("", "."):
            continue
        if seg == "..":
            if parts:
                parts.pop()
        else:
            parts.append(seg)
    return "/" + "/".join(parts)


def _get_value_from_reference(document, path: str):
    found = []

    def action(element, elem_path, doc):
        if remove_anchors_from_path(elem_path) == path and not found:
            found.append(element)
        return element

    traverse_leaves_and_keys(document, action)
    return found[0] if found else None


def replace_all_vars(src: str, repl) -> str:
    """vars.go:46 ReplaceAllVars — rewrite each {{var}} via ``repl``."""

    def wrapper(m: re.Match) -> str:
        s = m.group(0)
        prefix = ""
        if not REGEX_VARIABLE_INIT.match(s):
            prefix, s = s[0], s[1:]
        return prefix + repl(s)

    return REGEX_VARIABLES.sub(wrapper, src)
