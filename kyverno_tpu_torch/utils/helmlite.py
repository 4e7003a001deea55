"""Offline renderer for the deploy chart's Helm-template subset.

``deploy/chart/kyverno-tpu`` is a standard Helm chart (``helm template``
renders it unchanged); this module renders the same output without the
helm binary, so air-gapped environments — and this repo's CI — can
produce install manifests from chart values. Supported constructs are
the subset the chart uses: ``{{ .Values.* }}`` / ``.Chart`` /
``.Release`` lookups, ``include`` of ``define`` blocks from
``_helpers.tpl``, ``if``/``else``/``end`` with Helm truthiness, and the
``default``/``quote``/``toYaml``/``indent``/``nindent`` pipeline
functions, with ``{{-``/``-}}`` whitespace control.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

_ACTION = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)


# ------------------------------------------------------------------ parse


def _tokenize(src: str):
    """-> [("text", s) | ("action", expr)] with whitespace control
    applied (a ``-`` eats adjacent whitespace including the newline)."""
    out = []
    pos = 0
    for m in _ACTION.finditer(src):
        text = src[pos:m.start()]
        if m.group(1) == "-":
            text = text.rstrip()
        out.append(("text", text))
        out.append(("action", m.group(2), m.group(3) == "-"))
        pos = m.end()
    out.append(("text", src[pos:]))
    # right-trim marker eats following whitespace up to and incl. newline
    merged = []
    strip_next = False
    for tok in out:
        if tok[0] == "text":
            text = tok[1]
            if strip_next:
                text = re.sub(r"^[ \t]*\n?", "", text, count=1)
                strip_next = False
            merged.append(("text", text))
        else:
            merged.append(("action", tok[1]))
            strip_next = tok[2]
    return merged


def _parse(tokens, i=0, until=()):
    """Token list -> node tree. Nodes: ("text", s), ("expr", s),
    ("if", cond, then_nodes, else_nodes), ("define", name, nodes)."""
    nodes = []
    while i < len(tokens):
        tok = tokens[i]
        if tok[0] == "text":
            nodes.append(tok)
            i += 1
            continue
        expr = tok[1]
        if expr.startswith("/*"):
            # Go-template comment: valid Helm, renders as nothing
            i += 1
            continue
        word = expr.split(None, 1)[0] if expr else ""
        if word in until:
            return nodes, i
        i += 1
        if word in ("range", "with", "block", "template") or \
                word.startswith("$"):
            # constructs outside the supported subset must fail LOUDLY:
            # rendering `range` as literal text would produce a manifest
            # that LOOKS valid while helm template disagrees (the drift
            # the golden-render test exists to catch)
            raise ValueError(f"unsupported template construct: {expr!r}")
        if word == "if":
            then, i = _parse(tokens, i, until=("else", "end"))
            els = []
            if tokens[i][1].split(None, 1)[0] == "else":
                if tokens[i][1].strip() != "else":
                    # `else if` would silently render as a plain else —
                    # fail loudly like every other unsupported construct
                    raise ValueError(
                        f"unsupported template construct: {tokens[i][1]!r}")
                els, i = _parse(tokens, i + 1, until=("end",))
            i += 1  # consume end
            nodes.append(("if", expr.split(None, 1)[1], then, els))
        elif word == "define":
            name = expr.split(None, 1)[1].strip().strip('"')
            body, i = _parse(tokens, i, until=("end",))
            i += 1
            nodes.append(("define", name, body))
        else:
            nodes.append(("expr", expr))
    return nodes, i


# ------------------------------------------------------------------- eval


def _truthy(v) -> bool:
    return not (v is None or v is False or v == "" or v == {} or v == []
                or v == 0)


def _lookup(path: str, ctx: dict):
    cur = ctx
    for seg in path.lstrip(".").split("."):
        if not seg:
            continue
        if not isinstance(cur, dict) or seg not in cur:
            return None
        cur = cur[seg]
    return cur


def _split_args(s: str) -> list[str]:
    """Split on spaces outside double quotes and parentheses, keeping a
    ``(...)`` group (a sub-pipeline) as one token."""
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
        elif c == '"':
            j = s.index('"', i + 1)
            out.append(s[i:j + 1])
            i = j + 1
        elif c == "(":
            depth = 1
            j = i + 1
            while j < n and depth:
                if s[j] == "(":
                    depth += 1
                elif s[j] == ")":
                    depth -= 1
                j += 1
            out.append(s[i:j])
            i = j
        else:
            j = i
            while j < n and not s[j].isspace() and s[j] not in '"(':
                j += 1
            out.append(s[i:j])
            i = j
    return out


def _split_pipeline(s: str) -> list[str]:
    """Split on | outside quotes/parens."""
    out = []
    depth = 0
    in_str = False
    start = 0
    for i, c in enumerate(s):
        if c == '"':
            in_str = not in_str
        elif not in_str and c == "(":
            depth += 1
        elif not in_str and c == ")":
            depth -= 1
        elif not in_str and c == "|" and depth == 0:
            out.append(s[start:i].strip())
            start = i + 1
    out.append(s[start:].strip())
    return out


class Renderer:
    def __init__(self, defines: dict, ctx: dict):
        self.defines = defines
        self.ctx = ctx

    def render(self, nodes) -> str:
        out = []
        for node in nodes:
            if node[0] == "text":
                out.append(node[1])
            elif node[0] == "expr":
                val = self.eval_pipeline(node[1])
                out.append("" if val is None else str(val))
            elif node[0] == "if":
                branch = node[2] if _truthy(
                    self.eval_pipeline(node[1])) else node[3]
                out.append(self.render(branch))
            elif node[0] == "define":
                pass  # collected separately
        return "".join(out)

    def eval_pipeline(self, expr: str):
        stages = _split_pipeline(expr)
        val = self._eval_primary(stages[0])
        for stage in stages[1:]:
            val = self._apply(stage, val)
        return val

    def _eval_primary(self, expr: str):
        args = _split_args(expr)
        if not args:
            return None
        head = args[0]
        if head.startswith("("):
            return self.eval_pipeline(head[1:-1])
        if head == "include":
            name = args[1].strip('"')
            if name not in self.defines:
                raise KeyError(f"no template named {name}")
            return self.render(self.defines[name]).strip("\n")
        if head.startswith('"'):
            return head.strip('"')
        if head.startswith("."):
            return _lookup(head, self.ctx)
        if head == "true":
            return True
        if head == "false":
            return False
        if head == "nil":
            return None
        try:
            return int(head)
        except ValueError:
            pass
        # bare words are not values in Go templates — an unknown function
        # or sprig call here must fail loudly, never render as its own name
        raise ValueError(f"unsupported template expression: {expr!r}")

    def _apply(self, stage: str, val):
        args = _split_args(stage)
        fn, rest = args[0], args[1:]
        if fn == "default":
            fallback = self._eval_primary(" ".join(rest))
            return val if _truthy(val) else fallback
        if fn == "quote":
            return json.dumps("" if val is None else str(val))
        if fn == "toYaml":
            import yaml

            return yaml.safe_dump(val, default_flow_style=False).rstrip("\n")
        if fn in ("indent", "nindent"):
            n = int(rest[0])
            pad = " " * n
            body = "\n".join(pad + line if line else line
                             for line in str(val).splitlines())
            return ("\n" + body) if fn == "nindent" else body
        if fn == "toString":
            return "" if val is None else str(val)
        raise ValueError(f"unsupported template function: {fn}")


# ------------------------------------------------------------------ chart


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _apply_set(values: dict, assignment: str) -> None:
    """--set a.b.c=value (YAML-parsed scalar)."""
    import yaml

    path, _, raw = assignment.partition("=")
    cur = values
    keys = path.split(".")
    for key in keys[:-1]:
        cur = cur.setdefault(key, {})
    cur[keys[-1]] = yaml.safe_load(raw) if raw != "" else ""


def render_chart(chart_dir: str | Path, values_override: dict | None = None,
                 set_args: list[str] | None = None,
                 release_name: str = "kyverno-tpu",
                 release_namespace: str = "") -> list[dict]:
    """Render every template -> list of parsed manifest documents,
    the ``helm template`` equivalent."""
    import yaml

    chart_dir = Path(chart_dir)
    chart = yaml.safe_load((chart_dir / "Chart.yaml").read_text())
    values = yaml.safe_load((chart_dir / "values.yaml").read_text()) or {}
    values = _deep_merge(values, values_override or {})
    for assignment in set_args or []:
        _apply_set(values, assignment)

    ctx = {
        "Values": values,
        "Chart": {"Name": chart.get("name", ""),
                  "Version": str(chart.get("version", "")),
                  "AppVersion": str(chart.get("appVersion", ""))},
        "Release": {"Name": release_name,
                    "Namespace": release_namespace
                    or values.get("namespace") or "default",
                    "Service": "Helm"},
    }

    defines: dict = {}
    templates = sorted((chart_dir / "templates").glob("*"))
    parsed = []
    for path in templates:
        nodes, _ = _parse(_tokenize(path.read_text()))
        for node in nodes:
            if node[0] == "define":
                defines[node[1]] = node[2]
        if path.suffix in (".yaml", ".yml"):
            parsed.append(nodes)

    renderer = Renderer(defines, ctx)
    docs: list[dict] = []
    for nodes in parsed:
        text = renderer.render(nodes)
        for doc in yaml.safe_load_all(text):
            if doc:
                docs.append(doc)
    return docs
