"""The expression language for predicates, computed fields, and routing.

The port's own copy of ``langstream_tpu/agents/el.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's JSTL EL layer
(``langstream-agents/langstream-agents-commons/src/main/java/ai/langstream/ai/agents/commons/jstl/JstlEvaluator.java:29``,
``JstlFunctions.java:44``, ``JstlPredicate``): agents evaluate expressions
like ``value.question`` or ``fn:lowercase(value.name)`` against a record
context exposing ``key``, ``value``, ``properties`` (headers), ``origin``,
``timestamp``.

TPU-rebuild deviation (documented API difference): expressions use **Python
expression syntax**, safely sandboxed via an AST whitelist — no imports, no
calls except into the ``fn`` namespace and whitelisted methods, no
attribute access to dunder names. JSTL's ``fn:name(...)`` spelling is
accepted and rewritten to ``fn.name(...)`` for compatibility with ported
pipelines.
"""

from __future__ import annotations

import ast
import datetime
import json
import re
import time
import uuid
from typing import Any, Dict, List, Optional


class ExpressionError(ValueError):
    pass


class _AttrDict(dict):
    """Dict with attribute-style access so ``value.question`` works.

    Data wins over dict methods: ``value.items`` returns the ``items``
    *field* when present (common JSON name), not the bound method.
    Missing fields read as None.
    """

    def __getattribute__(self, name: str) -> Any:
        if not name.startswith("__") and dict.__contains__(self, name):
            return _wrap(dict.__getitem__(self, name))
        return object.__getattribute__(self, name)

    def __getattr__(self, name: str) -> Any:
        return None


def _wrap(value: Any) -> Any:
    if isinstance(value, _AttrDict):
        return value
    if isinstance(value, dict):
        return _AttrDict(value)
    return value


class Functions:
    """The ``fn`` namespace (``JstlFunctions.java:44``)."""

    @staticmethod
    def uppercase(value: Any) -> Optional[str]:
        return None if value is None else str(value).upper()

    @staticmethod
    def lowercase(value: Any) -> Optional[str]:
        return None if value is None else str(value).lower()

    @staticmethod
    def trim(value: Any) -> Optional[str]:
        return None if value is None else str(value).strip()

    @staticmethod
    def concat(*parts: Any) -> str:
        return "".join("" if p is None else str(p) for p in parts)

    @staticmethod
    def concat3(a: Any, b: Any, c: Any) -> str:
        return Functions.concat(a, b, c)

    @staticmethod
    def contains(haystack: Any, needle: Any) -> bool:
        if haystack is None or needle is None:
            return False
        return str(needle) in str(haystack)

    @staticmethod
    def coalesce(value: Any, fallback: Any) -> Any:
        return fallback if value is None else value

    @staticmethod
    def split(value: Any, separator: str) -> List[str]:
        if value is None:
            return []
        return str(value).split(separator)

    @staticmethod
    def replace(value: Any, pattern: str, replacement: str) -> Optional[str]:
        return None if value is None else re.sub(pattern, replacement, str(value))

    @staticmethod
    def str(value: Any) -> Optional[str]:  # noqa: A003 — JSTL name
        # class attributes are not in method scope, so `str` here is builtin
        return None if value is None else str(value)

    @staticmethod
    def toDouble(value: Any) -> Optional[float]:
        return None if value is None else float(value)

    @staticmethod
    def toInt(value: Any) -> Optional[int]:
        return None if value is None else int(float(value))

    @staticmethod
    def toJson(value: Any) -> str:
        return json.dumps(value, ensure_ascii=False, default=str)

    @staticmethod
    def fromJson(value: Any) -> Any:
        return None if value is None else json.loads(value)

    @staticmethod
    def len(value: Any) -> int:  # noqa: A003
        return 0 if value is None else len(value)

    @staticmethod
    def now() -> int:
        return int(time.time() * 1000)

    @staticmethod
    def uuid() -> str:
        return uuid.uuid4().hex

    @staticmethod
    def timestampAdd(timestamp: Any, delta: Any, unit: str) -> int:
        base = int(timestamp)
        amount = int(delta)
        scale = {
            "years": 31536000000,
            "months": 2592000000,
            "days": 86400000,
            "hours": 3600000,
            "minutes": 60000,
            "seconds": 1000,
            "millis": 1,
        }.get(unit)
        if scale is None:
            raise ExpressionError(f"unknown time unit {unit!r}")
        return base + amount * scale

    @staticmethod
    def dateadd(value: Any, delta: Any, unit: str) -> int:
        if isinstance(value, str):
            parsed = datetime.datetime.fromisoformat(value.replace("Z", "+00:00"))
            value = int(parsed.timestamp() * 1000)
        return Functions.timestampAdd(value, delta, unit)

    @staticmethod
    def emptyString() -> str:
        return ""

    @staticmethod
    def emptyList() -> list:
        return []

    @staticmethod
    def emptyMap() -> dict:
        return {}

    @staticmethod
    def listAdd(lst: Any, item: Any) -> list:
        out = list(lst or [])
        out.append(item)
        return out

    @staticmethod
    def listOf(*items: Any) -> list:
        return list(items)

    @staticmethod
    def mapOf(*kv: Any) -> dict:
        if len(kv) % 2:
            raise ExpressionError("mapOf requires an even number of arguments")
        return {kv[i]: kv[i + 1] for i in range(0, len(kv), 2)}

    @staticmethod
    def mapPut(mapping: Any, key: Any, value: Any) -> dict:
        out = dict(mapping or {})
        out[key] = value
        return out

    @staticmethod
    def mapRemove(mapping: Any, key: Any) -> dict:
        out = dict(mapping or {})
        out.pop(key, None)
        return out


_ALLOWED_NODES = (
    ast.Expression,
    ast.BoolOp, ast.And, ast.Or,
    ast.UnaryOp, ast.Not, ast.USub, ast.UAdd,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.FloorDiv,
    ast.Pow,
    ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot,
    ast.IfExp,
    ast.Call, ast.keyword,
    ast.Attribute, ast.Subscript, ast.Index, ast.Slice,
    ast.Name, ast.Load,
    ast.Constant,
    ast.List, ast.Tuple, ast.Dict, ast.Set,
)

_JSTL_FN = re.compile(r"\bfn:([a-zA-Z_][a-zA-Z0-9_]*)")


def _validate(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ExpressionError(
                f"disallowed syntax in expression: {type(node).__name__}"
            )
        if isinstance(node, ast.Attribute) and node.attr.startswith("__"):
            raise ExpressionError("dunder attribute access is not allowed")
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ExpressionError("dunder names are not allowed")
        if isinstance(node, ast.Call):
            func = node.func
            ok = (
                isinstance(func, ast.Attribute)
                or (isinstance(func, ast.Name) and func.id in _SAFE_CALLS)
            )
            if not ok:
                raise ExpressionError("only fn.* and method calls are allowed")


_SAFE_CALLS = {"len", "str", "int", "float", "bool", "min", "max", "abs", "round", "sorted", "sum"}

_SAFE_GLOBALS = {
    "len": len, "str": str, "int": int, "float": float, "bool": bool,
    "min": min, "max": max, "abs": abs, "round": round, "sorted": sorted,
    "sum": sum, "true": True, "false": False, "null": None, "None": None,
    "True": True, "False": False,
}


class Expression:
    """A compiled, sandboxed expression."""

    def __init__(self, source: str) -> None:
        self.source = source
        normalized = _JSTL_FN.sub(r"fn.\1", source)
        # JSTL wrapping `${...}` is accepted and stripped
        stripped = normalized.strip()
        if stripped.startswith("${") and stripped.endswith("}"):
            stripped = stripped[2:-1]
        try:
            tree = ast.parse(stripped, mode="eval")
        except SyntaxError as error:
            raise ExpressionError(f"bad expression {source!r}: {error}") from error
        _validate(tree)
        self._code = compile(tree, filename="<expression>", mode="eval")

    def evaluate(self, context: Dict[str, Any]) -> Any:
        scope = dict(_SAFE_GLOBALS)
        scope["fn"] = Functions
        for key, value in context.items():
            scope[key] = _wrap(value)
        try:
            return eval(self._code, {"__builtins__": {}}, scope)  # noqa: S307
        except ExpressionError:
            raise
        except Exception as error:  # noqa: BLE001
            raise ExpressionError(
                f"error evaluating {self.source!r}: {error}"
            ) from error


def evaluate(source: str, context: Dict[str, Any]) -> Any:
    return Expression(source).evaluate(context)


def evaluate_predicate(source: str, context: Dict[str, Any]) -> bool:
    return bool(Expression(source).evaluate(context))


# ---------------------------------------------------------------------- #
# Mustache-style prompt templating ({{ value.question }})
# ---------------------------------------------------------------------- #
_MUSTACHE = re.compile(r"\{\{\{?\s*([^}]+?)\s*\}?\}\}")


def render_template(template: str, context: Dict[str, Any]) -> str:
    """Render ``{{ path.or.expression }}`` placeholders (the prompt
    templating of ``ChatCompletionsStep``; the reference uses Mustache)."""

    def sub(match: "re.Match[str]") -> str:
        expression = match.group(1)
        value = Expression(expression).evaluate(context)
        if value is None:
            return ""
        if isinstance(value, (dict, list)):
            return json.dumps(value, ensure_ascii=False, default=str)
        return str(value)

    return _MUSTACHE.sub(sub, template)
