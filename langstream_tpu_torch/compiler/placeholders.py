"""Placeholder resolution: ``${secrets.*}``, ``${globals.*}``, env defaults.

The port's own copy of ``langstream_tpu/compiler/placeholders.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's resolver
(``langstream-core/src/main/java/ai/langstream/impl/common/ApplicationPlaceholderResolver.java:45``):
after parsing, every string in the model is interpolated against a context
of ``secrets`` / ``globals`` / ``cluster`` values. Secrets *values* may
themselves use shell-style env expansion ``${ENV_VAR:-default}``
(``examples/secrets/secrets.yaml:18-30``).

Mustache prompt templates (``{{ value.question }}``) are NOT resolved here —
they are runtime templates owned by the chat-completions step.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict

_PLACEHOLDER = re.compile(
    r"\$\{\s*([a-zA-Z0-9_.\-]+)\s*(?::-([^}]*))?\}"
)
_ENV = re.compile(r"\$\{(?P<name>[A-Za-z_][A-Za-z0-9_]*)(?::-(?P<default>[^}]*))?\}")


class PlaceholderError(KeyError):
    pass


def resolve_env(value: str) -> str:
    """Shell-style ``${VAR}`` / ``${VAR:-default}`` expansion (secrets files)."""

    def sub(match: "re.Match[str]") -> str:
        name = match.group("name")
        default = match.group("default")
        got = os.environ.get(name)
        if got is not None:
            return got
        if default is not None:
            return default
        raise PlaceholderError(f"environment variable {name} not set")

    return _ENV.sub(sub, value)


def _lookup(
    context: Dict[str, Any], dotted: str, default: Any = None,
    has_default: bool = False,
) -> Any:
    node: Any = context
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            if has_default:
                # ``${globals.key:-fallback}`` — same shell-style default
                # spelling secrets values already support (resolve_env)
                return default
            raise PlaceholderError(f"unresolved placeholder: ${{{dotted}}}")
    return node


def resolve_value(value: Any, context: Dict[str, Any]) -> Any:
    if isinstance(value, str):
        # whole-string placeholder keeps the native type of the target
        whole = _PLACEHOLDER.fullmatch(value.strip())
        if whole:
            return _lookup(
                context, whole.group(1), whole.group(2),
                has_default=whole.group(2) is not None,
            )

        def sub(match: "re.Match[str]") -> str:
            return str(_lookup(
                context, match.group(1), match.group(2),
                has_default=match.group(2) is not None,
            ))

        return _PLACEHOLDER.sub(sub, value)
    if isinstance(value, dict):
        return {k: resolve_value(v, context) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve_value(v, context) for v in value]
    return value


def build_context(
    secrets: Dict[str, Dict[str, Any]],
    globals_: Dict[str, Any],
    cluster: Dict[str, Any],
) -> Dict[str, Any]:
    """Context shape per the reference (``ApplicationPlaceholderResolver``
    context build, lines 81-92): ``secrets.<id>.<key>``, ``globals.<key>``,
    ``cluster.<key>``."""
    return {"secrets": secrets, "globals": globals_, "cluster": cluster}
