"""Snapshot-tolerant reads of another thread's containers (the port's
own copy of ``langstream_tpu/utils/threadsafe.py``).

CPython guarantees individual dict/list/set operations are atomic, but
ITERATION over a container is not: a writer inserting a key mid-iteration
raises ``RuntimeError: dictionary changed size during iteration`` (dicts,
sets, ``WeakSet``). That is exactly how a metrics scrape racing a
supervisor rebuild — which constructs the replacement engine on the
dying engine thread and registers it in ``_LIVE_ENGINES`` — or racing
the engine thread's first write of a new ``tokens_wasted`` reason can
take down an HTTP handler (the failure class PR 10 fixed by hand in
``build_heartbeat``; the lock-discipline pass now flags it, and these
helpers are the sanctioned read-side pattern for state annotated
``owned-by`` another thread).

Readers here never block the writer: retry the snapshot a few times and,
if the container is persistently hot, return the empty snapshot — for a
gauge scrape a missed poll is strictly better than a 500.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

_ATTEMPTS = 8


def stable_list(iterable: Iterable[Any], attempts: int = _ATTEMPTS) -> List[Any]:
    """``list(iterable)`` retried across concurrent resizes."""
    for _ in range(attempts):
        try:
            return list(iterable)
        except RuntimeError:  # changed size during iteration
            continue
    return []


def stable_items(
    mapping: Dict[Any, Any], attempts: int = _ATTEMPTS
) -> List[Tuple[Any, Any]]:
    """``list(mapping.items())`` retried across concurrent resizes."""
    for _ in range(attempts):
        try:
            return list(mapping.items())
        except RuntimeError:
            continue
    return []
