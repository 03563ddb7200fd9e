"""Per-session conversation memory.

``Memory`` prepends the session's accumulated transcript so the rendered
prompt strictly EXTENDS the previous turn's prompt+answer — the prefix
property the engine's KV session cache needs. ``Remember`` appends the
new turn after the completion. State is in-process (swap for a
datasource-backed store in production, as the reference's
chat-history examples do).
"""

_HISTORY: dict = {}


def _session(record):
    return record.header("langstream-client-session-id") or "anonymous"


class Memory:
    def process(self, record):
        value = dict(record.value)
        value["history"] = _HISTORY.get(_session(record), "")
        value["sessionId"] = _session(record)
        return [record.with_value(value)]


class Remember:
    def process(self, record):
        value = record.value
        session = _session(record)
        _HISTORY[session] = (
            value.get("history", "")
            + value.get("question", "")
            + value.get("answer", "")
        )
        return [record]
