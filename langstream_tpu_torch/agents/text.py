"""Text-processing agents of the port: ``document-to-json``.

The port's own copy of ``DocumentToJsonAgent`` from
``langstream_tpu/agents/text.py`` (the reference's
``DocumentToJsonAgent.java:29``). The module's other agents
(``text-splitter``, ``text-normaliser``, ``language-detector``,
``text-extractor``) are not yet ported.
"""

from __future__ import annotations

from typing import Any, Dict, List

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.records import Record


class DocumentToJsonAgent(SingleRecordProcessor):
    """Wrap the raw value into a JSON object field
    (``DocumentToJsonAgent.java:29``)."""

    agent_type = "document-to-json"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.text_field = configuration.get("text-field", "text")
        self.copy_properties = bool(configuration.get("copy-properties", True))

    async def process_record(self, record: Record) -> List[Record]:
        payload: Dict[str, Any] = {self.text_field: record.value_as_text()}
        if self.copy_properties:
            for name, value in record.headers:
                payload[name] = value
        return [record.with_value(payload)]
