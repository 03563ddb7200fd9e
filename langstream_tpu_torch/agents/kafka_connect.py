"""Kafka Connect adapters: run any Connect connector as an agent.

Reference: ``langstream-kafka-runtime/src/main/java/ai/langstream/kafka/
extensions/kafkaconnect/{KafkaConnectSourceAgent.java:67,
KafkaConnectSinkAgent.java:65}`` — the reference embeds connector jars
in-process. The TPU build is Python, so it drives a **Connect worker**
through its REST API instead (the deployment shape Connect itself
recommends): the agent creates/updates the connector on start, deletes
it on close (optional), and the records ride Kafka topics that this
framework's own Kafka runtime reads/writes.

- ``kafka-connect-source``: Connect source connector → its output topic
  → records into the pipeline.
- ``kafka-connect-sink``: pipeline records → a staging topic → Connect
  sink connector consuming it. ``handles_commit`` stays False: the
  staging write is the durability point for the pipeline (the connector
  tracks its own consumer offsets from there).

Config (both): ``connect-url``, ``connector-name``, ``connector-config``
(the raw Connect config dict), ``bootstrapServers`` (for the data
topics), ``topic`` (output/staging topic), ``delete-on-close`` (default
false).

Deployment: point ``connect-url`` at an existing Connect cluster, or
enable the bundled distributed-mode worker the helm chart ships
(``kafkaConnect.enabled=true`` → ``http://<release>-connect:8083``).

The port's own copy of ``langstream_tpu/agents/kafka_connect.py``; its
REST calls go through the port's asyncio HTTP client
(``agents/http_client.py``): aiohttp is not among the card machine's
packages.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import AgentSink, AgentSource
from langstream_tpu_torch.api.records import Record

logger = logging.getLogger(__name__)


def _coerce_bool(value: Any, default: bool) -> bool:
    """Boolean coercion matching the validation layer (docs.py accepts
    "true"/"false"/"1"/"0" strings): bool("false") is True, so plain
    bool() would silently ignore a string opt-out from a placeholder."""
    if value is None or value == "":
        return default
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes")
    return bool(value)


class _ConnectRestClient:
    """REST client for a Connect distributed worker.

    A distributed worker answers **409** on config-mutating (and some
    read) endpoints while a group rebalance is in flight — transient by
    definition — so every call here retries 409s with backoff until
    ``rebalance_timeout`` instead of failing the agent for a condition
    the worker resolves by itself."""

    def __init__(self, url: str, rebalance_timeout: float = 30.0) -> None:
        self.url = url.rstrip("/")
        self.rebalance_timeout = rebalance_timeout

    async def _request(
        self, method: str, path: str,
        retry_budget: Optional[float] = None, **kwargs,
    ):
        """One request with 409-rebalance retry; returns (status, text).
        ``retry_budget`` overrides the default rebalance_timeout — pass
        0 for a single attempt (hot-path health probes must not stall
        behind a rebalance window)."""
        from langstream_tpu_torch.agents import http_client

        budget = (
            self.rebalance_timeout if retry_budget is None else retry_budget
        )
        deadline = time.monotonic() + budget
        delay = 0.2
        while True:
            response = await http_client.request(method, f"{self.url}{path}", **kwargs)
            body = await response.text()
            if response.status != 409 or time.monotonic() >= deadline:
                return response.status, body
            logger.info(
                "connect %s %s: 409 (rebalance in progress), retrying",
                method, path,
            )
            await asyncio.sleep(delay)
            delay = min(delay * 2, 2.0)

    async def ensure_connector(
        self, name: str, config: Dict[str, Any]
    ) -> None:
        """Create-or-update (PUT /connectors/{name}/config is idempotent)."""
        status, body = await self._request(
            "PUT", f"/connectors/{name}/config", json=config
        )
        if status >= 300:
            raise IOError(f"connect PUT {name}: HTTP {status}: {body[:400]}")

    async def status(
        self, name: str, retry_budget: Optional[float] = None
    ) -> Dict[str, Any]:
        status, body = await self._request(
            "GET", f"/connectors/{name}/status", retry_budget=retry_budget
        )
        if status >= 300:
            return {"connector": {"state": f"HTTP {status}"}}
        return json.loads(body)

    async def restart_task(self, name: str, task_id: int) -> None:
        status, body = await self._request(
            "POST", f"/connectors/{name}/tasks/{task_id}/restart"
        )
        if status >= 300:
            raise IOError(
                f"connect restart {name}/{task_id}: HTTP {status}: "
                f"{body[:200]}"
            )

    async def delete_connector(self, name: str) -> None:
        status, body = await self._request("DELETE", f"/connectors/{name}")
        if status not in (204, 404, 200):
            raise IOError(
                f"connect DELETE {name}: HTTP {status}: {body[:200]}"
            )

    async def close(self) -> None:
        """Nothing to close: each request has a connection of its own."""


class _ConnectAgentBase:
    async def init(self, configuration: Dict[str, Any]) -> None:
        self.connect_url = configuration["connect-url"]
        self.connector_name = configuration["connector-name"]
        self.connector_config = dict(
            configuration.get("connector-config") or {}
        )
        self.data_topic = configuration["topic"]
        self.bootstrap = (
            configuration.get("bootstrapServers")
            or configuration.get("bootstrap-servers")
            or "127.0.0.1:9092"
        )
        self.delete_on_close = _coerce_bool(
            configuration.get("delete-on-close"), False
        )
        self.rest = _ConnectRestClient(
            self.connect_url,
            rebalance_timeout=float(
                configuration.get("rebalance-timeout", 30)
            ),
        )
        # a FAILED task on the worker stalls data flow silently from the
        # pipeline's point of view (records just stop) — poll status and
        # restart failed tasks, the remediation the Connect REST API
        # exists for. 0 disables.
        self.restart_failed = _coerce_bool(
            configuration.get("restart-failed-tasks"), True
        )
        self.health_interval = float(
            configuration.get("health-check-interval", 30)
        )
        self._last_health = 0.0
        from langstream_tpu_torch.topics.kafka.runtime import (
            KafkaTopicConnectionsRuntime,
        )

        self._runtime = KafkaTopicConnectionsRuntime(
            {"bootstrapServers": self.bootstrap}
        )

    async def _ensure_data_topic(self) -> None:
        """The data/staging topic is agent config, not a declared
        pipeline topic, so the planner never creates it — and a cluster
        without auto-create then fails every write with
        UNKNOWN_TOPIC_OR_PARTITION (found by live drive). Create-if-not-
        exists via the admin API (already-exists is tolerated)."""
        from langstream_tpu_torch.api.topics import TopicSpec

        admin = self._runtime.create_admin()
        try:
            await admin.create_topic(TopicSpec(name=self.data_topic))
        except Exception as error:  # noqa: BLE001 — e.g. no ACL: the
            # subsequent produce/consume gives the real error if the
            # topic truly doesn't exist
            logger.warning(
                "could not ensure data topic %s: %r", self.data_topic, error
            )

    async def check_health(self, force: bool = False) -> None:
        """Poll connector status (rate-limited to ``health-check-interval``)
        and restart FAILED tasks. Called from the data path, so a worker
        outage degrades to a log line rather than killing the agent."""
        if self.health_interval <= 0:
            return
        now = time.monotonic()
        if not force and now - self._last_health < self.health_interval:
            return
        self._last_health = now
        try:
            # retry_budget=0: health rides the data path — a routine
            # rebalance 409 must cost one round trip, not stall records
            # for the whole rebalance_timeout
            status = await self.rest.status(
                self.connector_name, retry_budget=0
            )
        except Exception as error:  # noqa: BLE001 — health is best-effort
            logger.warning(
                "connector %s status check failed: %r",
                self.connector_name, error,
            )
            return
        for task in status.get("tasks", []):
            if task.get("state") == "FAILED":
                trace = (task.get("trace") or "")[:400]
                logger.warning(
                    "connector %s task %s FAILED on %s: %s",
                    self.connector_name, task.get("id"),
                    task.get("worker_id"), trace,
                )
                if self.restart_failed:
                    try:
                        await self.rest.restart_task(
                            self.connector_name, int(task["id"])
                        )
                        logger.info(
                            "restarted task %s of %s",
                            task["id"], self.connector_name,
                        )
                    except Exception as error:  # noqa: BLE001
                        logger.warning(
                            "task restart failed for %s/%s: %r",
                            self.connector_name, task.get("id"), error,
                        )

    async def _teardown(self) -> None:
        if self.delete_on_close:
            try:
                await self.rest.delete_connector(self.connector_name)
            except Exception:  # noqa: BLE001 — best effort on shutdown
                logger.exception(
                    "failed deleting connector %s", self.connector_name
                )
        await self.rest.close()
        await self._runtime.close()


class KafkaConnectSourceAgent(_ConnectAgentBase, AgentSource):
    """Connect source connector → Kafka topic → pipeline records."""

    agent_type = "kafka-connect-source"

    async def start(self) -> None:
        self.connector_config.setdefault("name", self.connector_name)
        await self.rest.ensure_connector(
            self.connector_name, self.connector_config
        )
        status = await self.rest.status(self.connector_name)
        logger.info(
            "connector %s: %s", self.connector_name,
            status.get("connector", {}).get("state"),
        )
        await self._ensure_data_topic()
        group = f"langstream-{self.agent_id or self.connector_name}"
        self._consumer = self._runtime.create_consumer(
            self.agent_id or "kafka-connect",
            {"topic": self.data_topic, "group": group},
        )
        await self._consumer.start()

    async def read(self, max_records: int = 100) -> List[Record]:
        await self.check_health()
        return await self._consumer.read(
            max_records=max_records, timeout=0.2
        )

    async def commit(self, records: List[Record]) -> None:
        await self._consumer.commit(records)

    async def close(self) -> None:
        await self._consumer.close()
        await self._teardown()


class KafkaConnectSinkAgent(_ConnectAgentBase, AgentSink):
    """Pipeline records → staging Kafka topic → Connect sink connector."""

    agent_type = "kafka-connect-sink"

    async def start(self) -> None:
        self.connector_config.setdefault("name", self.connector_name)
        self.connector_config.setdefault("topics", self.data_topic)
        await self.rest.ensure_connector(
            self.connector_name, self.connector_config
        )
        await self._ensure_data_topic()
        self._producer = self._runtime.create_producer(
            self.agent_id or "kafka-connect", {"topic": self.data_topic}
        )
        await self._producer.start()

    async def write(self, record: Record) -> None:
        await self.check_health()
        await self._producer.write(record)

    async def close(self) -> None:
        await self._producer.close()
        await self._teardown()
