"""Generic external-connector agents: ``exec-source`` / ``exec-sink``.

Role analogue of the reference's connector escape hatches — the Camel
source (langstream-agent-camel/src/main/java/ai/langstream/agents/camel/CamelSource.java:43)
and the Kafka Connect adapters
(langstream-kafka-runtime/.../kafkaconnect/KafkaConnect{Source,Sink}Agent.java)
— which exist to bridge arbitrary third-party systems into a pipeline.
Those ecosystems are JVM-only; the TPU build's equivalent escape hatch is
a supervised subprocess speaking newline-delimited JSON:

- ``exec-source``: spawn ``command``, each stdout line becomes a record
  (JSON object → value fields; non-JSON → raw string value). The
  process is restarted with backoff if it exits while the agent runs.
- ``exec-sink``: spawn ``command``, write each record's value as one
  JSON line to its stdin (acked once written and flushed).

This covers the same operational role (tail a syslog, bridge an MQTT
broker via mosquitto_sub, psql COPY, any CLI) without a JVM.

The port's own copy of ``langstream_tpu/agents/connector.py``, with one
repair: at a command's EOF ``exec-source`` waits for its exit before the
next read restarts it (the JAX package's can spin there forever).
"""

from __future__ import annotations

import asyncio
import json
import logging
import shlex
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.agent import AgentSink, AgentSource
from langstream_tpu_torch.api.records import Record, SimpleRecord, now_millis

logger = logging.getLogger(__name__)


class ExecSource(AgentSource):
    """``exec-source`` agent."""

    agent_type = "exec-source"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.command = configuration["command"]
        self.restart_seconds = float(configuration.get("restart-seconds", 5))
        self.parse_json = bool(configuration.get("parse-json", True))
        self.max_restarts = int(configuration.get("max-restarts", 0))  # 0 = ∞
        self._process: Optional[asyncio.subprocess.Process] = None
        self._restarts = 0

    async def start(self) -> None:
        await self._spawn()

    async def _spawn(self) -> None:
        self._process = await asyncio.create_subprocess_exec(
            *shlex.split(self.command),
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
        )
        logger.info("exec-source started: %s (pid %s)", self.command, self._process.pid)

    async def read(self, max_records: int = 100) -> List[Record]:
        process = self._process
        if process is None or process.returncode is not None:
            if self.max_restarts and self._restarts >= self.max_restarts:
                raise RuntimeError(
                    f"exec-source command exited after {self._restarts} restarts"
                )
            self._restarts += 1
            # exponential backoff from 50 ms up to restart-seconds
            await asyncio.sleep(
                min(self.restart_seconds, 0.05 * 2 ** (self._restarts - 1))
            )
            await self._spawn()
            process = self._process
        assert process is not None and process.stdout is not None
        # await (with timeout) only the FIRST line; then drain whatever is
        # already buffered up to max_records, so high-volume subprocess
        # streams are not capped at one record per runner-loop iteration
        try:
            line = await asyncio.wait_for(process.stdout.readline(), timeout=0.5)
        except asyncio.TimeoutError:
            return []
        if not line:
            # EOF: let the command's exit be seen before the next read()
            # restarts it. A readline at EOF returns without yielding, so
            # without this wait the runner's loop spins on the EOF and the
            # child's exit is never reaped (the JAX package's hangs so)
            try:
                await asyncio.wait_for(process.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass  # stdout closed, the command still runs
            return []
        records: List[Record] = []
        while True:
            text = line.decode("utf-8", "replace").rstrip("\n")
            if text:
                value: Any = text
                if self.parse_json:
                    try:
                        value = json.loads(text)
                    except ValueError:
                        pass
                records.append(SimpleRecord(value=value, timestamp=now_millis()))
            if len(records) >= max_records:
                break
            try:
                line = await asyncio.wait_for(
                    process.stdout.readline(), timeout=0.0005
                )
            except asyncio.TimeoutError:
                break
            if not line:
                break  # EOF; next read() restarts
        return records

    async def commit(self, records: List[Record]) -> None:
        pass  # the subprocess stream has no replay; at-most-once by nature

    async def close(self) -> None:
        if self._process is not None and self._process.returncode is None:
            self._process.terminate()
            try:
                await asyncio.wait_for(self._process.wait(), timeout=5)
            except asyncio.TimeoutError:
                self._process.kill()
        self._process = None


class ExecSink(AgentSink):
    """``exec-sink`` agent."""

    agent_type = "exec-sink"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.command = configuration["command"]
        self._process: Optional[asyncio.subprocess.Process] = None

    async def start(self) -> None:
        self._process = await asyncio.create_subprocess_exec(
            *shlex.split(self.command),
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.DEVNULL,
        )
        logger.info("exec-sink started: %s (pid %s)", self.command, self._process.pid)

    async def write(self, record: Record) -> None:
        process = self._process
        if process is None or process.stdin is None:
            raise RuntimeError("exec-sink process not running")
        if process.returncode is not None:
            raise RuntimeError(
                f"exec-sink command exited with {process.returncode}"
            )
        value = record.value
        try:
            line = json.dumps(value, default=str)
        except TypeError:
            line = json.dumps(str(value))
        process.stdin.write(line.encode("utf-8") + b"\n")
        await process.stdin.drain()

    async def close(self) -> None:
        if self._process is not None:
            if self._process.stdin is not None:
                try:
                    self._process.stdin.close()
                except Exception:  # noqa: BLE001
                    pass
            if self._process.returncode is None:
                # stdin EOF is the drain signal: give the command real
                # time to flush what it buffered (5 s lost records on a
                # loaded host — a sink's close() must not drop data),
                # and surface the kill instead of silently discarding
                try:
                    await asyncio.wait_for(self._process.wait(), timeout=30)
                except asyncio.TimeoutError:
                    logger.warning(
                        "exec-sink command did not exit after stdin EOF; "
                        "terminating (buffered records may be lost): %s",
                        self.command,
                    )
                    self._process.terminate()
        self._process = None
