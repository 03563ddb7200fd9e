"""User-custom Python agents: in-process by default, crash-isolated on
request.

The reference runs user Python code in a subprocess bridged over localhost
gRPC (``langstream-agent-grpc/src/main/proto/langstream_grpc/proto/agent.proto:24-111``,
``PythonGrpcServer.java:31``) because its runtime is a JVM. This framework's
runtime *is* Python, so user agents load in-process by default: the
``className`` config names a ``module.Class`` importable from the
application's ``python/`` directory (added to ``sys.path`` by the planner,
mirroring the reference's PYTHONPATH contract,
``PythonGrpcServer.java:54-91``). Set ``isolation: process`` (or env
``LS_PYTHON_ISOLATION=process`` to flip the default) to restore the
reference's crash boundary for untrusted code — the agent then runs in a
child process behind the socket contract in ``agents/isolation.py``.

User classes follow the same duck-typed shape as the reference Python SDK
(``langstream-runtime/langstream-runtime-impl/src/main/python/langstream_grpc/api.py:34-195``):

- processor: ``process(record) -> list`` (async or sync) — each result is
  coerced via :func:`~langstream_tpu_torch.api.records.record_from_value`.
- source: ``read() -> list``; optional ``commit(records)``.
- sink: ``write(record)``.
- service: ``main()`` / ``join()``.
- all kinds: optional ``init(config)``, ``start()``, ``close()``,
  ``set_context(context)``.

The port's own copy of ``langstream_tpu/agents/python_agents.py``. The
runner adds the app's ``python/`` and ``python/lib`` directories to each
python agent's ``pythonPath`` (``runtime/local.py``); under ``isolation:
process`` the child is ``python -m langstream_tpu_torch.agents.isolation``,
which imports no torch.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import sys
from typing import Any, Dict, List

from langstream_tpu_torch.api.agent import (
    AgentContext,
    AgentService,
    AgentSink,
    AgentSource,
    SingleRecordProcessor,
)
from langstream_tpu_torch.api.records import Record, record_from_value
from langstream_tpu_torch.runtime.registry import load_class


async def _maybe_await(value):
    if inspect.isawaitable(value):
        return await value
    return value


def _load_user_class(class_name: str, python_paths) -> type:
    """Resolve ``module.Class`` from the app's python dirs.

    When ``pythonPath`` entries are given, the user modules import under
    a synthetic package namespaced by the path set (same isolation the
    plugin system uses): two apps in one process may both ship a module
    named ``my_agent`` without the first import shadowing the second —
    a plain ``sys.path`` + ``import_module`` would cache the first one
    process-wide in ``sys.modules``. Without pythonPath, fall back to
    the plain import (framework-provided classes on sys.path).
    """
    if not python_paths:
        return load_class(class_name)
    import hashlib
    import importlib
    import types

    tag = hashlib.sha256(
        "\x00".join(sorted(str(p) for p in python_paths)).encode()
    ).hexdigest()[:12]
    namespace = "_ls_apps"
    package_name = f"{namespace}.app_{tag}"
    root = sys.modules.get(namespace)
    if root is None:
        root = types.ModuleType(namespace)
        root.__path__ = []  # type: ignore[attr-defined]
        sys.modules[namespace] = root
    package = sys.modules.get(package_name)
    if package is None:
        package = types.ModuleType(package_name)
        package.__path__ = [str(p) for p in python_paths]  # type: ignore[attr-defined]
        package.__package__ = package_name
        sys.modules[package_name] = package
    module_name, _, cls_name = class_name.rpartition(".")
    if not module_name:
        raise ValueError(
            f"className must be 'module.Class', got {class_name!r}"
        )
    module = importlib.import_module(f"{package_name}.{module_name}")
    return getattr(module, cls_name)


class _PythonAgentMixin:
    user_agent: Any = None

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.configuration = configuration
        class_name = configuration.get("className")
        if not class_name:
            raise ValueError("python agent requires 'className' configuration")
        isolation = configuration.get(
            "isolation", os.environ.get("LS_PYTHON_ISOLATION", "auto")
        )
        if isolation not in ("auto", "none", "process", "", None):
            # a typo ('Process', 'true') must not silently run untrusted
            # code in-process — the boundary the operator asked for
            # would be absent with no signal
            raise ValueError(
                f"python agent isolation must be 'auto', 'none', or "
                f"'process', got {isolation!r}"
            )
        if isolation == "auto":
            # apps that ship third-party deps in python/lib need the
            # reference's flat PYTHONPATH semantics — one interpreter
            # per app, i.e. the process boundary. Pure-app-code agents
            # stay in-process (namespaced imports keep them collision
            # -proof across apps).
            isolation = "process" if any(
                os.path.basename(str(p).rstrip("/")) == "lib"
                for p in configuration.get("pythonPath") or []
            ) else "none"
        if isolation == "process":
            # the reference's crash boundary (PythonGrpcServer.java:54-91):
            # untrusted user code runs in a child; a crash kills the pod,
            # not the runtime/engine. See agents/isolation.py.
            from langstream_tpu_torch.agents.isolation import RemoteUserAgent

            self.user_agent = await RemoteUserAgent.spawn(
                getattr(self, "agent_type", "python-agent"), configuration
            )
            return
        extra_path = configuration.get("pythonPath") or []
        cls = _load_user_class(class_name, extra_path)
        self.user_agent = cls()
        if hasattr(self.user_agent, "init"):
            await _maybe_await(self.user_agent.init(configuration))

    async def set_context(self, context: AgentContext) -> None:
        self.context = context
        if self.user_agent is not None and hasattr(self.user_agent, "set_context"):
            await _maybe_await(self.user_agent.set_context(context))

    async def start(self) -> None:
        if self.user_agent is not None and hasattr(self.user_agent, "start"):
            await _maybe_await(self.user_agent.start())

    async def close(self) -> None:
        if self.user_agent is not None and hasattr(self.user_agent, "close"):
            await _maybe_await(self.user_agent.close())

    def agent_info(self) -> Dict[str, Any]:
        info = super().agent_info()  # type: ignore[misc]
        info["className"] = getattr(self, "configuration", {}).get("className")
        if self.user_agent is not None and hasattr(self.user_agent, "agent_info"):
            info["user"] = self.user_agent.agent_info()
        return info


class PythonProcessorAgent(_PythonAgentMixin, SingleRecordProcessor):
    agent_type = "python-processor"

    async def process_record(self, record: Record) -> List[Record]:
        results = await _maybe_await(self.user_agent.process(record))
        if results is None:
            return []
        return [record_from_value(r, origin=record.origin) for r in results]


class PythonSourceAgent(_PythonAgentMixin, AgentSource):
    agent_type = "python-source"

    async def read(self, max_records: int = 100) -> List[Record]:
        results = await _maybe_await(self.user_agent.read())
        if not results:
            # politeness: avoid a hot spin when the user source is empty
            await asyncio.sleep(0.05)
            return []
        return [record_from_value(r) for r in results]

    async def commit(self, records: List[Record]) -> None:
        if hasattr(self.user_agent, "commit"):
            await _maybe_await(self.user_agent.commit(records))

    async def permanent_failure(self, record: Record, error: BaseException) -> None:
        if hasattr(self.user_agent, "permanent_failure"):
            await _maybe_await(self.user_agent.permanent_failure(record, error))
        else:
            raise error


class PythonSinkAgent(_PythonAgentMixin, AgentSink):
    agent_type = "python-sink"

    async def write(self, record: Record) -> None:
        await _maybe_await(self.user_agent.write(record))


class PythonServiceAgent(_PythonAgentMixin, AgentService):
    agent_type = "python-service"

    async def join(self) -> None:
        if hasattr(self.user_agent, "join"):
            await _maybe_await(self.user_agent.join())
        elif hasattr(self.user_agent, "main"):
            await _maybe_await(self.user_agent.main())
        else:
            await asyncio.Event().wait()
