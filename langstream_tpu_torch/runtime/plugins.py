"""Agent plugin packages — the NAR-archive equivalent.

Reference: ``langstream-runtime/langstream-runtime-impl/src/main/java/ai/
langstream/runtime/agent/nar/NarFileHandler.java:44`` — agent bundles
shipped as archives, each loaded in its own classloader so two bundles'
internal classes never collide, with agent types discovered from the
bundle's metadata.

Python re-design: a plugin is a directory (or ``.zip``) containing

.. code-block:: yaml

    # plugin.yaml
    name: my-agents
    agents:
      my-source: "agents_module.MySource"     # module path inside python/
      my-mapper: "agents_module.MyMapper"

with the implementation under ``python/``. Isolation comes from module
namespacing: each plugin's code is imported under the synthetic package
``_ls_plugins.<name>`` whose ``__path__`` is the plugin's own ``python``
dir — so two plugins may both ship a ``util.py`` (or even the same
module names) without clashing, the moral equivalent of the reference's
per-NAR classloader. Agent types register lazily: the plugin module is
imported on first instantiation, not at scan time.

The port's own copy of ``langstream_tpu/runtime/plugins.py``; it reads
``plugin.yaml`` with the port's YAML reader (``compiler/yaml_reader.py``),
since the card's machine has no PyYAML.
"""

from __future__ import annotations

import importlib
import logging
import os
import sys
import types
import zipfile
from typing import Dict, List

from langstream_tpu_torch.compiler.yaml_reader import load_file
from langstream_tpu_torch.runtime.registry import register_agent

logger = logging.getLogger(__name__)

_NAMESPACE = "_ls_plugins"
_loaded_plugins: Dict[str, str] = {}  # name -> source path


def _ensure_namespace_package() -> types.ModuleType:
    package = sys.modules.get(_NAMESPACE)
    if package is None:
        package = types.ModuleType(_NAMESPACE)
        package.__path__ = []  # type: ignore[attr-defined]
        sys.modules[_NAMESPACE] = package
    return package


def _plugin_package(name: str, python_dir: str) -> str:
    """Create (or refresh) the synthetic package for one plugin."""
    _ensure_namespace_package()
    qualified = f"{_NAMESPACE}.{name}"
    package = types.ModuleType(qualified)
    package.__path__ = [python_dir]  # type: ignore[attr-defined]
    package.__package__ = qualified
    sys.modules[qualified] = package
    # drop stale submodules of a previously-loaded version
    for module_name in list(sys.modules):
        if module_name.startswith(qualified + "."):
            del sys.modules[module_name]
    return qualified


def load_plugin(path: str) -> List[str]:
    """Load one plugin directory or ``.zip``; returns the agent types it
    registered."""
    import tempfile

    if path.endswith(".zip") and os.path.isfile(path):
        target = tempfile.mkdtemp(prefix="ls-plugin-")
        with zipfile.ZipFile(path) as archive:
            for member in archive.namelist():
                real = os.path.realpath(os.path.join(target, member))
                if not real.startswith(os.path.realpath(target) + os.sep):
                    raise ValueError(f"plugin member escapes archive: {member}")
            archive.extractall(target)
        path = target
    manifest_path = os.path.join(path, "plugin.yaml")
    if not os.path.isfile(manifest_path):
        raise ValueError(f"no plugin.yaml in {path}")
    manifest = load_file(manifest_path) or {}
    name = manifest.get("name") or os.path.basename(path.rstrip("/"))
    name = name.replace("-", "_")
    agents = manifest.get("agents") or {}
    if not agents:
        raise ValueError(f"plugin {name!r} declares no agents")
    python_dir = os.path.join(path, "python")
    if not os.path.isdir(python_dir):
        python_dir = path
    qualified = _plugin_package(name, python_dir)

    registered: List[str] = []
    for agent_type, class_ref in agents.items():
        module_name, _, class_name = str(class_ref).replace(":", ".").rpartition(".")
        if not module_name:
            raise ValueError(
                f"plugin agent {agent_type!r}: class reference must be "
                f"'module.Class', got {class_ref!r}"
            )

        def factory(
            module_name: str = module_name, class_name: str = class_name
        ):
            module = importlib.import_module(f"{qualified}.{module_name}")
            return getattr(module, class_name)()

        register_agent(agent_type, factory)
        registered.append(agent_type)
    _loaded_plugins[name] = path
    logger.info("plugin %s: registered %s", name, registered)
    return registered


def load_plugins(directory: str) -> Dict[str, List[str]]:
    """Scan a plugins directory (each entry a plugin dir or .zip).
    The runner calls this with ``LANGSTREAM_PLUGINS_DIR`` when set."""
    out: Dict[str, List[str]] = {}
    if not os.path.isdir(directory):
        return out
    for entry in sorted(os.listdir(directory)):
        path = os.path.join(directory, entry)
        if entry.endswith(".zip") or (
            os.path.isdir(path)
            and os.path.isfile(os.path.join(path, "plugin.yaml"))
        ):
            try:
                out[entry] = load_plugin(path)
            except Exception:  # noqa: BLE001 — one bad plugin can't kill boot
                logger.exception("failed to load plugin %s", path)
    return out


def loaded_plugins() -> Dict[str, str]:
    return dict(_loaded_plugins)
