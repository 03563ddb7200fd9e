"""The compiler: YAML application directory → Application → ExecutionPlan.

The port's own copy of ``langstream_tpu/compiler/`` (the reference's
``ModelBuilder.java:74`` and ``BasicClusterRuntime.java:45``), reading
YAML with ``yaml_reader`` instead of PyYAML.
"""

from langstream_tpu_torch.compiler.parser import build_application, parse_application_directory
from langstream_tpu_torch.compiler.planner import ExecutionPlan, build_execution_plan

__all__ = [
    "ExecutionPlan",
    "build_application",
    "build_execution_plan",
    "parse_application_directory",
]
