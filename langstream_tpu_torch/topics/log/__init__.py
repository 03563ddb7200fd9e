"""tpulog: the framework's durable, partitioned log broker.

- ``store`` — native (C++) segmented log files, crc-checked, O(1) index.
- ``broker`` — embedded durable broker with consumer groups and persisted
  out-of-order-commit watermarks.
- ``server``/``client`` — TCP network layer for multi-process apps.

The port's own copy of ``langstream_tpu/topics/log/``.
"""

from langstream_tpu_torch.topics.log.broker import (
    LogBroker,
    LogTopicConnectionsRuntime,
)
from langstream_tpu_torch.topics.log.client import RemoteTopicConnectionsRuntime
from langstream_tpu_torch.topics.log.server import BrokerServer

__all__ = [
    "LogBroker",
    "LogTopicConnectionsRuntime",
    "RemoteTopicConnectionsRuntime",
    "BrokerServer",
]
