"""The port's multi-host bootstrap (``runtime/multihost.py``) against the
JAX package's: ``plan_from_statefulset`` equal to JAX's plan for the
cases of ``tests/test_multihost.py`` and a few more (the environment's
defaults, other ports, deeper replicas), the same refusal, and
``initialize_multihost`` a no-op for a single-host replica."""

import dataclasses

import pytest

from langstream_tpu.runtime import multihost as jax_multihost
from langstream_tpu_torch.runtime import multihost

CASES = [
    ("app-shout-3", dict(hosts_per_replica=1)),
    *[(f"app-llm-{i}", dict(hosts_per_replica=2, namespace="team-a")) for i in range(4)],
    ("a-b-5", dict(hosts_per_replica=2, namespace="ns")),
    ("serve-llama-70b-7", dict(hosts_per_replica=4, namespace="prod", port=9000)),
    ("x-0", dict(hosts_per_replica=8, service="headless")),
]


@pytest.mark.parametrize("hostname,kwargs", CASES, ids=[name for name, _ in CASES])
def test_plan_matches_jax(hostname, kwargs):
    port = multihost.plan_from_statefulset(hostname, **kwargs)
    ref = jax_multihost.plan_from_statefulset(hostname, **kwargs)
    if ref is None:
        assert port is None
        return
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.is_coordinator == ref.is_coordinator


def test_plan_from_the_environment_matches_jax(monkeypatch):
    monkeypatch.setenv("LANGSTREAM_HOSTS_PER_REPLICA", "2")
    monkeypatch.setenv("HOSTNAME", "app-llm-3")
    monkeypatch.setenv("LANGSTREAM_NAMESPACE", "team-b")
    port, ref = multihost.plan_from_statefulset(), jax_multihost.plan_from_statefulset()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.coordinator == "app-llm-2.app-llm.team-b.svc:8476"


def test_bad_hostname_rejected_and_single_host_is_noop(monkeypatch):
    with pytest.raises(ValueError, match="ordinal hostname"):
        multihost.plan_from_statefulset("not-a-statefulset-pod-name-", hosts_per_replica=2)
    monkeypatch.delenv("LANGSTREAM_HOSTS_PER_REPLICA", raising=False)
    assert multihost.initialize_multihost() is False
