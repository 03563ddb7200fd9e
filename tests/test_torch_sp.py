"""Sequence parallelism in the port against the JAX package, on the CPU.

The port's ring (``parallel/ring.py``) and Ulysses
(``parallel/ulysses.py``) attention run one process per sp rank over
gloo (one pool of four ranks, ``tests/torch_mesh_worker.py``'s
``sp_cases``); the JAX package's run their ``shard_map`` over the host
devices ``tests/conftest.py`` forces. The same numpy-seeded f32 inputs
go through both, at the shapes and tolerances of
``tests/test_attention_kernels.py`` and ``tests/test_ulysses.py``:

- ``ring_attention_sharded`` at sp 2 and 4, causal with a padding mask
  (B 2 × T 64, 4 heads over 2 kv heads of 16; rows 64 and 50 long) and
  non-causal (B 1 × T 32, 2 heads of 8) at sp 2: the output on every
  valid row within rtol/atol 1e-5 of JAX's;
- ``ulysses_attention_sharded`` at sp 2 and 4 (B 2 × T 8·sp, 8 heads
  over 4 of 16; rtol 1e-4, atol 1e-5) and with a padding mask at sp 4
  (10 of 16 tokens); heads that sp does not divide raise JAX's message;
- every case's input gradients (of the output against a seeded
  cotangent) within 1e-5 of max |g| of the port's plain
  ``prefill_attention`` (or the plain non-causal softmax) on one
  process, and the output and gradients equal on every rank.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from langstream_tpu.parallel.ring import ring_attention_sharded as jax_ring
from langstream_tpu.parallel.ulysses import ulysses_attention_sharded as jax_ulysses
from langstream_tpu_torch.ops.attention import prefill_attention
from langstream_tpu_torch.parallel.mesh import AxisGroup
from langstream_tpu_torch.parallel.ulysses import ulysses_attention_sharded
import torch_mesh_worker as worker

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _case(name, kind, size, shape, seed, lengths=None, causal=True, rtol=1e-5, atol=1e-5):
    return {"name": name, "kind": kind, "size": size, "shape": shape, "seed": seed,
            "lengths": lengths, "causal": causal, "rtol": rtol, "atol": atol}


CASES = [
    _case("ring-sp2", "ring", 2, (2, 64, 4, 2, 16), 2, lengths=[64, 50]),
    _case("ring-sp4", "ring", 4, (2, 64, 4, 2, 16), 2, lengths=[64, 50]),
    _case("ring-noncausal-sp2", "ring", 2, (1, 32, 2, 2, 8), 3, causal=False),
    _case("ulysses-sp2", "ulysses", 2, (2, 16, 8, 4, 16), 0, rtol=1e-4),
    _case("ulysses-sp4", "ulysses", 4, (2, 32, 8, 4, 16), 0, rtol=1e-4),
    _case("ulysses-padded-sp4", "ulysses", 4, (1, 16, 4, 4, 8), 1, lengths=[10], rtol=1e-4),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    children, wait = worker.start_pool("sp_cases", CASES, {}, str(root), str(REPO))
    yield wait
    for child in children:
        if child.poll() is None:
            child.kill()


def _mask(case):
    if not case["lengths"]:
        return None
    seq = case["shape"][1]
    return np.arange(seq)[None, :] < np.array(case["lengths"])[:, None]


def _plain(case, q, k, v, mask):
    if case["causal"]:
        return prefill_attention(q, k, v, mask=mask)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqs,bshd->bqhd", torch.softmax(scores, dim=-1), v)


def _close(out, ref, rel, label):
    scale = max(float(np.abs(ref).max()), 1e-12)
    worst = float(np.abs(np.asarray(out) - np.asarray(ref)).max())
    assert worst <= rel * scale, (label, worst, scale)


@pytest.mark.parametrize("case", CASES, ids=[case["name"] for case in CASES])
def test_sequence_parallel_matches_jax(ranks, case):
    q, k, v, cotangent = worker.attention_inputs(*case["shape"], seed=case["seed"])
    mask = _mask(case)
    mesh = Mesh(np.asarray(jax.devices()[:case["size"]]), ("sp",))
    args = [jnp.asarray(a) for a in (q, k, v)]
    jmask = None if mask is None else jnp.asarray(mask)
    if case["kind"] == "ring":
        want = jax_ring(*args, mesh, mask=jmask, causal=case["causal"])
    else:
        want = jax.jit(lambda *a: jax_ulysses(*a, mesh, mask=jmask))(*args)
    want = np.asarray(want)
    got = ranks(case["name"])
    assert bool(got["equal"])
    for b, n in enumerate(case["lengths"] or [case["shape"][1]] * case["shape"][0]):
        np.testing.assert_allclose(got["out"][b, :n], want[b, :n], rtol=case["rtol"],
                                   atol=case["atol"])
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    plain = _plain(case, tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    (plain * torch.from_numpy(cotangent)).sum().backward()
    _close(got["out"], plain.detach().numpy(), 1e-5, "out vs plain")
    for name, tensor in (("dq", tq), ("dk", tk), ("dv", tv)):
        _close(got[name], tensor.grad.numpy(), 1e-5, name)


def test_ulysses_rejects_indivisible_heads():
    """6 heads over sp=4: JAX's message, before any rank talks."""
    sp = 4
    q, kv = np.ones((1, 16, 6, 8), np.float32), np.ones((1, 16, 2, 8), np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    with pytest.raises(ValueError, match="divisible") as jax_error:
        jax.jit(lambda q, k, v: jax_ulysses(q, k, v, mesh))(q, kv, kv)
    with pytest.raises(ValueError) as port_error:
        ulysses_attention_sharded(*(torch.from_numpy(a) for a in (q, kv, kv)), AxisGroup(0, sp))
    assert str(port_error.value) == str(jax_error.value)
