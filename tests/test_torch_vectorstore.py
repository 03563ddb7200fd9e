"""The port's vector store against the JAX package's, on the CPU.

The same upserts, deletes and queries go to the JAX
``VectorStore(use_jax=True)`` and to the port's ``VectorStore`` on the
CPU (the path that runs on the card elsewhere): the ids come back in
``lax.top_k``'s order (the larger score first, the lower row first on a
tie) and the scores agree within 1e-6, for all three metrics, with ``k``
above the count, after swap-deletes and re-upserts. Files written by
one package load in the other, and ``VectorStoreDataSource`` answers as
the JAX one. Data is drawn from seeded numpy generators.
"""

import asyncio
import json
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.agents import vectorstore as jax_vectorstore
from langstream_tpu_torch.agents import vectorstore
from langstream_tpu_torch.agents.datasource import _substitute
from langstream_tpu_torch.providers.torch_local.sampling import lax_top_k

SCORE_TOLERANCE = 1e-6
METRICS = ["cosine", "dot", "l2"]
DIMS = 16


def _pair(metric, **kwargs):
    return (jax_vectorstore.VectorStore(DIMS, metric=metric, use_jax=True, **kwargs),
            vectorstore.VectorStore(DIMS, metric=metric, device="cpu", **kwargs))


def _assert_same(reference, port, queries, ks=(1, 5, 1000)):
    for query in queries:
        for k in ks:
            want = reference.search(query, top_k=k)
            got = port.search(query, top_k=k)
            assert [r["id"] for r in got] == [r["id"] for r in want], (k, got, want)
            np.testing.assert_allclose([r["similarity"] for r in got],
                                       [r["similarity"] for r in want], rtol=0, atol=SCORE_TOLERANCE)
            assert got == [dict(r, similarity=g["similarity"]) for r, g in zip(want, got)]


def _vectors(rng, count):
    """Vectors at the scale of the embeddings a store holds (norm about
    1), where 1e-6 is a few f32 ulps of every score."""
    return rng.normal(0, DIMS ** -0.5, (count, DIMS)).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_jax(metric):
    rng = np.random.default_rng(METRICS.index(metric))
    reference, port = _pair(metric)
    assert port.search([0.0] * DIMS) == reference.search([0.0] * DIMS) == []
    for i, vector in enumerate(_vectors(rng, 37)):  # 37 rows: padded to 64
        for store in (reference, port):
            store.upsert(f"doc-{i}", vector.tolist(), {"text": f"text {i}", "n": i})
    queries = _vectors(rng, 6).tolist()
    _assert_same(reference, port, queries)
    # swap-deletes (the last row moves into the hole), re-upserts of live
    # ids, and new ids after them
    for doc in ("doc-3", "doc-36", "doc-0", "doc-missing"):
        assert port.delete(doc) == reference.delete(doc)
    for i, vector in zip((5, 40, 41, 12), _vectors(rng, 4)):
        for store in (reference, port):
            store.upsert(f"doc-{i}", vector.tolist(), {"n": i})
    assert len(port) == len(reference) == 36
    assert port._ids == reference._ids
    _assert_same(reference, port, queries)


@pytest.mark.parametrize("metric", METRICS)
def test_ties_rank_the_lower_row_first(metric):
    """Rows with equal scores come out lower row first, as ``lax.top_k``
    ranks them; ``torch.topk`` alone promises no order among ties."""
    rng = np.random.default_rng(7)
    reference, port = _pair(metric)
    base = _vectors(rng, 1)[0]
    rows = [base, _vectors(rng, 1)[0], base, base, _vectors(rng, 1)[0], base]
    for i, vector in enumerate(rows):
        for store in (reference, port):
            store.upsert(f"d{i}", vector.tolist())
    _assert_same(reference, port, [base.tolist(), (-base).tolist()], ks=(2, 3, 4, 6))
    top = port.search(base.tolist(), top_k=4)
    assert [r["id"] for r in top] == ["d0", "d2", "d3", "d5"]


def test_lax_top_k_matches_jax():
    rng = np.random.default_rng(3)
    values = rng.integers(-3, 4, (5, 40)).astype(np.float32)  # many ties
    values[0, 3], values[0, 9] = 0.0, -0.0
    values[1, :5] = -np.inf
    values[2, 7] = np.inf
    for k in (1, 7, 40):
        want_values, want_ids = jax.lax.top_k(jnp.asarray(values), k)
        got_values, got_ids = lax_top_k(torch.from_numpy(values), k)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_values.numpy(), np.asarray(want_values))


def test_device_copy_uploads_only_dirty_rows():
    """The card's copy is uploaded whole once, then only the rows that
    changed; after every search it equals the host matrix."""
    rng = np.random.default_rng(11)
    port = vectorstore.VectorStore(DIMS, device="cpu")
    for i, vector in enumerate(_vectors(rng, 20)):
        port.upsert(str(i), vector.tolist())
    port.search(_vectors(rng, 1)[0].tolist())
    resident = port._resident
    assert torch.equal(resident, torch.from_numpy(port._matrix)) and not port._dirty
    port.upsert("3", _vectors(rng, 1)[0].tolist())
    port.delete("7")
    assert port._dirty == {3, 7, 19}
    port.search(_vectors(rng, 1)[0].tolist())
    assert port._resident is resident  # rows copied in place, no new upload
    assert torch.equal(resident, torch.from_numpy(port._matrix))
    for i in range(20, 40):  # a growth past 32 rows: the next search uploads it whole
        port.upsert(str(i), _vectors(rng, 1)[0].tolist())
    assert port._resident is None
    port.search(_vectors(rng, 1)[0].tolist())
    assert port._resident.shape == (64, DIMS)
    assert torch.equal(port._resident, torch.from_numpy(port._matrix))


def test_numpy_path_needs_no_device():
    reference = jax_vectorstore.VectorStore(DIMS, use_jax=False)
    port = vectorstore.VectorStore(DIMS, use_torch=False, device="no-such-device")
    assert port.device is None
    rng = np.random.default_rng(4)
    for i, vector in enumerate(_vectors(rng, 9)):
        reference.upsert(str(i), vector.tolist())
        port.upsert(str(i), vector.tolist())
    query = _vectors(rng, 1)[0].tolist()
    assert port.search(query, 4) == reference.search(query, 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_files_load_in_the_other_package(tmp_path, writer, metric):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "store" / "corpus")
    ref_writer = jax_vectorstore.VectorStore(DIMS, metric=metric, persist_path=path)
    port_writer = vectorstore.VectorStore(DIMS, metric=metric, persist_path=path, device="cpu")
    source = ref_writer if writer == "jax" else port_writer
    for i, vector in enumerate(_vectors(rng, 13)):
        source.upsert(f"id-{i}", vector.tolist(), {"title": f"t{i}", "tags": ["a", i]})
    source.delete("id-4")
    source.flush()
    with open(path + ".meta.json") as fh:
        assert json.load(fh)["metric"] == metric
    reference = jax_vectorstore.VectorStore(DIMS, metric=metric, persist_path=path)
    port = vectorstore.VectorStore(DIMS, metric=metric, persist_path=path, device="cpu")
    assert len(port) == len(reference) == 12
    assert port._ids == reference._ids and port._meta == reference._meta
    np.testing.assert_array_equal(port._matrix, reference._matrix)
    _assert_same(reference, port, _vectors(rng, 3).tolist())


def test_datasource_query_and_execute_match_jax():
    name = f"corpus-{uuid.uuid4().hex}"
    reference = jax_vectorstore.VectorStoreDataSource({"name": name, "dimensions": 4})
    port = vectorstore.VectorStoreDataSource({"name": name, "dimensions": 4}, device="cpu")
    assert port.store is vectorstore.shared_store(name, 4)  # one store per name
    upsert = json.dumps({"action": "upsert", "id": "?", "vector": "?", "metadata": {"text": "?"}})
    rows = [("a", [1.0, 0.0, 0.0, 0.0], "alpha"), ("b", [0.9, 0.1, 0.0, 0.0], "beta"),
            ("c", [0.0, 1.0, 0.0, 0.0], "gamma"), ("d", [1.0, 0.0, 0.0, 0.0], "delta")]
    for doc, vector, text in rows:
        params = [doc, vector, text]
        assert asyncio.run(port.execute(upsert, params)) == asyncio.run(
            reference.execute(upsert, params)) == {"rowcount": 1}
    delete = json.dumps({"action": "delete", "id": "?"})
    for doc in ("b", "zz"):
        assert asyncio.run(port.execute(delete, [doc])) == asyncio.run(reference.execute(delete, [doc]))
    search = json.dumps({"action": "search", "vector": "?", "top-k": 3})
    query = [[1.0, 0.05, 0.0, 0.0]]
    got = asyncio.run(port.query(search, query))
    want = asyncio.run(reference.query(search, query))
    assert [r["id"] for r in got] == [r["id"] for r in want] == ["a", "d", "c"]  # a, d tie
    assert [r["text"] for r in got] == ["alpha", "delta", "gamma"]
    np.testing.assert_allclose([r["similarity"] for r in got], [r["similarity"] for r in want],
                               rtol=0, atol=SCORE_TOLERANCE)
    with pytest.raises(ValueError, match="only supports 'search'"):
        asyncio.run(port.query(json.dumps({"action": "upsert"}), []))
    with pytest.raises(ValueError, match="unsupported vector action"):
        asyncio.run(port.execute(json.dumps({"action": "drop"}), []))


def test_substitute_matches_jax():
    from langstream_tpu.agents.datasource import _substitute as jax_substitute

    for query, params in (('{"id": "?", "v": ?}', ["x", [1, 2]]), ('{"a": "?"}', []),
                          ("literal ? mark", []), ('{"n": ?}', [3.5])):
        assert _substitute(query, params) == jax_substitute(query, params)
    with pytest.raises(ValueError, match="placeholders"):
        _substitute("? ?", [1])


def test_store_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vectorstore.VectorStore(DIMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vectorstore.VectorStoreDataSource({"name": f"n-{uuid.uuid4().hex}", "dimensions": 4})
    with pytest.raises(ValueError, match="unknown metric"):
        vectorstore.VectorStore(DIMS, metric="hamming", device="cpu")


def test_concurrent_upserts_deletes_and_searches_keep_the_store_consistent():
    """More threads than cores upsert, delete and search one store with a
    short switch interval: afterwards every id maps to its row, the host
    matrix holds each live id's vector, and a search's device copy equals
    the host matrix (no dirty row lost)."""
    import os
    import sys
    import threading

    port = vectorstore.VectorStore(DIMS, device="cpu")
    workers = (os.cpu_count() or 4) + 4
    vectors = _vectors(np.random.default_rng(9), 64)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)  # cosine stores them unit-norm
    errors = []

    def work(worker):
        rng = np.random.default_rng(worker)
        try:
            for _ in range(150):
                i = int(rng.integers(0, 64))
                action = rng.integers(0, 3)
                if action == 0:
                    port.upsert(f"v{i}", vectors[i])
                elif action == 1:
                    port.delete(f"v{i}")
                else:
                    port.search(vectors[i], 5)
        except Exception as error:  # noqa: BLE001 — reported by the assertion below
            errors.append(error)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(w,)) for w in range(workers)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert not errors, errors
    assert sorted(port._index.values()) == list(range(len(port)))
    for doc_id, row in port._index.items():
        assert port._ids[row] == doc_id
        np.testing.assert_allclose(port._matrix[row], vectors[int(doc_id[1:])], atol=1e-6)
    assert not port._matrix[len(port):].any()
    if len(port):
        port.search(vectors[0], 3)
        assert torch.equal(port._resident, torch.from_numpy(port._matrix))
