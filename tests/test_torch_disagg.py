"""Prefill/decode disaggregation in the port, held to the JAX package on the
CPU: the handoff wire schema (``fleet/handoff.py``), the paged manager's
import and export accounting, and the engine's export at finish and import
before admission.

Mirrors ``tests/test_disagg.py``'s handoff cases (``:55-145`` the schema,
``:278-325`` the manager, ``:570-693`` the real-engine round trip) on the
same tiny config (``LlamaConfig.tiny(max_seq_len=512)``, 4 slots, buckets
16-256, decode chunk 4, seed 11, blocks of 16) and sampling. A record set
made by either package decodes bit for bit in the other, for bf16, int8
and f32 leaves. In the round trip a prefill engine exports a 2-token
leg's chain, the records cross the port's ``HandoffAssembler``, and a
second engine imports them and replays the manifest: its stream equals,
token for token, the port's unified oracle and the JAX engine's stream
on the same converted weights, for int8 and model-dtype (f32) pools, in
split and mixed mode, greedy and seeded; a record set missing its last
chunk and a torn payload (``block_size`` 99) both replay cold with the
same stream. A JAX engine's exported records, imported by the port's
engine, give the JAX oracle's stream."""

import asyncio
import gc
import json

import numpy as np
import pytest
import torch

from langstream_tpu.fleet import handoff as jax_handoff
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local.paged import PagedKVManager as JaxPagedKVManager
from langstream_tpu_torch.fleet import handoff
from langstream_tpu_torch.fleet.handoff import (
    HandoffAssembler,
    handoff_records,
    manifest_for_request,
)
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.paged import PagedKVManager

torch.set_num_threads(2)

BS = 8
GREEDY = dict(max_new_tokens=12)
SEEDED = dict(
    max_new_tokens=12, temperature=0.9, top_k=8, top_p=0.9, seed=1234,
    presence_penalty=0.4, frequency_penalty=0.25,
)
SAMPLINGS = {"seeded": SEEDED, "greedy": GREEDY}
PROMPT = [(i * 7) % 250 + 1 for i in range(260)]  # 16 full blocks of 16
ENGINE_ARGS = dict(
    max_slots=4, max_seq_len=512, prefill_buckets=[16, 32, 64, 128, 256], decode_chunk=4,
    seed=11, kv_layout="paged", kv_block_size=16,
)


# ---------------------------------------------------------------------- #
# the wire schema: chunking, reassembly, orphan collection
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_handoff_records_are_bounded_and_roundtrip(dtype):
    layers, blocks, kvh, hd = 2, 6, 2, 4
    arrays = {
        "k": torch.arange(layers * blocks * BS * kvh * hd, dtype=torch.float32)
        .reshape(layers, blocks, BS, kvh, hd).to(dtype),
        "v": torch.ones((layers, blocks, BS, kvh, hd), dtype=dtype),
    }
    payload = {"tokens": list(range(blocks * BS)), "arrays": arrays, "block_size": BS,
               "kv_quant": False}
    manifest = manifest_for_request([1, 2, 3], [9], {"seed": 7}, session_id="s-1")
    per_block = sum(a.nbytes // blocks for a in arrays.values())
    records = handoff_records(payload, manifest, max_chunk_bytes=2 * per_block)
    # bounded: no chunk carries more than 2 blocks of array bytes
    assert len(records) == 3
    assert all(len(r["tokens"]) <= 2 * BS for r in records)
    assert records[0]["manifest"]["sampling"] == {"seed": 7}
    assert all("manifest" not in r for r in records[1:])
    asm = HandoffAssembler()
    out = None
    for record in reversed(records):  # any arrival order
        value = json.loads(json.dumps(record))  # the fabric's JSON round trip
        assert out is None
        out = asm.offer(value, now=1.0)
    assert out is not None
    assert out["manifest"]["session_id"] == "s-1"
    assert out["payload"]["tokens"] == payload["tokens"]
    for leaf in arrays:
        assert out["payload"]["arrays"][leaf].dtype == dtype
        assert torch.equal(out["payload"]["arrays"][leaf], arrays[leaf])
    assert asm.stats["handoffs_assembled"] == 1


def test_assembler_gcs_orphaned_chunks():
    asm = HandoffAssembler(orphan_timeout_s=5.0)
    record = {
        "kind": "kv_handoff", "handoff_id": "h-dead", "chunk": 0,
        "chunks": 3, "block_size": BS, "tokens": [1] * BS, "sim_bytes": 128,
    }
    assert asm.offer(record, now=0.0) is None
    assert asm.pending_ids() == ["h-dead"]
    assert asm.gc(now=4.0) == []          # still inside the window
    assert asm.gc(now=5.0) == ["h-dead"]  # the prefill replica died
    assert asm.pending_ids() == []
    assert asm.stats["handoffs_orphaned"] == 1
    # a straggler chunk for the collected id pends again, then is
    # collected again: a torn handoff never assembles
    assert asm.offer(dict(record, chunk=1), now=6.0) is None
    assert asm.gc(now=60.0) == ["h-dead"]
    assert asm.gauges()["fleet_handoffs_orphaned_total"] == 2.0


def test_assembler_drops_mixed_schema_and_duplicate_chunks():
    asm = HandoffAssembler()
    head = {
        "kind": "kv_handoff", "handoff_id": "h-mixed", "chunk": 0,
        "chunks": 2, "block_size": BS, "tokens": [1] * BS,
        "arrays": {"k": {"dtype": "float32", "shape": [1, 1, BS], "data": "not-base64!!"}},
    }
    assert asm.offer(head, now=0.0) is None
    # an at-least-once fabric redelivers chunk 0: its bytes count once
    bytes_after_first = asm.stats["bytes_received"]
    assert asm.offer(dict(head), now=0.5) is None
    assert asm.stats["bytes_received"] == bytes_after_first
    # the final chunk completes a torn set (bad base64, a leaf missing):
    # dropped and counted, never raised out of the consumer loop
    tail = dict(head, chunk=1)
    tail.pop("arrays")
    assert asm.offer(tail, now=1.0) is None
    assert asm.stats["handoffs_orphaned"] == 1
    assert asm.pending_ids() == []
    # malformed records are ignored outright
    for bad in ({"kind": "heartbeat"}, dict(head, chunk=5), dict(head, handoff_id=3), "x"):
        assert asm.offer(bad, now=2.0) is None
    assert asm.pending_ids() == []


def _leaves(seed=3):
    """bf16, int8 and f32 pool leaves (JAX's ml_dtypes bf16 for the JAX
    side), from one numpy draw."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    shape = (2, 5, BS, 2, 4)
    k32 = rng.standard_normal(shape).astype(np.float32)
    return {
        "k": k32.astype(ml_dtypes.bfloat16),
        "v": rng.integers(-128, 128, shape, dtype=np.int8),
        "k_scale": rng.random(shape[:-1]).astype(np.float32),
    }


def _bits(array):
    """The raw bytes of a leaf, numpy or torch."""
    if isinstance(array, torch.Tensor):
        return array.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(array).tobytes()


def test_records_decode_bitwise_across_packages():
    """A record set made by the JAX package assembles in the port bit for
    bit (bf16 as torch.bfloat16), and one made by the port from torch
    tensors decodes in JAX's ``_decode_array`` and assembles in JAX's
    ``HandoffAssembler`` bit for bit, chunk boundaries and all."""
    leaves = _leaves()
    payload = {"tokens": list(range(5 * BS)), "arrays": leaves, "block_size": BS,
               "kv_quant": True}
    per_block = sum(a.nbytes // 5 for a in leaves.values())
    manifest = jax_handoff.manifest_for_request([1], [2], {"seed": 1})
    # JAX -> port
    jax_records = jax_handoff.handoff_records(payload, manifest, max_chunk_bytes=2 * per_block)
    assert len(jax_records) == 3
    assembled = None
    asm = HandoffAssembler()
    for record in json.loads(json.dumps(jax_records)):
        assembled = asm.offer(record, 0.0) or assembled
    got = assembled["payload"]["arrays"]
    assert got["k"].dtype == torch.bfloat16 and got["v"].dtype == torch.int8
    assert got["k_scale"].dtype == torch.float32
    for leaf, array in leaves.items():
        assert tuple(got[leaf].shape) == array.shape
        assert _bits(got[leaf]) == _bits(array), leaf
    # port -> JAX, from torch tensors
    tensors = {leaf: handoff.as_tensor(array) for leaf, array in leaves.items()}
    assert tensors["k"].dtype == torch.bfloat16
    port_payload = dict(payload, arrays=tensors)
    assert handoff.payload_nbytes(port_payload) == jax_handoff.payload_nbytes(payload)
    port_records = json.loads(json.dumps(handoff_records(
        port_payload, manifest, max_chunk_bytes=2 * per_block)))
    assert [r["arrays"]["k"]["dtype"] for r in port_records] == ["bfloat16"] * 3
    for mine, theirs in zip(port_records, jax_records):
        assert mine["tokens"] == theirs["tokens"]
        for leaf in leaves:
            decoded = jax_handoff._decode_array(mine["arrays"][leaf])
            assert decoded.dtype == np.asarray(leaves[leaf]).dtype
            assert _bits(decoded) == _bits(jax_handoff._decode_array(theirs["arrays"][leaf]))
    jax_asm = jax_handoff.HandoffAssembler()
    jax_out = None
    for record in port_records:
        jax_out = jax_asm.offer(record, 0.0) or jax_out
    for leaf, array in leaves.items():
        assert _bits(jax_out["payload"]["arrays"][leaf]) == _bits(array), leaf


# ---------------------------------------------------------------------- #
# manager import accounting, both managers on the same sequence
# ---------------------------------------------------------------------- #
def _both(num_blocks):
    return PagedKVManager(num_blocks=num_blocks, block_size=BS), JaxPagedKVManager(
        num_blocks=num_blocks, block_size=BS)


def test_manager_import_reserve_commit_abort():
    """``import_session`` reserves, ``commit_import`` publishes and
    ``abort_import`` unwinds, with the same block ids, refcounts and
    stats from the port's manager and JAX's."""
    seen = []
    for manager in _both(16):
        tokens = list(range(3 * BS))
        chain, fresh = manager.import_session(tokens)
        assert chain == [] and len(fresh) == 3
        # reserved and uncommitted: refcount-held and unpublished
        assert manager.match(tokens) == ([], 0)
        assert all(manager.refcount(b) == 1 for b in fresh)
        manager.commit_import(tokens, chain + fresh)
        found, matched = manager.match(tokens)
        assert found == fresh and matched == 3 * BS
        assert all(manager.refcount(b) == 0 for b in fresh)  # cache-held
        # abort: a torn import frees its reservation entirely
        other = [t + 1000 for t in tokens]
        chain2, fresh2 = manager.import_session(other)
        free_before = manager.num_blocks - 1 - manager.blocks_in_use
        manager.abort_import(chain2 + fresh2)
        assert manager.num_blocks - 1 - manager.blocks_in_use == free_before + len(fresh2)
        assert manager.match(other) == ([], 0)
        # a resident prefix shrinks the reservation to the tail
        longer = tokens + [7] * BS
        chain3, fresh3 = manager.import_session(longer)
        assert chain3 == fresh and len(fresh3) == 1
        manager.abort_import(chain3 + fresh3)
        # a pool that cannot cover the import refuses it whole
        assert manager.import_session([t + 2000 for t in range(16 * BS)]) is None
        seen.append((fresh, fresh2, fresh3, manager.blocks_in_use, dict(manager.stats)))
    assert seen[0] == seen[1]


def test_manager_export_session_pins_against_eviction():
    seen = []
    for manager in _both(8):
        tokens = list(range(2 * BS))
        blocks = manager.allocate(2)
        manager.publish(tokens, blocks)
        manager.release(blocks)
        chain, matched = manager.export_session(tokens)
        assert chain == blocks and matched == 2 * BS
        # the export ref survives allocation pressure until released
        assert manager.allocate(7) is None
        manager.release(chain)
        taken = manager.allocate(7)
        assert taken is not None
        seen.append((blocks, taken, dict(manager.stats)))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------- #
# real engines: export -> records -> import -> replay
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def weights():
    jcfg = jax_model.LlamaConfig.tiny(max_seq_len=512)
    tcfg = model.LlamaConfig.tiny(max_seq_len=512)
    jparams = jax_model.init_params(jcfg)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)
    return jcfg, jparams, tcfg, tparams


def _run(eng, prompt, sampling, **kw):
    lib = jax_engine if isinstance(eng, jax_engine.DecodeEngine) else engine

    async def main():
        return await eng.generate(list(prompt), lib.SamplingParams(**sampling), **kw)

    return asyncio.run(main())


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine, built as ``tests/test_disagg.py`` builds it: its
    stream of PROMPT for each sampling, per pool type, and (int8 pool) the
    records of its own exported 2-token leg. Made on first use and kept."""
    jcfg, jparams, _, _ = weights
    made = {}

    def get(kv_quant):
        if kv_quant not in made:
            quant_kw = dict(kv_quant=kv_quant) if kv_quant else {}
            eng = jax_engine.DecodeEngine(jcfg, jparams, **ENGINE_ARGS, **quant_kw)
            eng.start()
            try:
                streams = {name: _run(eng, PROMPT, sampling).tokens
                           for name, sampling in SAMPLINGS.items()}
                records = None
                if kv_quant:
                    leg = _run(eng, PROMPT, dict(SEEDED, max_new_tokens=2),
                               request_fields={"export_handoff": True})
                    assert leg.tokens == streams["seeded"][:2]
                    records = jax_handoff.handoff_records(
                        leg.kv_handoff,
                        jax_handoff.manifest_for_request(PROMPT, leg.tokens, dict(SEEDED)),
                        max_chunk_bytes=16 * 1024)
            finally:
                eng.stop()
            made[kv_quant] = streams, json.loads(json.dumps(records))
        return made[kv_quant]

    return get


def _port_engine(weights, **overrides):
    _, _, tcfg, tparams = weights
    return engine.DecodeEngine(tcfg, tparams, device="cpu", **dict(ENGINE_ARGS, **overrides))


def _assemble(records):
    asm = HandoffAssembler()
    assembled = None
    for record in records:
        assembled = asm.offer(record, now=0.0) or assembled
    assert assembled is not None
    return assembled


def _replay(eng, assembled, **fields):
    """The decode leg: the manifest's prompt plus every sampled token but
    the last, teacher-forced from the replay, over the imported chain."""
    manifest = assembled["manifest"]
    replay = list(manifest["generated"])
    return _run(eng, manifest["prompt_tokens"] + replay[:-1], manifest["sampling"],
                request_fields=dict(replay_tokens=replay,
                                    prompt_len=len(manifest["prompt_tokens"]), **fields))


@pytest.mark.parametrize("kv_quant,mode", [("int8", "split"), (None, "split"), ("int8", "mixed")],
                         ids=["int8-split", "f32-split", "int8-mixed"])
def test_handoff_round_trip_matches_unified_oracle_and_jax(weights, jax_streams, kv_quant, mode):
    mode_kw = dict(prefill_mode="mixed", prefill_chunk=64) if mode == "mixed" else {}
    quant_kw = dict(kv_quant=kv_quant) if kv_quant else {}
    jax_want, _ = jax_streams(kv_quant)
    engine_a = _port_engine(weights, **quant_kw, **mode_kw)
    engine_b = _port_engine(weights, **quant_kw, **mode_kw)
    gc.collect()
    base = engine.engines_snapshot()
    try:
        for name, sampling in SAMPLINGS.items():
            expected = _run(engine_a, PROMPT, sampling)
            assert expected.tokens == jax_want[name], name
            # the prefill leg: 2 tokens, so every full block of the prompt
            # is in the published chain
            leg = _run(engine_a, PROMPT, dict(sampling, max_new_tokens=2),
                       request_fields={"export_handoff": True})
            assert leg.tokens == expected.tokens[:2]
            payload = leg.kv_handoff
            assert payload["kv_quant"] is bool(kv_quant)
            assert set(payload["arrays"]) == set(engine_a.cache)
            layers = engine_a.config.num_layers
            for leaf, rows in payload["arrays"].items():
                assert tuple(rows.shape) == (layers, 16, *engine_a.cache[leaf].shape[2:])
                assert rows.device.type == "cpu"
            records = handoff_records(
                payload, manifest_for_request(PROMPT, leg.tokens, dict(sampling)),
                max_chunk_bytes=16 * 1024)
            assert len(records) >= 2  # bounded chunks, not one blob
            assembled = _assemble(json.loads(json.dumps(records)))
            hits_before = engine_b.kv_manager.stats["hit_tokens"]
            result = _replay(engine_b, assembled, kv_import=assembled["payload"])
            # the decode replica's stream is the unified oracle's, and JAX's
            assert result.tokens == expected.tokens
            assert result.finish_reason == expected.finish_reason
            assert result.prompt_tokens == len(PROMPT)
            # with every full block of the prompt served from the import
            assert engine_b.kv_manager.stats["hit_tokens"] - hits_before >= 256
        assert engine_a.stats["handoff_exports"] == 2
        assert engine_b.stats["handoff_imports"] == 2
        assert engine_b.stats["handoff_import_tokens"] == 2 * 256
        assert engine_b.stats["tokens_wasted"].get("handoff_aborted", 0) == 0
        snap = engine.engines_snapshot()
        assert snap["kv_handoff_imports_total"] - base["kv_handoff_imports_total"] == 2.0
        assert snap["kv_handoff_imported_tokens_total"] - base[
            "kv_handoff_imported_tokens_total"] == 512.0
        assert snap["kv_handoff_exports_total"] - base["kv_handoff_exports_total"] == 2.0
        assert snap["kv_handoff_exported_bytes_total"] - base[
            "kv_handoff_exported_bytes_total"] == engine_a.stats["handoff_export_bytes"]
        # the prefill replica dies mid-handoff: the last chunk never comes,
        # the assembler collects the rest, and the replay prefills cold
        expected = _run(engine_a, PROMPT, SEEDED)
        leg = _run(engine_a, PROMPT, dict(SEEDED, max_new_tokens=2),
                   request_fields={"export_handoff": True})
        torn = HandoffAssembler(orphan_timeout_s=1.0)
        records = handoff_records(leg.kv_handoff,
                                  manifest_for_request(PROMPT, leg.tokens, dict(SEEDED)),
                                  max_chunk_bytes=16 * 1024)
        for record in records[:-1]:
            assert torn.offer(record, now=0.0) is None
        assert torn.gc(now=2.0)
        replay = list(leg.tokens)
        result = _run(engine_b, PROMPT + replay[:-1], SEEDED,
                      request_fields={"replay_tokens": replay, "prompt_len": len(PROMPT)})
        assert result.tokens == expected.tokens == jax_want["seeded"]
        # a torn payload that reaches the engine aborts cleanly: nothing
        # published, billed to the waste ledger, the stream the same
        bad = dict(leg.kv_handoff, block_size=99)
        expected = _run(engine_a, PROMPT, GREEDY)
        imports = engine_b.stats["handoff_imports"]
        result = _run(engine_b, PROMPT + expected.tokens[:1], GREEDY, request_fields={
            "kv_import": bad, "replay_tokens": expected.tokens[:2], "prompt_len": len(PROMPT)})
        assert result.tokens == expected.tokens == jax_want["greedy"]
        assert engine_b.stats["tokens_wasted"]["handoff_aborted"] == 256
        assert engine_b.stats["handoff_imports"] == imports
        snap = engine.engines_snapshot()
        assert snap['torch_engine_tokens_wasted_total{reason="handoff_aborted"}'] >= 256
    finally:
        engine_a.stop()
        engine_b.stop()


def test_import_aborts_on_shape_and_pool(weights):
    """The other abort reasons: a payload whose leaves have another shape
    (``shape_mismatch``) and a pool that cannot hold the import
    (``pool_exhausted``) both bill ``handoff_aborted`` and leave the
    pool's accounting as it was."""
    eng = _port_engine(weights, kv_quant="int8", kv_blocks=40)
    try:
        layers = eng.config.num_layers
        arrays = {leaf: torch.zeros((layers, 16, *value.shape[2:]), dtype=value.dtype)
                  for leaf, value in eng.cache.items()}
        payload = {"tokens": PROMPT[:256], "arrays": arrays, "block_size": 16, "kv_quant": True}
        wrong = dict(payload, arrays=dict(arrays, k=arrays["k"][:, :15]))
        assert not eng._import_handoff(wrong)
        assert not eng._import_handoff(dict(payload, kv_quant=False))
        assert eng.stats["tokens_wasted"]["handoff_aborted"] == 512
        in_use = eng.kv_manager.blocks_in_use
        held = eng.kv_manager.allocate(30)  # 9 of 39 blocks left: too few for 16
        assert not eng._import_handoff(payload)
        assert eng.stats["tokens_wasted"]["handoff_aborted"] == 768
        eng.kv_manager.release(held)
        assert eng.kv_manager.blocks_in_use == in_use
        assert eng.kv_manager.match(PROMPT) == ([], 0)
        assert eng._import_handoff(payload)
        assert eng.kv_manager.match(PROMPT)[1] == 256
    finally:
        eng.stop()


def test_jax_exported_records_import_into_the_port(weights, jax_streams):
    """Across packages: the JAX engine's exported records (int8 pool),
    assembled and imported by the port's engine, replay to the JAX
    oracle's stream with the whole prompt's blocks served from the
    import."""
    jax_want, records = jax_streams("int8")
    eng = _port_engine(weights, kv_quant="int8")
    try:
        assembled = _assemble(records)
        assert assembled["payload"]["arrays"]["k"].dtype == torch.int8
        result = _replay(eng, assembled, kv_import=assembled["payload"])
        assert result.tokens == jax_want["seeded"]
        assert eng.stats["handoff_imports"] == 1
        assert eng.kv_manager.stats["hit_tokens"] >= 256
        assert eng.stats["tokens_wasted"].get("handoff_aborted", 0) == 0
    finally:
        eng.stop()


@pytest.mark.parametrize("overrides", [dict(kv_layout="dense"), dict(prefix_cache=False)],
                         ids=["dense", "no-prefix-cache"])
def test_import_without_a_prefix_cache_is_counted(weights, overrides):
    """An engine with no prefix cache to import into (the dense layout, or
    ``prefix_cache`` off) leaves the payload alone and bills nothing, as
    the JAX engine does (its ``_import_pending_handoffs`` returns before
    its loop), so the two packages' ``/metrics`` agree; the replay
    prefills cold with the same stream."""
    jcfg, jparams, _, _ = weights
    counts = {}
    for package in ("port", "jax"):
        eng = (_port_engine(weights, **overrides) if package == "port" else
               jax_engine.DecodeEngine(jcfg, jparams, **dict(ENGINE_ARGS, **overrides)))
        try:
            layers = jcfg.num_layers
            arrays = {leaf: np.zeros((layers, 16, 16, *value.shape[3:]), dtype=np.float32)
                      for leaf, value in eng.cache.items()}
            payload = {"tokens": PROMPT[:256], "arrays": arrays, "block_size": 16, "kv_quant": False}
            want = _run(eng, PROMPT, GREEDY)
            fields = {"replay_tokens": want.tokens[:2], "prompt_len": len(PROMPT)}
            got = _run(eng, PROMPT + want.tokens[:1], GREEDY,
                       request_fields=dict(fields, kv_import=payload))
            assert got.tokens == want.tokens
            counts[package] = (eng.stats["tokens_wasted"].get("handoff_aborted", 0),
                               eng.stats["handoff_imports"])
        finally:
            eng.stop()
    assert counts["port"] == counts["jax"] == (0, 0)
