"""The port's dispatch mirror (``serving/mirror.py``) against the JAX
package's, on the CPU:

- the frames: a record the port encodes is byte for byte the JAX
  ``_encode_record``'s, and each side decodes the other's over a socket;
- ``config_fingerprint`` equal to JAX's, and the provider's
  ``mirror_fingerprint`` equal to the JAX serve's ``_mirror_fingerprint``
  (the SLO targets and the watchdog scrubbed);
- a follower in a child process (``tests/torch_tp_worker.py``, started
  with ``parallel.launch``) replaying a one-card leader's stream, as
  ``tests/test_mirror_twoproc.py`` does for the JAX engine: concurrent
  greedy, seeded and penalized requests over a shared template, a
  session follow-up and a long chained generation, dense and paged, f32
  and int8 KV; the follower's cache and penalty counts equal to the
  leader's bit for bit, its token digest equal, every published record
  replayed, the record kinds those of this slice;
- the handshake: a follower with another config's fingerprint rejected
  while a matching one joins, and the leader blocking (with a time limit)
  until its followers join;
- what a mirror across hosts refuses, as the JAX engine's multi-host
  mirror does: speculative decoding at dispatch, session resurrection at
  submit, a handoff import aborted with reason ``mirror``, host-tier
  demotion skipped, the supervisor off; the mixed step replays (a
  follower replaying a one-card leader's mixed steps and their carry).
"""

import asyncio
import json
import pathlib
import socket
import threading

import numpy as np
import pytest
import torch

from langstream_tpu.cli.services import _mirror_fingerprint as jax_mirror_fingerprint
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.serving import mirror as jax_mirror
from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.providers.torch_local import engine as engine_lib
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.provider import mirror_fingerprint
from langstream_tpu_torch.runtime.multihost import free_port
from langstream_tpu_torch.serving import mirror
import torch_tp_worker as worker

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]

RECORDS = [
    ("prefill", {"size": 32, "tier": "", "group": 2, "names": ["lengths", "slot_ids", "tokens"]},
     [np.array([5, 9], np.int32), np.array([0, 3], np.int64),
      np.arange(64, dtype=np.int64).reshape(2, 32)]),
    ("first_token", {"size": 0, "tier": "plain", "group": 1, "names": ["temperature", "top_p"]},
     [np.array([0.7], np.float32), np.array([0.9], np.float32)]),
    ("decode", {"size": 4, "tier": "greedy", "group": 0, "names": ["active", "tables"]},
     [np.array([True, False, True]), np.arange(12, dtype=np.int32).reshape(3, 4)]),
    ("copy", {"bucket": 64}, [np.asarray(3, np.int32), np.asarray(1, np.int32),
                              np.asarray(0.5, np.float64), np.array([7], np.uint32)]),
    ("decode_chained", {"size": 4, "tier": "greedy"}, []),
    ("stop", {}, []),
]


@pytest.mark.parametrize("kind,meta,arrays", RECORDS, ids=[kind for kind, _, _ in RECORDS])
def test_frames_are_jax_frames(kind, meta, arrays):
    """Byte for byte JAX's encoding; the port decodes a JAX-sent frame and
    JAX a port-sent one, arrays bit for bit (0-d scalars stay 0-d)."""
    frame = mirror._encode_record(kind, meta, arrays)
    assert frame == jax_mirror._encode_record(kind, meta, arrays)
    for send, recv in ((jax_mirror._send_record, mirror._recv_record),
                       (mirror._send_record, jax_mirror._recv_record)):
        left, right = socket.socketpair()
        try:
            send(left, frame)
            got_kind, got_meta, got_arrays = recv(right)
        finally:
            left.close()
            right.close()
        assert (got_kind, got_meta) == (kind, meta)
        for got, want in zip(got_arrays, arrays):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_disallowed_dtype_refused():
    frame = mirror._encode_record("prefill", {}, [np.zeros(2, np.int8)])
    left, right = socket.socketpair()
    try:
        mirror._send_record(left, frame)
        with pytest.raises(ValueError, match="disallowed dtype"):
            mirror._recv_record(right)
    finally:
        left.close()
        right.close()


CONFIGS = [
    {"model": {"preset": "tiny"}},
    {"model": {"preset": "llama-3-8b", "max_seq_len": 2048}, "mesh": {"tp": 2},
     "engine": {"max-slots": 8, "kv-layout": "paged", "watchdog": True, "supervisor": False},
     "slo": {"ttft-ms-p95": 200}},
    {"model": {}, "checkpoint": "/models/x", "quantization": "int8",
     "engine": {"watchdog": {"interval": 1.0}, "prefill-buckets": [64, 128]}},
]


@pytest.mark.parametrize("config", CONFIGS, ids=["tiny", "tp2-slo-watchdog", "checkpoint"])
def test_fingerprints_match_jax(config):
    assert mirror.config_fingerprint(config) == jax_mirror.config_fingerprint(config)
    assert mirror_fingerprint(config) == jax_mirror_fingerprint(config)
    scrubbed = dict(config, slo={"tpot-ms-p95": 1})
    scrubbed["engine"] = dict(config.get("engine", {}), watchdog="off")
    assert mirror_fingerprint(scrubbed) == mirror_fingerprint(config)
    assert mirror_fingerprint(dict(config, seed=9)) != mirror_fingerprint(config)


def _traffic():
    """(prompt, sampling, session) requests, submitted together: a shared
    template (prefix reuse), greedy, seeded and penalized rows, a long
    generation whose chunks chain, a session turn."""
    template = [(17 * j) % 250 + 1 for j in range(24)]
    sp = engine_lib.SamplingParams
    return [
        (template + [3, 4, 5], sp(max_new_tokens=10), "s1"),
        (template + [9, 8], sp(max_new_tokens=8, temperature=0.9, seed=3), None),
        (list(range(40, 60)), sp(max_new_tokens=28), None),
        (template[:20] + [77], sp(max_new_tokens=6, temperature=0.7, top_k=5, seed=1,
                                  presence_penalty=0.5, frequency_penalty=0.3), None),
    ]


async def _drive(engine):
    first = await asyncio.gather(*(engine.generate(prompt, sampling, session_id=session)
                                   for prompt, sampling, session in _traffic()))
    # the session's next turn extends its history; then a cold request
    # sharing the template's prefix
    turn = list(_traffic()[0][0]) + list(first[0].tokens) + [11, 12]
    second = await engine.generate(turn, engine_lib.SamplingParams(max_new_tokens=5), session_id="s1")
    third = await engine.generate(_traffic()[0][0][:16] + [200, 201, 202],
                                  engine_lib.SamplingParams(max_new_tokens=5))
    return [list(r.tokens) for r in (*first, second, third)]


@pytest.mark.parametrize("layout,kv_quant", [("dense", False), ("dense", True), ("paged", False),
                                             ("paged", True), ("mixed", True)],
                         ids=["dense", "dense-int8kv", "paged", "paged-int8kv", "mixed-int8kv"])
def test_follower_process_replays_to_the_leaders_cache_and_tokens(tmp_path, layout, kv_quant):
    """The mixed case runs the mixed step with its carry over a mirror
    across hosts (the default scope), as the JAX mirror replays it."""
    config = worker.preset("tiny", max_seq_len=128)
    jparams = jax_model.init_params(jax_model.LlamaConfig.tiny(), seed=3)
    params_path = str(tmp_path / "tiny.npz")
    np.savez(params_path, **{k: np.asarray(v) for k, v in jparams.items()})
    fingerprint = mirror.config_fingerprint({"case": layout, "kv_quant": kv_quant})
    leader = engine_lib.DecodeEngine(config, worker.load_params(params_path, config, False),
                                     device="cpu", kv_quant="int8" if kv_quant else None,
                                     **worker.layout_args(layout), **worker.ENGINE_ARGS)
    dispatch = mirror.DispatchMirror(host="127.0.0.1", port=0, fingerprint=fingerprint)
    kinds = []
    publish = dispatch.publish

    def logged(kind, meta, arrays):
        kinds.append(kind)
        publish(kind, meta, arrays)

    dispatch.publish = logged
    out = str(tmp_path / "follower")
    children = launch.spawn_ranks(
        "torch_tp_worker:replay_follower",
        {"preset": "tiny", "params": params_path, "layout": layout, "kv_quant": kv_quant,
         "port": dispatch.port, "fingerprint": fingerprint.hex(), "out": out},
        ["cpu"], f"127.0.0.1:{free_port()}", timeout_s=120, ranks=[0], path=[str(REPO / "tests")],
        cwd=str(REPO))
    try:
        dispatch.wait_for_followers(1, timeout=120)
        leader.mirror = dispatch
        leader.start()
        try:
            streams = asyncio.run(_drive(leader))
        finally:
            leader.stop()
        assert launch.stop_ranks(children, timeout_s=120) == [0]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
    report = json.load(open(out + ".json"))
    saved = np.load(out + ".npz")
    assert report["records"] == dispatch.published - 1 == len(kinds) - 1
    assert report["digest"] == dispatch.digest.hexdigest()
    if layout == "mixed":
        assert set(kinds) <= {"mixed", "mixed_chained", "decode", "decode_chained", "block_copy",
                              "stop"}
        assert {"mixed", "mixed_chained", "decode"} <= set(kinds)
        assert leader.stats["mixed_steps_chained"] > 0
    else:
        assert set(kinds) <= {"prefill", "prefill_offset", "first_token", "decode",
                              "decode_chained", "copy", "block_copy", "stop"}
        assert {"prefill", "first_token", "decode", "decode_chained"} <= set(kinds)
    assert ("copy" if layout == "dense" else "block_copy") in kinds or \
        leader.stats["prefix_hits"] + leader.stats["session_hits"] > 0
    np.testing.assert_array_equal(saved["counts"], leader._counts.numpy())
    for leaf, value in leader.cache.items():
        np.testing.assert_array_equal(saved[leaf], value.numpy(), err_msg=leaf)
    assert [len(s) for s in streams] == [10, 8, 28, 6, 5, 5]


def test_a_follower_that_dies_fails_the_leader_within_its_time_limit(tmp_path):
    """tp=2 over two gloo processes, the follower dying at its 4th record
    (the ``mirror_follower`` fault point): the leader's request fails
    (its next collective finds the peer gone) well inside the ranks' time
    limit instead of hanging, and the follower's process exits non-zero."""
    jparams = jax_model.init_params(jax_model.LlamaConfig.tiny(), seed=3)
    params_path = str(tmp_path / "tiny.npz")
    np.savez(params_path, **{k: np.asarray(v) for k, v in jparams.items()})
    out = str(tmp_path / "leader")
    children = launch.spawn_ranks(
        "torch_tp_worker:follower_dies", {"params": params_path, "out": out}, ["cpu", "cpu"],
        f"127.0.0.1:{free_port()}", timeout_s=120, ranks=range(2), path=[str(REPO / "tests")],
        cwd=str(REPO))
    try:
        codes = launch.stop_ranks(children, timeout_s=150)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
    outcome = json.load(open(out + ".json"))
    assert codes[0] == 0 and codes[1] != 0, codes
    assert outcome["outcome"] != "answered" and outcome["seconds"] < 60, outcome


def test_handshake_rejects_another_config_and_waits_for_followers():
    """A follower whose fingerprint differs is closed at the handshake
    while one with the leader's joins; with none coming, the wait ends at
    its time limit."""
    ours, theirs = mirror.config_fingerprint({"a": 1}), mirror.config_fingerprint({"a": 2})
    lonely = mirror.DispatchMirror(host="127.0.0.1", port=0, fingerprint=ours)
    with pytest.raises(TimeoutError):
        lonely.wait_for_followers(1, timeout=0.5)
    lonely.close()
    dispatch = mirror.DispatchMirror(host="127.0.0.1", port=0, fingerprint=ours)
    stranger = socket.create_connection(("127.0.0.1", dispatch.port))
    stranger.sendall(mirror._MAGIC + theirs)
    friend = mirror.FollowerExecutor(engine=None)

    def join():
        friend.connect("127.0.0.1", dispatch.port, timeout=10, fingerprint=ours)

    joiner = threading.Timer(0.3, join)
    joiner.start()
    try:
        dispatch.wait_for_followers(1, timeout=10)
        joiner.join()
        assert dispatch.followers == 1
        stranger.settimeout(5)
        assert stranger.recv(1) == b""  # closed by the leader
        dispatch.publish("stop", {}, [])
        assert friend.run() == 0
    finally:
        stranger.close()
        dispatch.close()


def test_what_the_mirror_refuses():
    """Across hosts (the default scope, ``serve --followers``) the engine
    keeps the JAX engine's multi-host refusals: speculative decoding at
    dispatch, session resurrection at submit, a handoff import aborted
    with reason ``mirror``, host-tier demotion skipped, and the serve
    turns the supervisor off and refuses spec decode. The mixed step and a
    handoff export pass (the JAX mirror replays one, the JAX engine
    gathers the other). On one host (``local``) none of these is
    refused."""
    from langstream_tpu_torch.cli.main import build_parser, serve_config

    config = model.LlamaConfig.tiny(max_seq_len=128)
    params = model.init_params(config, seed=1)
    args = dict(device="cpu", max_slots=2, max_seq_len=128, prefill_buckets=[16, 32])
    across = mirror.DispatchMirror(host="127.0.0.1", port=0)
    local = mirror.DispatchMirror(host="127.0.0.1", port=0, local=True)
    assert not across.local and local.local
    try:
        spec = engine_lib.DecodeEngine(config, params, spec_decode="ngram", **args)
        spec.mirror = across
        with pytest.raises(NotImplementedError, match="multi-host.*spec_decode"):
            spec._check_mirror_layout()
        spec.mirror = local
        spec._check_mirror_layout()
        mixed = engine_lib.DecodeEngine(config, params, kv_layout="paged", prefill_mode="mixed",
                                        kv_block_size=8, **args)
        mixed.mirror = across
        mixed._check_mirror_layout()
        paged = engine_lib.DecodeEngine(config, params, kv_layout="paged", kv_block_size=8,
                                        kv_host_blocks=4, **args)
        paged.mirror = across
        sampling = engine_lib.SamplingParams(max_new_tokens=2)
        with pytest.raises(NotImplementedError, match="resurrection"):
            paged.submit(engine_lib.GenerationRequest([1, 2, 3], sampling, replay_tokens=[4]))
        payload = {"tokens": list(range(16)), "block_size": 8, "arrays": {}, "kv_quant": False}
        assert paged._import_handoff(payload) is False
        assert paged.stats["tokens_wasted"]["handoff_aborted"] == 16
        assert paged._demote_block_data(1) is None and paged.stats["host_demotions"] == 0
        assert spec.stats["step_functions"] == "eager"  # graphs are a card thing
        # one host: the demotion copies the block out (the record goes out
        # when the arena takes it)
        paged.mirror = local
        data, nbytes = paged._demote_block_data(1)
        assert set(data) == set(paged.cache) and paged.stats["host_demotions"] == 1
        followers = serve_config(build_parser().parse_args(["serve", "--tp", "2", "--followers", "1"]))
        assert followers["engine"]["supervisor"] is False
        assert serve_config(build_parser().parse_args(["serve", "--tp", "2"]))["engine"]["supervisor"]
        from langstream_tpu_torch.cli.main import _refuse_spec_under_mirror

        followers["engine"]["spec-decode"] = "ngram"
        with pytest.raises(SystemExit, match="multi-host"):
            _refuse_spec_under_mirror(followers)
    finally:
        across.close()
        local.close()
