"""``serve --tp`` on one host takes what the JAX engine takes on one
host's mesh: the port's two gloo ranks against the JAX engine at
``MeshConfig(tp=2)`` and the port's tp=1 engine, on the CPU.

One two-rank spawn (``tests/torch_tp_worker.py``'s ``tp_features``) runs
every case in turn, each a provider service per rank built from the
case's config (``tiny`` at 128 tokens, random weights from seed 0), rank
0 with a one-host dispatch mirror and the supervisor on, rank 1 running
``cli.main.follow``; the references are computed here meanwhile, over
the same weights carried to JAX:

- the mixed step (paged, chunk 16, pipelined with its carry): greedy and
  seeded streams of three prompts admitted together equal the JAX mixed
  engine's at tp=2 and the port's split engine's at tp=1, and the
  follower replayed ``mixed_chained`` records;
- spec decode (``ngram``, dense and paged): greedy streams equal the
  port's spec-off engine's and the JAX spec engine's at tp=2, drafts
  were accepted and the follower chained ``spec_chained`` records;
- a KV handoff: a tp=2 export within 1e-4 of the JAX engine's tp=2
  export, imported by a port tp=1 engine; a tp=1 export imported at
  tp=2; both decode legs equal to the un-handed-off run;
- the host tier: a chain demoted under pressure and promoted back gives
  the never-evicting engine's streams, and the follower's tier, which
  drops what rank 0's arena evicts, holds as many blocks as the arena;
- ``engine_thread_crash@step=5`` on a mixed engine: the supervisor heals
  it once under tp (release and rebuild replayed), resurrects the live
  sessions, and the resumed streams equal the uncrashed oracles (the
  port's tp=1 engine and the JAX engine at tp=2), as
  ``tests/test_torch_recovery.py`` holds them.

In every case the follower's token digest equals the leader's and it
replayed every record the leader published. Streams are held token for
token, logprobs within 1e-4 (tp=2 sums its row-sharded products as f32
partials).
"""

import asyncio
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.providers.torch_local import engine, model
from langstream_tpu_torch.runtime.multihost import free_port
import torch_tp_worker as worker

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TP = 2
LOGPROB_TOLERANCE = 1e-4
PAYLOAD_TOLERANCE = 1e-4
RANK_TIMEOUT_S = 240

GREEDY = dict(max_new_tokens=12)
SEEDED = dict(max_new_tokens=12, temperature=0.9, top_k=8, top_p=0.9, seed=1234,
              presence_penalty=0.4, frequency_penalty=0.25)
PAGED = {"kv-layout": "paged", "kv-block-size": 8}
MIXED = dict(PAGED, **{"prefill-mode": "mixed", "prefill-chunk": 16, "pipeline-decode": True})


def _repetitive(n):
    return (list(range(1, 9)) * 8)[:n]


# the prompt rank 0 exports, and the one a tp=1 engine exports for it
EXPORTED = [(7 * j) % 200 + 3 for j in range(40)]
IMPORTED = [(11 * j) % 190 + 5 for j in range(36)]
PROMPT1 = list(range(1, 33))
PROMPT2 = PROMPT1 + list(range(101, 109))
THRASH = [[(i * 31 + j) % 240 + 2 for j in range(32)] for i in range(6)]
SPEC = {"spec-decode": "ngram", "pipeline-decode": True}
SPEC_JOBS = [(_repetitive(30), dict(max_new_tokens=64), {}), (_repetitive(24) + [99, 98], GREEDY, {})]
HOST = dict(PAGED, **{"kv-blocks": 20, "kv-host-blocks": 12})


def _leg(prompt, sampled, payload):
    """The decode leg of a handoff of ``prompt`` whose prefill leg sampled
    ``sampled``: the prompt and the sampled tokens but the last, replayed
    over the imported ``payload`` (a saved payload's path)."""
    return (prompt + sampled[:-1], SEEDED,
            {"replay_tokens": sampled, "prompt_len": len(prompt), "kv_import": payload})


def _export_job(prompt):
    return (prompt, dict(SEEDED, max_new_tokens=2), {"export_handoff": True})


CASES = {
    "mixed": dict(engine=MIXED, together=True, jobs=[
        (list(range(3, 40)), GREEDY, {}), (list(range(50, 90)), SEEDED, {}),
        (list(range(5, 20)), dict(GREEDY, max_new_tokens=10), {})]),
    # pipelined, so that the long stream's chunks chain
    "spec-dense": dict(engine=SPEC, jobs=SPEC_JOBS),
    "spec-paged": dict(engine=dict(PAGED, **SPEC), jobs=SPEC_JOBS),
    # the import job is added by the fixture (the tp=1 leg's payload)
    "handoff": dict(engine=PAGED, jobs=[_export_job(EXPORTED)]),
    "host-tier": dict(engine=HOST, jobs=[(PROMPT1, dict(max_new_tokens=8), {})]
                      + [(prompt, dict(max_new_tokens=8), {}) for prompt in THRASH]
                      + [(PROMPT2, dict(max_new_tokens=8), {})]),
    "crash": dict(engine=dict(MIXED, **{"prefill-buckets": [16, 32]}), together=True,
                  faults="engine_thread_crash@step=5", jobs=[
                      (list(range(3, 40)), dict(GREEDY, max_new_tokens=20), {}),
                      (list(range(60, 75)), dict(SEEDED, max_new_tokens=20), {})]),
}


def _engine_args(case_engine):
    """A case's provider engine keys as the engines' keyword arguments."""
    config = worker.features_config(case_engine, 1)["engine"]
    args = dict(max_slots=config["max-slots"], max_seq_len=config["max-seq-len"],
                prefill_buckets=config["prefill-buckets"], decode_chunk=config["decode-chunk"],
                seed=config["sampling-seed"])
    keys = {"kv-layout": "kv_layout", "kv-block-size": "kv_block_size", "prefill-mode": "prefill_mode",
            "prefill-chunk": "prefill_chunk", "pipeline-decode": "pipeline_decode",
            "kv-blocks": "kv_blocks", "kv-host-blocks": "kv_host_blocks", "spec-decode": "spec_decode"}
    args.update({keys[key]: value for key, value in config.items() if key in keys})
    return args


@pytest.fixture(scope="module")
def weights():
    config = model.LlamaConfig.tiny(max_seq_len=128)
    params = model.init_params(config, seed=0)
    jconfig = jax_model.LlamaConfig.tiny(max_seq_len=128)
    jparams = {name: jnp.asarray(leaf.numpy()) for name, leaf in params.items()}
    return config, params, jconfig, jparams


def _port(weights, case_engine, **overrides):
    config, params, _, _ = weights
    return engine.DecodeEngine(config, params, device="cpu",
                               **dict(_engine_args(case_engine), **overrides))


def _jax(weights, case_engine, **overrides):
    _, _, jconfig, jparams = weights
    args = dict(_engine_args(case_engine), **overrides)
    if args.get("kv_layout") == "paged":
        args["paged_kernel"] = "reference"
    return jax_engine.DecodeEngine(jconfig, jparams, mesh_config=JaxMeshConfig(tp=TP), **args)


def _serve(eng, jobs, together=False, out="", jax=False):
    """Start ``eng``, run ``jobs`` (``worker.run_jobs``), stop it."""
    lib = jax_engine if jax else engine
    eng.start()
    try:
        return asyncio.run(worker.run_jobs(lambda: eng, jobs, together, out,
                                           sampling_params=lib.SamplingParams))
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    """The tp=1 handoff leg first (its payload is the tp=2 import's), then
    the two ranks over every case, started at once; yields a function
    that waits for them and returns a case's leader result and follower
    account."""
    root = tmp_path_factory.mktemp("tp-features")
    tp1 = _serve(_port(weights, PAGED), [_export_job(IMPORTED)], out=str(root / "tp1"))
    assert tp1[0]["exported"]
    cases = []
    for name, case in CASES.items():
        jobs = list(case["jobs"])
        if name == "handoff":
            jobs.append(_leg(IMPORTED, tp1[0]["tokens"], str(root / "tp1.0")))
        cases.append(dict(case, name=name, jobs=jobs))
    out = str(root / "features")
    children = launch.spawn_ranks(
        "torch_tp_worker:tp_features", {"cases": cases, "out": out}, ["cpu"] * TP,
        f"127.0.0.1:{free_port()}", timeout_s=RANK_TIMEOUT_S, ranks=range(TP),
        path=[str(REPO / "tests")], cwd=str(REPO))
    done = []

    def wait(name):
        if not done:
            assert launch.stop_ranks(children, timeout_s=RANK_TIMEOUT_S) == [0] * TP
            done.append(True)
        leader = json.load(open(f"{out}.{name}.json"))
        follower = json.load(open(f"{out}.{name}.1"))
        # every record replayed (the stop record is not), the same tokens
        assert follower["records"] == leader["published"] - 1, (follower, leader["published"])
        assert follower["digest"] == leader["digest"]
        assert leader["kv_heads"] * TP == model.LlamaConfig.tiny().num_kv_heads
        assert leader["stats"]["step_functions"] == "eager"
        return leader, follower

    wait.root, wait.tp1 = root, tp1
    yield wait
    for child in children:
        if child.poll() is None:
            child.kill()


def _same(got, want, logprobs=True):
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert [r["finish_reason"] for r in got] == [r["finish_reason"] for r in want]
    if logprobs:
        for mine, theirs in zip(got, want):
            np.testing.assert_allclose(mine["logprobs"], theirs["logprobs"], rtol=0,
                                       atol=LOGPROB_TOLERANCE)


def test_mixed_streams_match_jax_and_split(ranks, weights):
    """The mixed step at tp=2 (B7 per rank, its carry chained through
    ``mixed_chained`` records): the streams of the JAX mixed engine at
    tp=2 and of the port's split engine at tp=1."""
    case = CASES["mixed"]
    want_jax = _serve(_jax(weights, case["engine"]), case["jobs"], True, jax=True)
    split = _serve(_port(weights, case["engine"], prefill_mode="split"), case["jobs"], True)
    leader, follower = ranks("mixed")
    _same(leader["results"], want_jax)
    _same(leader["results"], split)
    assert leader["stats"]["mixed_steps"] > 0 and leader["stats"]["mixed_steps_chained"] > 0
    assert follower["kinds"]["mixed"] > 0 and follower["kinds"]["mixed_chained"] > 0
    assert follower["model_calls"]["mixed"] == leader["stats"]["mixed_steps"]


@pytest.mark.parametrize("name", ["spec-dense", "spec-paged"])
def test_spec_greedy_streams_match_spec_off_and_jax(ranks, weights, name):
    """Speculative decoding at tp=2 (the verify block through B3 per rank
    on the paged layout): greedy streams equal to the port's spec-off
    engine at tp=1 and the JAX spec engine at tp=2; drafts accepted; the
    follower chained ``spec_chained`` records from its own history."""
    case = CASES[name]
    want_jax = _serve(_jax(weights, case["engine"]), case["jobs"], jax=True)
    plain = _serve(_port(weights, case["engine"], spec_decode="off"), case["jobs"])
    leader, follower = ranks(name)
    _same(leader["results"], want_jax)
    _same(leader["results"], plain)
    assert leader["stats"]["tokens_draft_accepted"] > 0
    assert follower["kinds"]["spec"] > 0 and follower["kinds"]["spec_chained"] > 0


def test_handoff_across_tp_matches_the_unified_run_and_jax(ranks, weights):
    """A session exported at tp=2 (the ranks' kv heads gathered to one
    card's layout) is within 1e-4 of the JAX engine's tp=2 export and,
    imported by a port tp=1 engine, continues as the un-handed-off run;
    a tp=1 export imported at tp=2 (rank 0 broadcasting the rows, each
    rank keeping its kv heads) does too."""
    unified = {name: _serve(_port(weights, PAGED), [(prompt, SEEDED, {})])[0]
               for name, prompt in (("exported", EXPORTED), ("imported", IMPORTED))}
    jax_tp2 = _jax(weights, PAGED)
    jax_tp2.start()
    try:
        async def export():
            return await jax_tp2.generate(EXPORTED, jax_engine.SamplingParams(**_export_job(EXPORTED)[1]),
                                          request_fields={"export_handoff": True})

        jax_leg = asyncio.run(export())
    finally:
        jax_tp2.stop()
    leader, follower = ranks("handoff")
    exported, imported = leader["results"]
    assert exported["exported"] and exported["tokens"] == unified["exported"]["tokens"][:2]
    assert exported["tokens"] == list(jax_leg.tokens)
    path = f"{ranks.root}/features.handoff.0"
    payload = worker.load_payload(path)
    assert payload["tokens"] == list(jax_leg.kv_handoff["tokens"])
    assert set(payload["arrays"]) == set(jax_leg.kv_handoff["arrays"])
    for leaf, rows in payload["arrays"].items():
        want = np.asarray(jax_leg.kv_handoff["arrays"][leaf], dtype=np.float32)
        assert rows.shape == want.shape, leaf
        scale = max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(rows.numpy() - want).max()) <= PAYLOAD_TOLERANCE * scale, leaf
    # the tp=2 export imported at tp=1, and the tp=1 export at tp=2; the
    # replayed tokens carry no logprobs of their own (the manifest's)
    at_tp1 = _serve(_port(weights, PAGED), [_leg(EXPORTED, exported["tokens"], path)])[0]
    for leg, want in ((at_tp1, unified["exported"]), (imported, unified["imported"])):
        _same([leg], [want], logprobs=False)
        np.testing.assert_allclose(leg["logprobs"][2:], want["logprobs"][2:], rtol=0,
                                   atol=LOGPROB_TOLERANCE)
    assert leader["stats"]["handoff_exports"] == 1 and leader["stats"]["handoff_imports"] == 1
    assert follower["kinds"]["handoff_export"] == 1 and follower["kinds"]["handoff_import"] == 1
    assert follower["kinds"]["counts"] == 1  # the decode leg's replay restores its counts


def test_host_tier_promotion_matches_never_evicted(ranks, weights):
    """A chain demoted to the host tier under pool pressure and promoted
    back at tp=2 (each rank its kv heads, keyed by rank 0's digests):
    every stream equals a never-evicting tp=1 engine's and the JAX tp=2
    engine's with the same tier; the follower's tier ends as large as
    rank 0's arena."""
    case = CASES["host-tier"]
    oracle = _serve(_port(weights, PAGED), case["jobs"])
    want_jax = _serve(_jax(weights, case["engine"]), case["jobs"], jax=True)
    leader, follower = ranks("host-tier")
    _same(leader["results"], oracle)
    _same(leader["results"], want_jax)
    stats = leader["stats"]
    assert stats["host_demotions"] > 0 and stats["host_promotions"] > 0
    assert stats["kv_host_hit_tokens"] > 0
    assert follower["kinds"]["host_demote"] == stats["host_demotions"]
    assert follower["kinds"]["host_promote"] > 0 and follower["kinds"]["host_evict"] > 0
    assert follower["host_tier"] == leader["host_tier"] > 0


def test_crash_heals_under_tp_and_resumes_as_the_uncrashed_oracle(ranks, weights):
    """``engine_thread_crash@step=5`` on the tp=2 mixed engine: one heal
    (the followers release and rebuild beside rank 0), the live sessions
    resurrected with their counts restored on every rank, and each
    resumed stream equal to the uncrashed port tp=1 engine's and the
    uncrashed JAX engine's at tp=2."""
    case = CASES["crash"]
    oracle = _serve(_port(weights, case["engine"]), case["jobs"], True)
    want_jax = _serve(_jax(weights, case["engine"]), case["jobs"], True, jax=True)
    leader, follower = ranks("crash")
    _same(leader["results"], oracle)
    _same(leader["results"], want_jax)
    assert leader["restarts"] == 1 and leader["resurrected"] >= 1
    assert follower["kinds"]["release"] == 1 and follower["kinds"]["rebuild"] == 1
    assert follower["kinds"]["counts"] >= 1
