"""The port's mixture-of-experts path (``ops/moe.py`` and the Mixtral
family through the model, engine, provider and trainer) against the JAX
package's, on the CPU.

The same numpy-seeded inputs, and JAX weights carried across with
``params_from_jax``, go through both packages in f32:

- ``moe_capacity`` on JAX's cases; ``moe_routing``'s dispatch, combine and
  aux loss within 1e-6 of JAX's, over one group and a stack of groups,
  with a ``valid`` mask, and with tied router logits, where the chosen
  experts must be JAX's exactly (``lax.top_k`` ranks ties lower index
  first; ``torch.topk`` promises no order);
- ``moe_mlp`` in both regimes (exact and capacity, a padded last group,
  tokens dropped at capacity factor 1) within 1e-5 of max |JAX|;
- on ``tiny_moe``, every serving call against JAX's within 1e-4 of max
  |logit| (the tolerance of ``tests/test_torch_model.py``): ``prefill``,
  ``decode_step``, ``prefill_at_offset``, ``paged_prefill``,
  ``paged_prefill_at_offset``, ``paged_decode_step``,
  ``paged_mixed_step``, ``verify_step`` and ``paged_verify_step``; the
  MLP in row slices (``MLP_ROWS // num_experts`` rows) against one pass;
- the int8 weights: the expert leaves and the router stay in the model
  dtype, as JAX's ``quantize_params`` leaves them, and the int8 model's
  calls match JAX's;
- ``DecodeEngine`` greedy and seeded streams equal to the JAX engine's,
  dense and paged (bf16 weights and int8); the provider with the
  ``tiny-moe`` preset answering a chat; the checkpoint meta round trip;
- ``forward``'s logits and aux loss, ``dropless`` True and False, within
  1e-5 (tokens dropped at capacity factor 1 included); ``Trainer``
  against JAX's for 3 steps at lr 1e-3 with ``moe_aux_weight`` 0.01,
  remat on and off, with the tolerances of ``tests/test_torch_training.py``.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.ops import moe as jax_moe
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local import quant as jax_quant
from langstream_tpu.training import trainer as jax_trainer
from langstream_tpu_torch.api.service import ChatMessage
from langstream_tpu_torch.ops import moe
from langstream_tpu_torch.parallel.mesh import AxisGroup
from langstream_tpu_torch.providers.torch_local import engine, model, quant
from langstream_tpu_torch.providers.torch_local.convert import cache_from_jax, params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService
from langstream_tpu_torch.training import checkpoint, trainer

torch.set_num_threads(2)

SLOTS, MAX_LEN, BLOCK = 4, 64, 8
LOGITS_TOLERANCE = 1e-4
ROUTING_TOLERANCE = 1e-6
MLP_TOLERANCE = 1e-5
FORWARD_TOLERANCE = 1e-5
ENGINE_ARGS = dict(max_slots=4, max_seq_len=128, prefill_buckets=[32], decode_chunk=4, seed=0)


def _close(out, ref, rel):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale, (float(np.abs(out - ref).max()), scale)


def _t(array):
    return torch.from_numpy(np.array(array))  # a writable copy of a JAX buffer


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw))


@functools.lru_cache(maxsize=None)
def _weights(max_seq_len=MAX_LEN, seed=3, capacity_factor=2.0):
    """(JAX config, port config, JAX params, port params) of f32
    ``tiny_moe``."""
    jcfg = dataclasses.replace(jax_model.LlamaConfig.tiny_moe(max_seq_len=max_seq_len),
                               capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(model.LlamaConfig.tiny_moe(max_seq_len=max_seq_len),
                               capacity_factor=capacity_factor)
    jparams = jax_model.init_params(jcfg, seed=seed)
    return jcfg, tcfg, jparams, params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg)


# ---------------------------------------------------------------------- #
# ops/moe.py
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", [(64, 4, 2, 2.0), (1, 8, 2, 1.0), (64, 4, 2, None),
                                  (64, 4, 2, 100.0), (37, 8, 2, 1.25), (5, 4, 1, 0.01)])
def test_capacity_matches_jax(case):
    assert moe.moe_capacity(*case) == jax_moe.moe_capacity(*case)


def _routing_case(case):
    """(logits [G, S, E] f32, valid [G, S] bool or None, k, capacity)."""
    rng = np.random.default_rng(17)
    groups, tokens, experts = 3, 16, 4
    logits = rng.standard_normal((groups, tokens, experts)).astype(np.float32)
    valid = None
    if case == "valid":
        valid = rng.random((groups, tokens)) < 0.7
        valid[2] = False  # an all-padding group
    if case == "ties":
        logits[0, :4] = 0.0                      # every expert equal
        logits[0, 4:8] = [1.0, 2.0, 2.0, 2.0]    # three tie for first
        logits[1] = logits[1, :1]                # one row repeated: every token ties
        logits[2, :, 3] = logits[2, :, 1]        # experts 1 and 3 always equal
    return logits, valid, 2, 6


@pytest.mark.parametrize("case", ["plain", "valid", "ties"])
def test_routing_matches_jax(case):
    """Each group alone and the stack of groups (JAX's ``vmap``):
    dispatch exactly JAX's (the same experts and slots, ties included),
    combine and aux within 1e-6."""
    logits, valid, k, capacity = _routing_case(case)
    want = [jax_moe.moe_routing(jnp.asarray(logits[g]), k, capacity,
                                None if valid is None else jnp.asarray(valid[g]))
            for g in range(logits.shape[0])]
    stacked = moe.moe_routing(torch.from_numpy(logits), k, capacity,
                              None if valid is None else torch.from_numpy(valid))
    for g, (jd, jc, ja) in enumerate(want):
        alone = moe.moe_routing(torch.from_numpy(logits[g]), k, capacity,
                                None if valid is None else torch.from_numpy(valid[g]))
        for dispatch, combine, aux in (alone, tuple(x[g] for x in stacked)):
            np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
            np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=0,
                                       atol=ROUTING_TOLERANCE)
            np.testing.assert_allclose(float(aux), float(ja), rtol=ROUTING_TOLERANCE)
    if case == "plain":  # capacity 6 of 16 tokens × 2 choices over 4 experts: some drop
        assert float(stacked[0].sum()) < logits.shape[0] * logits.shape[1] * k
    # the experts each token chose, in rank order: JAX's, ties going to
    # the lower expert
    ids = moe._top_gates(torch.from_numpy(logits), k)[2]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.lax.top_k(jax.nn.softmax(logits), k)[1]))
    if case == "ties":
        assert ids[0, :4].tolist() == [[0, 1]] * 4 and ids[0, 4:8].tolist() == [[1, 2]] * 4
        assert ids[1].tolist() == [ids[1, 0].tolist()] * 16


def test_top_k_tie_order_matters():
    """The dense regime on a token whose probabilities tie: the chosen
    experts, and so the output, are JAX's (lower index first)."""
    rng = np.random.default_rng(5)
    h, f, e = 8, 16, 4
    x = rng.standard_normal((6, h)).astype(np.float32)
    router = np.zeros((h, e), np.float32)  # every logit 0: all four experts tie
    router[:, 3] = rng.standard_normal(h).astype(np.float32) * 1e-3 * (np.arange(h) == 0)
    w = [rng.standard_normal(shape).astype(np.float32) * 0.3
         for shape in ((e, h, f), (e, h, f), (e, f, h))]
    want, _ = jax_moe.moe_mlp(jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, w),
                              capacity_factor=None)
    got, _ = moe.moe_mlp(torch.from_numpy(x), torch.from_numpy(router), *map(torch.from_numpy, w),
                         capacity_factor=None)
    _close(got.numpy(), want, MLP_TOLERANCE)


def _mlp_case(seed=11, batch=2, seq=37, h=16, f=32, e=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, h)).astype(np.float32)
    router = rng.standard_normal((h, e)).astype(np.float32)
    weights = [rng.standard_normal(shape).astype(np.float32) * 0.2
               for shape in ((e, h, f), (e, h, f), (e, f, h))]
    valid = np.ones((batch, seq), bool)
    valid[1, 20:] = False
    return x, router, weights, valid


@pytest.mark.parametrize("regime", ["exact", "exact_valid", "capacity", "capacity_drops",
                                    "capacity_one_group"])
def test_moe_mlp_matches_jax(regime):
    """74 tokens: the capacity regime groups them 16 at a time in
    row-major order (a group spans both rows, the last one padded), at
    factor 2 and at factor 1 (tokens dropped), or all in one group."""
    x, router, weights, valid = _mlp_case()
    kwargs = dict(num_selected=2)
    if regime.startswith("exact"):
        kwargs["capacity_factor"] = None
    else:
        kwargs.update(capacity_factor=1.0 if regime == "capacity_drops" else 2.0,
                      group_size=128 if regime == "capacity_one_group" else 16)
    mask = valid if regime != "exact" else None
    want, want_aux = jax_moe.moe_mlp(jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, weights),
                                     valid=None if mask is None else jnp.asarray(mask), **kwargs)
    got, aux = moe.moe_mlp(torch.from_numpy(x), torch.from_numpy(router),
                           *map(torch.from_numpy, weights),
                           valid=None if mask is None else torch.from_numpy(mask), **kwargs)
    _close(got.numpy(), want, MLP_TOLERANCE)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=ROUTING_TOLERANCE)


@pytest.mark.parametrize("group", ["share_group", "batch_group"])
def test_exact_regime_refuses_mesh_groups(group):
    """The exact regime runs one card's experts whole: a training rank's
    groups (its share of the experts, its rows of the batch) are the
    capacity regime's only."""
    x, router, weights, _ = _mlp_case()
    with pytest.raises(ValueError, match="capacity regime"):
        moe.moe_mlp(torch.from_numpy(x), torch.from_numpy(router), *map(torch.from_numpy, weights),
                    capacity_factor=None, **{group: AxisGroup(0, 2)})


# ---------------------------------------------------------------------- #
# the model's serving calls on tiny_moe
# ---------------------------------------------------------------------- #
def test_init_params_shapes_and_presets_match_jax():
    jcfg, tcfg = jax_model.LlamaConfig.tiny_moe(), model.LlamaConfig.tiny_moe()
    jparams, tparams = jax_model.init_params(jcfg, seed=0), model.init_params(tcfg, seed=0)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    assert all(v.dtype == torch.float32 for v in tparams.values())
    for preset in ("mixtral-8x7b", "tiny-moe"):
        jpre = jax_model.LlamaConfig.from_dict({"preset": preset})
        tpre = model.LlamaConfig.from_dict({"preset": preset})
        for field in dataclasses.fields(jpre):
            if field.name != "dtype":
                assert getattr(tpre, field.name) == getattr(jpre, field.name), (preset, field.name)
    bf16 = dataclasses.replace(model.LlamaConfig.mixtral_8x7b(), num_layers=1, hidden_size=64,
                               intermediate_size=32, vocab_size=64)
    drawn = model.init_params(bf16, seed=0)
    assert drawn["w_gate"].dtype == drawn["router"].dtype == torch.bfloat16
    assert tuple(drawn["w_down"].shape) == (1, 8, 32, 64)
    with pytest.raises(ValueError, match="router"):
        model.prefill(tcfg, {k: v for k, v in tparams.items() if k != "router"}, {}, None, None,
                      None, None)


def test_dense_calls_match_jax():
    """Prefill of two rows, four greedy decode steps (two slots ride
    along masked), then a prefill-at-offset of a third slot onto its own
    prefix: logits and the written cache rows."""
    jcfg, tcfg, jparams, tparams = _weights()
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    lengths = np.array([24, 13], np.int32)
    slot_ids = np.array([1, 3], np.int32)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    jcache = jax_model.init_cache(jcfg, SLOTS, MAX_LEN)
    tcache = model.init_cache(tcfg, SLOTS, MAX_LEN)
    jcache, jlogits = _jit(jax_model.prefill, jcfg)(
        jparams, jcache, *map(jnp.asarray, (tokens, lengths, slot_ids)), jfreqs)
    tlogits = model.prefill(tcfg, tparams, tcache, *map(_t, (tokens, lengths, slot_ids)), tfreqs)
    _close(tlogits.numpy(), jlogits, LOGITS_TOLERANCE)
    active = np.zeros(SLOTS, bool)
    active[slot_ids] = True
    step_tokens = np.zeros(SLOTS, np.int32)
    step_tokens[slot_ids] = np.asarray(jnp.argmax(jlogits, axis=-1))
    step_lengths = np.zeros(SLOTS, np.int32)
    step_lengths[slot_ids] = lengths + 1
    decode = _jit(jax_model.decode_step, jcfg)
    for _ in range(4):
        jcache, jl = decode(jparams, jcache, *map(jnp.asarray, (step_tokens, step_lengths)), jfreqs,
                            jnp.asarray(active))
        tl = model.decode_step(tcfg, tparams, tcache, _t(step_tokens), _t(step_lengths), tfreqs,
                               _t(active))
        _close(tl.numpy()[active], np.asarray(jl)[active], LOGITS_TOLERANCE)
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    for leaf in ("k", "v"):
        _close(tcache[leaf][:, slot_ids].numpy(), np.asarray(jcache[leaf])[:, slot_ids],
               LOGITS_TOLERANCE)
    prefix = (tokens[:1, :16], np.array([16], np.int32), np.array([0], np.int32))
    jcache, _ = _jit(jax_model.prefill, jcfg)(jparams, jcache, *map(jnp.asarray, prefix), jfreqs)
    model.prefill(tcfg, tparams, tcache, *map(_t, prefix), tfreqs)
    suffix = (rng.integers(0, jcfg.vocab_size, size=(1, 8)).astype(np.int32),
              np.array([8], np.int32), np.array([16], np.int32), np.array([0], np.int32))
    jcache, jl = _jit(jax_model.prefill_at_offset, jcfg)(jparams, jcache, *map(jnp.asarray, suffix),
                                                          jfreqs)
    tl = model.prefill_at_offset(tcfg, tparams, tcache, *map(_t, suffix), tfreqs)
    _close(tl.numpy(), jl, LOGITS_TOLERANCE)
    _close(tcache["k"][:, 0, :24].numpy(), np.asarray(jcache["k"])[:, 0, :24], LOGITS_TOLERANCE)


def _paged_setup(jcfg, tcfg, seed=13):
    rng = np.random.default_rng(seed)
    width = MAX_LEN // BLOCK
    num_blocks = SLOTS * width + 1
    tables = np.zeros((SLOTS, width), np.int32)
    tables[:3] = (rng.permutation(num_blocks - 1) + 1)[: 3 * width].reshape(3, width)
    tables[2, :2] = tables[0, :2]  # row 2 continues row 0's first 16 tokens
    return (rng, tables, jax_model.init_paged_cache(jcfg, num_blocks, BLOCK),
            model.init_paged_cache(tcfg, num_blocks, BLOCK))


def test_paged_calls_match_jax():
    """Paged prefill of two prompts, prefill-at-offset of a third row
    over the first prompt's blocks, three decode steps, then two mixed
    steps (decoding rows beside a window resuming at an offset and an
    idle row), against the JAX reference route; logits and every pool
    block but the null block."""
    jcfg, tcfg, jparams, tparams = _weights()
    rng, tables, jcache, tcache = _paged_setup(jcfg, tcfg)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    prompts = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    lengths = np.array([24, 13], np.int32)
    jcache, jlogits = _jit(jax_model.paged_prefill, jcfg, kernel="reference")(
        jparams, jcache, *map(jnp.asarray, (prompts, lengths, tables[:2])), jfreqs)
    tlogits = model.paged_prefill(tcfg, tparams, tcache, *map(_t, (prompts, lengths, tables[:2])),
                                  tfreqs)
    _close(tlogits.numpy(), jlogits, LOGITS_TOLERANCE)
    warm = (rng.integers(0, jcfg.vocab_size, size=(1, 8)).astype(np.int32), np.array([8], np.int32),
            np.array([16], np.int32), tables[2:3])
    jcache, jwarm = _jit(jax_model.paged_prefill_at_offset, jcfg, kernel="reference")(
        jparams, jcache, *map(jnp.asarray, warm), jfreqs)
    twarm = model.paged_prefill_at_offset(tcfg, tparams, tcache, *map(_t, warm), tfreqs)
    _close(twarm.numpy(), jwarm, LOGITS_TOLERANCE)
    decode = _jit(jax_model.paged_decode_step, jcfg, kernel="reference")
    active = np.array([True, True, True, False])
    step_lengths = np.array([25, 14, 25, 0], np.int32)
    step_tokens = np.zeros(SLOTS, np.int32)
    step_tokens[:2] = np.asarray(jnp.argmax(jlogits, axis=-1))
    step_tokens[2] = int(jnp.argmax(jwarm[0]))
    for _ in range(3):
        args = (step_tokens, step_lengths, tables)
        jcache, jl = decode(jparams, jcache, *map(jnp.asarray, args), jfreqs, jnp.asarray(active))
        tl = model.paged_decode_step(tcfg, tparams, tcache, *map(_t, args), tfreqs, _t(active))
        _close(tl.numpy()[active], np.asarray(jl)[active], LOGITS_TOLERANCE)
        step_tokens = np.where(active, np.asarray(jnp.argmax(jl, axis=-1)), 0).astype(np.int32)
        step_lengths = np.where(active, step_lengths + 1, step_lengths).astype(np.int32)
    # mixed: rows 0 and 2 decode, row 1 a window of 6 at its length, row 3 idle
    mixed = _jit(jax_model.paged_mixed_step, jcfg, kernel="reference")
    width = 8
    tokens = rng.integers(0, jcfg.vocab_size, size=(SLOTS, width)).astype(np.int32)
    offsets = step_lengths - 1
    offsets[3] = 0
    for num_tokens in (np.array([1, 6, 1, 0], np.int32), np.array([1, 1, 1, 0], np.int32)):
        args = (tokens, offsets, num_tokens, tables)
        jcache, jl = mixed(jparams, jcache, *map(jnp.asarray, args), jfreqs)
        tl = model.paged_mixed_step(tcfg, tparams, tcache, *map(_t, args), tfreqs)
        _close(tl.numpy()[:3], np.asarray(jl)[:3], LOGITS_TOLERANCE)
        offsets = (offsets + num_tokens).astype(np.int32)
    for leaf in ("k", "v"):
        _close(tcache[leaf][:, 1:].numpy(), np.asarray(jcache[leaf])[:, 1:], LOGITS_TOLERANCE)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_steps_match_jax(layout):
    """A verify block of 5 on three rows after a prefill (two drafts, a
    full block, an inactive row): logits at every real position."""
    jcfg, tcfg, jparams, tparams = _weights(max_seq_len=128)
    rng = np.random.default_rng(21)
    prompts = rng.integers(1, 250, size=(3, 32)).astype(np.int32)
    prompt_lengths = np.asarray([20, 32, 9], np.int32)
    block = rng.integers(1, 250, size=(3, 5)).astype(np.int32)
    lengths = np.asarray([21, 33, 0], np.int32)
    valid = np.asarray([5, 3, 0], np.int32)
    active = np.asarray([True, True, False])
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    step = (block, lengths, valid)
    if layout == "dense":
        jcache = jax_model.init_cache(jcfg, 3, 128)
        jcache, _ = jax_model.prefill(jcfg, jparams, jcache, jnp.asarray(prompts),
                                      jnp.asarray(prompt_lengths), jnp.arange(3), jfreqs)
        tcache = cache_from_jax({k: np.asarray(v) for k, v in jcache.items()})
        jcache, jl = jax_model.verify_step(jcfg, jparams, jcache, *map(jnp.asarray, step), jfreqs,
                                           write_mask=jnp.asarray(active))
        tl = model.verify_step(tcfg, tparams, tcache, *map(_t, step), tfreqs, write_mask=_t(active))
    else:
        tables = np.zeros((3, 16), np.int32)
        tables[:2, :6] = (rng.permutation(12) + 1).reshape(2, 6)
        jcache = jax_model.init_paged_cache(jcfg, 13, 8)
        jcache, _ = jax_model.paged_prefill(jcfg, jparams, jcache, jnp.asarray(prompts[:2]),
                                            jnp.asarray(prompt_lengths[:2]), jnp.asarray(tables[:2]),
                                            jfreqs, kernel="reference")
        tcache = cache_from_jax({k: np.asarray(v) for k, v in jcache.items()})
        jcache, jl = jax_model.paged_verify_step(
            jcfg, jparams, jcache, *map(jnp.asarray, step), jnp.asarray(tables), jfreqs,
            write_mask=jnp.asarray(active), kernel="reference")
        tl = model.paged_verify_step(tcfg, tparams, tcache, *map(_t, step), _t(tables), tfreqs,
                                     write_mask=_t(active))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (3, 5, tcfg.vocab_size)
    for row in range(2):
        _close(tl[row, : valid[row]].numpy(), jl[row, : valid[row]], LOGITS_TOLERANCE)


def test_mlp_row_slices_match_one_pass(monkeypatch):
    """``MLP_ROWS`` cut to 12: the MoE MLP of a 2 × 24-row prefill runs in
    slices of 12 // 4 = 3 rows, and its logits and cache rows equal one
    pass's to 1e-6."""
    _, tcfg, _, tparams = _weights()
    rng = np.random.default_rng(3)
    tokens = _t(rng.integers(0, tcfg.vocab_size, size=(2, 24)).astype(np.int32))
    lengths = torch.tensor([24, 17], dtype=torch.int32)
    slots = torch.tensor([0, 2])
    freqs = model.model_freqs(tcfg)
    one_cache = model.init_cache(tcfg, SLOTS, MAX_LEN)
    one = model.prefill(tcfg, tparams, one_cache, tokens, lengths, slots, freqs)
    rows = []
    block = model._mlp_block

    def counted(config, normed, params, i, **kwargs):
        rows.append(normed.reshape(-1, normed.shape[-1]).shape[0])
        return block(config, normed, params, i, **kwargs)

    monkeypatch.setattr(model, "MLP_ROWS", 12)
    monkeypatch.setattr(model, "_mlp_block", counted)
    assert model.mlp_rows(tcfg) == 3
    sliced_cache = model.init_cache(tcfg, SLOTS, MAX_LEN)
    sliced = model.prefill(tcfg, tparams, sliced_cache, tokens, lengths, slots, freqs)
    assert rows == [3] * (2 * 48 // 3)
    _close(sliced.numpy(), one.numpy(), 1e-6)
    _close(sliced_cache["k"].numpy(), one_cache["k"].numpy(), 1e-6)


# ---------------------------------------------------------------------- #
# int8 weights: the experts stay in the model dtype
# ---------------------------------------------------------------------- #
def test_int8_keeps_expert_weights_and_matches_jax():
    """``quantize_params(params, num_experts)`` quantizes attention and
    the head and leaves ``w_gate``/``w_up``/``w_down`` and ``router`` in
    the model dtype (JAX's ``test_moe_params_keep_expert_weights_fp``),
    bf16 weights included; the int8 model's prefill and decode logits
    match the JAX int8 model's."""
    jcfg, tcfg, jparams, tparams = _weights()
    jq = jax_quant.quantize_params(jparams, jcfg.num_experts)
    tq = quant.quantize_params(tparams, tcfg.num_experts)
    bf16 = quant.quantize_params({k: v.bfloat16() for k, v in tparams.items()}, tcfg.num_experts)
    for params in (tq, bf16):
        for name in ("w_gate", "w_up", "w_down", "router"):
            assert isinstance(params[name], torch.Tensor), name
        assert params["w_gate"].dtype == (torch.bfloat16 if params is bf16 else torch.float32)
        assert isinstance(params["wq"], quant.QTensor) and isinstance(params["lm_head"], quant.QTensor)
    assert isinstance(jq["w_gate"], jnp.ndarray) and isinstance(jq["wq"], jax_quant.QTensor)
    carried = params_from_jax(jq, tcfg)
    for name in ("wq", "wo", "lm_head"):
        assert torch.equal(carried[name].q, tq[name].q), name
    assert quant.init_quantized_params(tcfg, seed=2)["w_up"].dtype == torch.float32
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 20)).astype(np.int32)
    lengths = np.array([20, 11], np.int32)
    slot_ids = np.array([0, 2], np.int32)
    jfreqs, tfreqs = jax_model.model_freqs(jcfg), model.model_freqs(tcfg)
    jcache, tcache = jax_model.init_cache(jcfg, SLOTS, MAX_LEN), model.init_cache(tcfg, SLOTS, MAX_LEN)
    jcache, jl = _jit(jax_model.prefill, jcfg)(jq, jcache, *map(jnp.asarray, (tokens, lengths, slot_ids)),
                                                jfreqs)
    tl = model.prefill(tcfg, tq, tcache, *map(_t, (tokens, lengths, slot_ids)), tfreqs)
    _close(tl.numpy(), jl, LOGITS_TOLERANCE)
    step = (np.array([5, 0, 9, 0], np.int32), np.array([21, 0, 12, 0], np.int32))
    active = np.array([True, False, True, False])
    jcache, jl = _jit(jax_model.decode_step, jcfg)(jq, jcache, *map(jnp.asarray, step), jfreqs,
                                                    jnp.asarray(active))
    tl = model.decode_step(tcfg, tq, tcache, *map(_t, step), tfreqs, _t(active))
    _close(tl.numpy()[active], np.asarray(jl)[active], LOGITS_TOLERANCE)


# ---------------------------------------------------------------------- #
# the engine, the provider, checkpoints
# ---------------------------------------------------------------------- #
def _generate(eng, requests):
    async def main():
        return await asyncio.gather(*[
            eng.generate(prompt, params, stop_tokens=stops) for prompt, params, stops in requests])

    return asyncio.run(main())


@pytest.mark.parametrize("layout,quantize", [("dense", None), ("paged", None), ("dense", "int8")])
def test_engine_streams_match_jax(layout, quantize):
    """Greedy (with penalties) and seeded (temperature, top-k, top-p,
    bias) streams, one prompt past the bucket: the port's engine against
    the JAX engine over the same ``tiny_moe`` weights."""
    jcfg, tcfg, jparams, tparams = _weights(max_seq_len=128, seed=5)
    paged = dict(kv_layout="paged", kv_block_size=8) if layout == "paged" else {}
    ported = engine.DecodeEngine(tcfg, tparams, device="cpu", quantize=quantize, **ENGINE_ARGS, **paged)
    reference = jax_engine.DecodeEngine(
        jcfg, jparams, quantize=quantize, prefix_cache=layout == "paged",
        **({"paged_kernel": "reference"} if paged else {}), **ENGINE_ARGS, **paged)
    try:
        rng = np.random.default_rng(31)

        def prompt(n):
            return rng.integers(0, 256, size=n).tolist()

        S = engine.SamplingParams
        requests = [
            (prompt(5), S(frequency_penalty=1.5, max_new_tokens=12), set()),
            (prompt(17), S(temperature=0.8, seed=11, max_new_tokens=10), set()),
            (prompt(30), S(temperature=1.0, top_k=20, seed=5, max_new_tokens=14), set()),
            (prompt(9), S(temperature=0.9, top_p=0.8, seed=3, presence_penalty=0.5,
                          logit_bias={7: 5.0}, max_new_tokens=9), set()),
            (prompt(45), S(max_new_tokens=8), set()),
        ]
        got = _generate(ported, requests)
        want = _generate(reference, [(p, jax_engine.SamplingParams(**s.__dict__), st)
                                     for p, s, st in requests])
        for index, (mine, theirs) in enumerate(zip(got, want)):
            assert mine.tokens == theirs.tokens, index
            np.testing.assert_allclose(mine.logprobs, theirs.logprobs, rtol=1e-4, atol=1e-4)
        assert [len(r.tokens) for r in got] == [12, 10, 14, 9, 8]
        if quantize:
            assert isinstance(ported.params["wq"], quant.QTensor)
            assert isinstance(ported.params["w_gate"], torch.Tensor)
    finally:
        ported.stop()
        reference.stop()


def test_provider_serves_tiny_moe_chat():
    service = TorchCompletionsService(
        {"model": {"preset": "tiny-moe"}, "engine": {"max-slots": 2, "decode-chunk": 4}}, device="cpu")
    try:
        assert service.engine.config.num_experts == 4 and "router" in service.engine.params
        reply = asyncio.run(service.get_chat_completions(
            [ChatMessage(role="user", content="hello experts")], {"max-tokens": 6}))
        assert reply.completion_tokens == 6 or reply.finish_reason == "stop"
        assert reply.completion_tokens > 0
    finally:
        service.close()


def test_checkpoint_meta_round_trip_keeps_the_experts(tmp_path):
    """``save_model`` → ``load_model`` keeps ``num_experts``,
    ``num_experts_per_tok`` and ``capacity_factor``, and the weights bit
    for bit."""
    _, tcfg, _, tparams = _weights(capacity_factor=1.5)
    checkpoint.save_model(str(tmp_path), tcfg, tparams)
    config, params = checkpoint.load_model(str(tmp_path), device="cpu")
    assert (config.num_experts, config.num_experts_per_tok, config.capacity_factor) == (4, 2, 1.5)
    assert sorted(params) == sorted(tparams)
    assert all(torch.equal(params[name], tparams[name]) for name in tparams)


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #
BATCH, SEQ = 2, 16


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 256, size=(BATCH, SEQ)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), bool)
    mask[1, 10:] = False
    return tokens, mask


@pytest.mark.parametrize("dropless,capacity_factor", [(True, 2.0), (False, 2.0), (False, 1.0)],
                         ids=["dropless", "capacity", "capacity_drops"])
def test_forward_logits_and_aux_match_jax(dropless, capacity_factor):
    jcfg, tcfg, jparams, tparams = _weights(seed=3, capacity_factor=capacity_factor)
    tokens, mask = _batch()
    jlogits, jaux = jax_model.forward(jcfg, jparams, jnp.asarray(tokens), mask=jnp.asarray(mask),
                                      with_aux=True, dropless=dropless)
    tlogits, taux = model.forward(tcfg, tparams, _t(tokens), mask=_t(mask), with_aux=True,
                                  dropless=dropless)
    _close(tlogits.detach().numpy(), jlogits, FORWARD_TOLERANCE)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=FORWARD_TOLERANCE)
    assert float(taux) > 0


def _grads(loss, params):
    loss.backward()
    return {name: leaf.grad.numpy().copy() for name, leaf in params.items()}


@functools.lru_cache(maxsize=None)
def _first_grads():
    """The first step's gradients of the MoE loss (aux weight 0.01), the
    port's and JAX's."""
    jcfg, tcfg, jparams, tparams = _weights(seed=3)
    tokens, mask = _batch()
    params = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss = trainer.loss_fn(tcfg, params, _t(tokens), _t(mask), model.model_freqs(tcfg),
                           moe_aux_weight=0.01)
    freqs = jax_model.model_freqs(jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_trainer.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(mask), freqs, 0.01)
    )(jparams)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    return _grads(loss, params), {k: np.asarray(v) for k, v in jgrads.items()}


@functools.lru_cache(maxsize=None)
def _jax_run(remat, grad_clip):
    jcfg, _, jparams, _ = _weights(seed=3)
    tokens, mask = _batch()
    config = jax_trainer.TrainConfig(learning_rate=1e-3, weight_decay=0.1, grad_clip=grad_clip,
                                     remat=remat, moe_aux_weight=0.01)
    # copies: the JAX step donates its parameters' buffers
    run = jax_trainer.Trainer(jcfg, {k: jnp.array(v) for k, v in jparams.items()},
                              train_config=config)
    losses = [run.train_step(tokens, mask) for _ in range(3)]
    return losses, {name: np.asarray(leaf) for name, leaf in run.params.items()}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_trainer_matches_jax(remat):
    """3 AdamW steps (lr 1e-3, weight decay 0.1, a clip that bites on
    step 1): losses within 1e-5 relative, each leaf's ``p3 - p0`` within
    1e-3 of JAX's max |p3 - p0| but at the few coordinates whose first
    gradient the two frameworks round apart by more than 1e-3 of its
    size (the rule of ``tests/test_torch_training.py``)."""
    _, tcfg, _, tparams = _weights(seed=3)
    tokens, mask = _batch()
    grads, jgrads = _first_grads()
    for name in grads:
        _close(grads[name], jgrads[name], 1e-4)
    grad_clip = round(0.5 * float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                              for g in grads.values()))), 6)
    want_losses, want_params = _jax_run(remat, grad_clip)
    config = trainer.TrainConfig(learning_rate=1e-3, weight_decay=0.1, grad_clip=grad_clip,
                                 remat=remat, moe_aux_weight=0.01)
    run = trainer.Trainer(tcfg, tparams, train_config=config, device="cpu")
    losses = [run.train_step(tokens, mask) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    unresolved = {name: np.abs(g - jgrads[name]) > 1e-3 * np.abs(jgrads[name])
                  for name, g in grads.items()}
    total = sum(g.size for g in grads.values())
    assert sum(int(u.sum()) for u in unresolved.values()) <= 1e-3 * total
    start = {name: leaf.numpy() for name, leaf in tparams.items()}
    for name, leaf in run.params.items():
        moved, want = leaf.detach().numpy() - start[name], want_params[name] - start[name]
        skip = unresolved[name]
        _close(np.where(skip, 0, moved), np.where(skip, 0, want), 1e-3)
    # the router learned: the aux loss reaches it
    assert float(np.abs(run.params["router"].detach().numpy() - start["router"]).max()) > 0
