"""The port's training path against the JAX package's, on the CPU.

The same numpy-seeded tokens, and JAX params carried across with
``params_from_jax``, go through both packages in f32:

- ``model.forward`` logits on ``tiny``, ``tiny_gemma2`` and ``tiny_qwen2``
  with a right-padded mask, within 1e-5 of max |logit|;
- ``causal_ce_loss`` within 1e-6 relative, an all-masked row included;
- the gradients of ``loss_fn``, leaf by leaf within 1e-4 of max |g_jax|;
- the clip rule against ``optax.clip_by_global_norm``, clipping and not,
  within 1e-6 of max |g|;
- ``Trainer`` against JAX's ``Trainer`` for 3 steps (lr 1e-3, weight
  decay 0.1, a ``grad_clip`` that clips on step 1), remat on and off:
  losses within 1e-5 relative, each leaf's ``p3 - p0`` within 1e-3 of
  JAX's max |p3 - p0| at every coordinate but the few (at most 0.1% of
  the model) whose first gradient the two frameworks round apart by
  more than 1e-3 of its size: Adam normalizes each coordinate by its
  own gradient, so there the rounding is the update;
- the refusals: JAX's (ep on a dense model or not dividing the experts,
  pp with fsdp or not dividing the layers), a mesh of size > 1 without a
  ``torch.distributed`` world, and ``device="cuda"`` without CUDA.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from langstream_tpu.ops.losses import causal_ce_loss as jax_causal_ce_loss
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.training import trainer as jax_trainer
from langstream_tpu_torch.ops.losses import causal_ce_loss
from langstream_tpu_torch.parallel.mesh import MeshConfig
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.training import trainer

torch.set_num_threads(2)

PRESETS = ["tiny", "tiny_gemma2", "tiny_qwen2"]
BATCH, SEQ = 2, 16


def _close(out, ref, rel):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(out - ref).max()) <= rel * scale, (float(np.abs(out - ref).max()), scale)


@functools.lru_cache(maxsize=None)
def _setup(preset):
    """(JAX config, port config, JAX params, numpy params, tokens, mask):
    f32, non-zero Qwen-2 biases, row 1 right-padded to 10 tokens."""
    jcfg = dataclasses.replace(getattr(jax_model.LlamaConfig, preset)(), dtype=jnp.float32)
    tcfg = dataclasses.replace(getattr(model.LlamaConfig, preset)(), dtype=torch.float32)
    jparams = jax_model.init_params(jcfg, seed=3)
    rng = np.random.default_rng(7)
    if jcfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            jparams[name] = jnp.asarray(0.1 * rng.standard_normal(jparams[name].shape, dtype=np.float32))
    np_params = {name: np.asarray(leaf) for name, leaf in jparams.items()}
    tokens = rng.integers(1, jcfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), dtype=bool)
    mask[1, 10:] = False
    return jcfg, tcfg, jparams, np_params, tokens, mask


def _port_params(preset, requires_grad=False):
    _, tcfg, _, np_params, _, _ = _setup(preset)
    params = params_from_jax(np_params, tcfg)
    return {k: v.requires_grad_(requires_grad) for k, v in params.items()}


@pytest.mark.parametrize("preset", PRESETS)
def test_forward_matches_jax(preset):
    jcfg, tcfg, jparams, _, tokens, mask = _setup(preset)
    want = jax.jit(functools.partial(jax_model.forward, jcfg))(
        jparams, jnp.asarray(tokens), mask=jnp.asarray(mask))
    params = _port_params(preset)
    got, aux = model.forward(tcfg, params, torch.from_numpy(tokens), mask=torch.from_numpy(mask),
                             with_aux=True)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got.detach(), want, 1e-5)
    # remat changes the backward's memory, not the forward
    again = model.forward(tcfg, params, torch.from_numpy(tokens), mask=torch.from_numpy(mask),
                          remat=True)
    assert torch.equal(again, got)


@pytest.mark.parametrize("rows", ["padded", "all_masked"])
def test_causal_ce_loss_matches_jax(rows):
    rng = np.random.default_rng(11)
    logits = 4.0 * rng.standard_normal((3, 12, 50), dtype=np.float32)
    tokens = rng.integers(0, 50, size=(3, 12)).astype(np.int32)
    mask = np.ones((3, 12), dtype=bool)
    mask[1, 7:] = False
    mask[2, 1:] = False  # a row with no valid target
    if rows == "all_masked":
        mask[:] = False
    want = float(jax_causal_ce_loss(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(mask)))
    got = float(causal_ce_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                               torch.from_numpy(mask)))
    if rows == "all_masked":
        assert got == want == 0.0
    else:
        assert abs(got - want) <= 1e-6 * abs(want)


@functools.lru_cache(maxsize=None)
def _jax_grads(preset):
    jcfg, _, jparams, _, tokens, mask = _setup(preset)
    freqs = jax_model.model_freqs(jcfg)
    grads = jax.jit(jax.grad(
        lambda p: jax_trainer.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(mask), freqs, 0.0)
    ))(jparams)
    return {name: np.asarray(leaf) for name, leaf in grads.items()}


def _port_grads(preset):
    _, tcfg, _, _, tokens, mask = _setup(preset)
    params = _port_params(preset, requires_grad=True)
    loss = trainer.loss_fn(tcfg, params, torch.from_numpy(tokens), torch.from_numpy(mask),
                           model.model_freqs(tcfg))
    loss.backward()
    return {name: leaf.grad.numpy() for name, leaf in params.items()}


@pytest.mark.parametrize("preset", PRESETS)
def test_loss_gradients_match_jax(preset):
    jgrads, grads = _jax_grads(preset), _port_grads(preset)
    assert set(grads) == set(jgrads)
    for name, grad in grads.items():
        _close(grad, jgrads[name], 1e-4)


@pytest.mark.parametrize("norm", [1e-3, 5e-5], ids=["clips", "below"])
def test_clip_rule_matches_optax(norm):
    """At a global norm of 1e-3 over a max of 1e-4 torch's
    ``clip_grad_norm_`` (``max / (norm + 1e-6)``) is 0.1% off optax."""
    max_norm = 1e-4
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal(shape, dtype=np.float32) for shape in ((7, 5), (13,), (3, 4, 2))]
    total = np.sqrt(sum(float((leaf.astype(np.float64) ** 2).sum()) for leaf in leaves))
    leaves = [leaf * np.float32(norm / total) for leaf in leaves]
    transform = optax.clip_by_global_norm(max_norm)
    want, _ = transform.update([jnp.asarray(leaf) for leaf in leaves], transform.init(None))
    grads = [torch.from_numpy(leaf.copy()) for leaf in leaves]
    got_norm = trainer.clip_by_global_norm_(grads, max_norm)
    assert abs(float(got_norm) - norm) <= 1e-6 * norm
    for got, ref in zip(grads, want):
        _close(got, ref, 1e-6)
    if norm > max_norm:
        torch_style = [torch.from_numpy(leaf.copy()) for leaf in leaves]
        torch.nn.utils.clip_grad_norm_(torch_style, max_norm)
        off = max(float((a - torch.from_numpy(np.array(b))).abs().max() / np.abs(b).max())
                  for a, b in zip(torch_style, want))
        assert off > 5e-4
    else:
        for got, leaf in zip(grads, leaves):
            assert np.array_equal(got.numpy(), leaf)


@functools.lru_cache(maxsize=None)
def _jax_run(preset, remat, grad_clip):
    jcfg, _, jparams, _, tokens, mask = _setup(preset)
    config = jax_trainer.TrainConfig(learning_rate=1e-3, weight_decay=0.1, grad_clip=grad_clip,
                                     remat=remat)
    run = jax_trainer.Trainer(jcfg, dict(jparams), train_config=config)
    losses = [run.train_step(tokens, mask) for _ in range(3)]
    return losses, {name: np.asarray(leaf) for name, leaf in run.params.items()}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("preset", PRESETS)
def test_trainer_matches_jax(preset, remat):
    _, tcfg, _, np_params, tokens, mask = _setup(preset)
    grads, jgrads = _port_grads(preset), _jax_grads(preset)
    # half the first step's gradient norm: step 1 clips
    grad_clip = round(0.5 * float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                              for g in grads.values()))), 6)
    want_losses, want_params = _jax_run(preset, remat, grad_clip)

    config = trainer.TrainConfig(learning_rate=1e-3, weight_decay=0.1, grad_clip=grad_clip,
                                 remat=remat)
    run = trainer.Trainer(tcfg, _port_params(preset), train_config=config, device="cpu")
    losses = [run.train_step(tokens, mask) for _ in range(3)]
    assert run.step == 3 and run.opt_state["count"] == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # Adam scales each coordinate by its own gradient's size, so where a
    # gradient is near zero (Qwen-2's key bias: RoPE alone breaks the
    # softmax's shift invariance) the two frameworks' f32 rounding of it
    # is the update's size. Those coordinates, whose first gradients
    # differ by more than 1e-3 of their own size, are counted and left
    # out; every other one, exact zeros included, is held.
    unresolved = {name: np.abs(g - jgrads[name]) > 1e-3 * np.abs(jgrads[name])
                  for name, g in grads.items()}
    total = sum(g.size for g in grads.values())
    assert sum(int(u.sum()) for u in unresolved.values()) <= 1e-3 * total
    for name, leaf in run.params.items():
        start, skip = np_params[name], unresolved[name]
        moved, want = leaf.detach().numpy() - start, want_params[name] - start
        _close(np.where(skip, 0, moved), np.where(skip, 0, want), 1e-3)


def test_trainer_copies_the_callers_params():
    _, tcfg, _, np_params, tokens, mask = _setup("tiny")
    params = _port_params("tiny")
    run = trainer.Trainer(tcfg, params, device="cpu")
    run.train_step(tokens, mask)
    assert all(np.array_equal(params[name].numpy(), np_params[name]) for name in params)


@pytest.mark.parametrize("case", ["moe", "mesh", "pp", "cuda"])
def test_trainer_refusals(case):
    """The JAX trainer's refusals (an ep axis of a dense model, an ep or
    pp that does not divide, pp with fsdp), a mesh of size > 1 with no
    ``torch.distributed`` world to run on, and ``device="cuda"`` without
    CUDA; a mesh of size 1 trains on one card."""
    _, tcfg, _, _, tokens, mask = _setup("tiny")
    params = _port_params("tiny")
    if case == "moe":
        moe = model.LlamaConfig.tiny_moe()
        moe_params = model.init_params(moe)
        with pytest.raises(ValueError, match="requires an MoE model"):
            trainer.Trainer(tcfg, params, mesh_config=MeshConfig(ep=2), device="cpu")
        with pytest.raises(ValueError, match="must divide num_experts=4"):
            trainer.Trainer(moe, moe_params, mesh_config=MeshConfig(ep=3), device="cpu")
        with pytest.raises(RuntimeError, match="needs torch.distributed"):
            trainer.Trainer(moe, moe_params, mesh_config=MeshConfig(ep=2), device="cpu")
        assert MeshConfig.from_config({"ep": 2}) == MeshConfig(ep=2)
        trainer.Trainer(moe, moe_params, device="cpu")
    elif case in ("mesh", "pp"):
        mesh = MeshConfig(dp=2, fsdp=2) if case == "mesh" else MeshConfig(pp=2)
        assert mesh.size > 1
        with pytest.raises(RuntimeError, match="needs torch.distributed"):
            trainer.Trainer(tcfg, params, mesh_config=mesh, device="cpu")
        if case == "pp":
            with pytest.raises(ValueError, match="composes only with dp"):
                trainer.Trainer(tcfg, params, mesh_config=MeshConfig(pp=2, fsdp=2), device="cpu")
            with pytest.raises(ValueError, match="must divide num_layers"):
                trainer.Trainer(tcfg, params, mesh_config=MeshConfig(pp=4), device="cpu")
        assert MeshConfig.from_config({"pipeline-parallelism": 2}) == MeshConfig(pp=2)
        trainer.Trainer(tcfg, params, mesh_config=MeshConfig(), device="cpu")  # size 1
    else:
        if torch.cuda.is_available():
            pytest.skip("checks the refusal on a machine without CUDA")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer.Trainer(tcfg, params)
