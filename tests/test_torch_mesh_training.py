"""Training on the mesh in the port against the JAX package, on the CPU.

The port runs one process per rank over gloo (one pool of four ranks,
``tests/torch_mesh_worker.py``'s ``mesh_cases``, started once by
``parallel.launch``; a case on two ranks runs on the first two); the JAX
package runs its SPMD ``Trainer`` over the host devices
``tests/conftest.py`` forces. The same JAX-drawn f32 params and
numpy-seeded batch (B 4 × T 16, one row padded) go through both:

- three ``Trainer`` steps (lr 1e-3, weight decay 0.1, a ``grad_clip``
  that clips on step 1) on ``tiny`` at dp2, fsdp2, tp2, dp2×fsdp2 and
  fsdp2×tp2; ``tiny`` at 4 layers at pp2, pp4 and dp2×pp2 (two
  microbatches, ``tests/test_pipeline.py``'s settings); ``tiny_gemma2``
  at 4 layers with ``sliding_window=4`` at pp2; ``tiny`` at sp2 (the
  JAX trainer replicates over sp); ``tiny_qwen2`` at tp2;
  ``tiny_moe`` (4 experts) at ep2 and dp2×ep2, where one routing group of
  64 tokens spans both dp ranks, and at fsdp2×ep2, tp2×ep2 and pp2×ep2
  (the experts gathered over ep in each stage; one microbatch, whose
  routing groups are one card's). Each is held to
  ``tests/test_torch_training.py``'s rules against the JAX ``Trainer`` on
  the same mesh and the port's one-card trainer: losses within 1e-5
  relative, each leaf's move within 1e-3 of the reference's largest at
  every coordinate but the few (at most 0.1% of the model, and a quarter
  of any leaf: Qwen-2's key bias has 10 of 64) where the two references
  already part: whose first clipped gradient JAX's mesh run (from its
  AdamW ``mu``) and the port's one-card run round apart by more than
  1e-3 of its size, or where the two frameworks' one-card runs move
  apart by more than that tolerance. The run under test has no say in
  which coordinates are left out, and its first gradient is held to
  JAX's at every coordinate (1e-3 of the leaf's largest). The
  optimizer's count is 3, and every leaf is bit for bit the same on the
  ranks that hold the same slice of it;
- the refusals: every mesh the JAX trainer refuses, with its message;
- a dp2×fsdp2 checkpoint restored at pp2, at tp2 and on one card: the
  params bit for bit the writing trainer's (gathered), the next loss
  within 1e-5 of its; the provider serves the directory at tp=1 with
  those params.
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.training import trainer as jax_trainer
from langstream_tpu_torch.parallel.mesh import MeshConfig
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService
from langstream_tpu_torch.training import trainer
import torch_mesh_worker as worker

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
LR, DECAY = 1e-3, 0.1


def _case(name, preset, mesh, layers=0, sliding_window=0, params=None, microbatches=2,
          **extra):
    params = params or f"{preset}-{layers}-{sliding_window}"
    train = {"learning_rate": LR, "weight_decay": DECAY, "remat": True}
    if mesh.get("pp"):
        train["num_microbatches"] = microbatches
    size = int(np.prod(list(mesh.values()))) if mesh else 1
    return {"name": name, "preset": preset, "mesh": mesh, "layers": layers,
            "sliding_window": sliding_window, "params": params, "train": train, "size": size,
            **extra}


CASES = [
    _case("tiny-dp2", "tiny", {"dp": 2}),
    _case("tiny-fsdp2", "tiny", {"fsdp": 2}),
    _case("tiny-tp2", "tiny", {"tp": 2}),
    _case("tiny-dp2-fsdp2", "tiny", {"dp": 2, "fsdp": 2}, checkpoint=True),
    _case("tiny-fsdp2-tp2", "tiny", {"fsdp": 2, "tp": 2}),
    _case("tiny4-pp2", "tiny", {"pp": 2}, layers=4),
    _case("tiny4-pp4", "tiny", {"pp": 4}, layers=4),
    _case("tiny4-dp2-pp2", "tiny", {"dp": 2, "pp": 2}, layers=4),
    _case("gemma2-pp2", "tiny_gemma2", {"pp": 2}, layers=4, sliding_window=4),
    _case("tiny-sp2", "tiny", {"sp": 2}),
    _case("qwen2-tp2", "tiny_qwen2", {"tp": 2}),
    _case("moe-ep2", "tiny_moe", {"ep": 2}),
    _case("moe-dp2-ep2", "tiny_moe", {"dp": 2, "ep": 2}),
    _case("moe-fsdp2-ep2", "tiny_moe", {"fsdp": 2, "ep": 2}),
    _case("moe-tp2-ep2", "tiny_moe", {"tp": 2, "ep": 2}),
    # one microbatch: GPipe routes each microbatch's tokens alone (JAX's
    # too), so at one the routing groups are one card's
    _case("moe-pp2-ep2", "tiny_moe", {"pp": 2, "ep": 2}, microbatches=1),
]
# where the dp2×fsdp2 checkpoint is read back
RESTORES = {"pp2": {"pp": 2}, "tp2": {"tp": 2}, "one-card": {}}


def _close(out, ref, rel, label=""):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (label, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    worst = float(np.abs(out - ref).max())
    assert worst <= rel * scale, (label, worst, scale)


@functools.lru_cache(maxsize=None)
def _setup(key):
    """(JAX config, port config, JAX params, numpy params) of one params
    key: f32, with non-zero Qwen-2 biases."""
    name, layers, sliding_window = key.split("-")
    jcfg = dataclasses.replace(getattr(jax_model.LlamaConfig, name)(), dtype=jnp.float32)
    if int(layers):
        jcfg = dataclasses.replace(jcfg, num_layers=int(layers))
    if int(sliding_window):
        jcfg = dataclasses.replace(jcfg, sliding_window=int(sliding_window))
    tcfg = worker.preset(name, int(layers), int(sliding_window))
    jparams = jax_model.init_params(jcfg, seed=3)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        for leaf in ("bq", "bk", "bv"):
            jparams[leaf] = jnp.asarray(0.1 * rng.standard_normal(jparams[leaf].shape,
                                                                  dtype=np.float32))
    return jcfg, tcfg, jparams, {k: np.asarray(v) for k, v in jparams.items()}


@functools.lru_cache(maxsize=None)
def _port_grads(key):
    """The gradient of the port's one-card ``loss_fn`` at the params."""
    _, tcfg, _, np_params = _setup(key)
    params = {k: v.requires_grad_() for k, v in params_from_jax(np_params, tcfg).items()}
    tokens, mask = worker.train_batch(tcfg.vocab_size)
    loss = trainer.loss_fn(tcfg, params, torch.from_numpy(tokens), torch.from_numpy(mask),
                           model.model_freqs(tcfg))
    loss.backward()
    return {name: p.grad.numpy() for name, p in params.items()}


def _grad_clip(key):
    """Half the first step's gradient norm: step 1 clips."""
    grads = _port_grads(key)
    return round(0.5 * float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                         for g in grads.values()))), 6)


def _train(case):
    return {**case["train"], "grad_clip": _grad_clip(case["params"])}


@functools.lru_cache(maxsize=None)
def _jax_run(key, mesh=(), microbatches=2):
    """The JAX ``Trainer`` on a mesh (``(axis, size)`` pairs; one device
    when empty): losses, the first step's clipped gradient (its AdamW
    ``mu`` over ``1 - b1``) and the params after three steps."""
    jcfg, _, jparams, _ = _setup(key)
    tokens, mask = worker.train_batch(jcfg.vocab_size)
    mesh = dict(mesh)
    config = jax_trainer.TrainConfig(**_train(_case("", "", mesh, params=key,
                                                    microbatches=microbatches)))
    run = jax_trainer.Trainer(jcfg, dict(jparams), mesh_config=JaxMeshConfig(**mesh),
                              train_config=config)
    losses = [run.train_step(tokens, mask)]
    adam = next(state for state in jax.tree_util.tree_leaves(
        run.opt_state, is_leaf=lambda node: hasattr(node, "mu")) if hasattr(state, "mu"))
    grads = {name: np.asarray(leaf) / np.float32(1 - config.b1) for name, leaf in adam.mu.items()}
    losses += [run.train_step(tokens, mask) for _ in range(2)]
    return losses, grads, {name: np.asarray(leaf) for name, leaf in run.params.items()}


@functools.lru_cache(maxsize=None)
def _port_run(key):
    """The port's one-card trainer: losses, the first (clipped)
    gradients and the params after three steps."""
    _, tcfg, _, np_params = _setup(key)
    tokens, mask = worker.train_batch(tcfg.vocab_size)
    run = trainer.Trainer(tcfg, params_from_jax(np_params, tcfg),
                          train_config=trainer.TrainConfig(**_train(_case("", "", {}, params=key))),
                          device="cpu")
    losses = [run.train_step(tokens, mask)]
    grads = {name: p.grad.numpy().copy() for name, p in run.params.items()}
    losses += [run.train_step(tokens, mask) for _ in range(2)]
    return losses, grads, {name: p.detach().numpy() for name, p in run.params.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The pool started once with every case (the restores after the
    checkpoint they read), the JAX references computed meanwhile by the
    tests: yields a function that returns one case's saved outputs."""
    root = tmp_path_factory.mktemp("mesh")
    paths = {}
    for case in CASES:
        if case["params"] not in paths:
            paths[case["params"]] = str(root / f"{case['params']}.npz")
            np.savez(paths[case["params"]], **_setup(case["params"])[3])
    source = next(case for case in CASES if case.get("checkpoint"))
    checkpoint = str(root / "checkpoint")
    source["checkpoint"] = checkpoint
    cases = [dict(case, train=_train(case)) for case in CASES]
    cases += [_case(f"restore-{name}", "tiny", mesh, restore=checkpoint, train=_train(source))
              for name, mesh in RESTORES.items()]
    children, wait = worker.start_pool("mesh_cases", cases, {"params": paths}, str(root), str(REPO))
    yield wait, checkpoint
    for child in children:
        if child.poll() is None:
            child.kill()


@pytest.mark.parametrize("case", CASES, ids=[case["name"] for case in CASES])
def test_mesh_trainer_matches_jax(ranks, case):
    wait, _ = ranks
    _, tcfg, _, np_params = _setup(case["params"])
    want_losses, jax_grads, want_params = _jax_run(
        case["params"], tuple(case["mesh"].items()), case["train"].get("num_microbatches", 2))
    jax_one = _jax_run(case["params"])[2]
    port_losses, port_grads, port_params = _port_run(case["params"])
    got = wait(case["name"])
    losses = got["losses"][:3]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, port_losses, rtol=1e-5)
    assert int(got["count"]) == 3
    assert str(got["differ"]) == "[]", str(got["differ"])
    # the coordinates where the references part, decided without the run
    # under test: whose first (clipped) gradient JAX's mesh run and the
    # port's one-card run round apart (Adam normalizes each coordinate by
    # its own gradient), or where the two frameworks' one-card runs already
    # move apart (a coordinate whose later gradients Adam amplifies so).
    # The first gradient is held at every coordinate.
    unresolved = {}
    for name, grad in port_grads.items():
        start = np_params[name]
        moved, jax_moved = port_params[name] - start, jax_one[name] - start
        unresolved[name] = ((np.abs(grad - jax_grads[name]) > 1e-3 * np.abs(jax_grads[name]))
                            | (np.abs(moved - jax_moved) > 1e-3 * np.abs(jax_moved).max()))
        assert int(unresolved[name].sum()) <= 0.25 * grad.size, (name, int(unresolved[name].sum()))
    total = sum(g.size for g in port_grads.values())
    assert sum(int(u.sum()) for u in unresolved.values()) <= 1e-3 * total
    for name, start in np_params.items():
        skip = unresolved[name]
        moved = got[f"params/{name}"] - start
        for label, reference in (("JAX", want_params[name]), ("one card", port_params[name])):
            _close(np.where(skip, 0, moved), np.where(skip, 0, reference - start), 1e-3,
                   f"{name} vs {label}")
        _close(got[f"grads/{name}"], jax_grads[name], 1e-3, f"{name}'s first gradient")


REFUSED = [
    ("tiny", {"tp": 3}), ("tiny", {"ep": 2}), ("tiny_moe", {"ep": 3}), ("tiny", {"pp": 4}),
    ("tiny", {"pp": 2, "fsdp": 2}), ("tiny", {"pp": 2, "tp": 2}), ("tiny", {"pp": 2, "sp": 2}),
]


@pytest.mark.parametrize("preset,mesh", REFUSED,
                         ids=["-".join(f"{k}{v}" for k, v in m.items()) + f"-{p}" for p, m in REFUSED])
def test_trainer_refuses_what_jax_refuses(preset, mesh):
    jcfg = getattr(jax_model.LlamaConfig, preset)()
    with pytest.raises(ValueError) as jax_error:
        jax_trainer.Trainer(jcfg, jax_model.init_params(jcfg), mesh_config=JaxMeshConfig(**mesh))
    tcfg = getattr(model.LlamaConfig, preset)()
    with pytest.raises(ValueError) as port_error:
        trainer.Trainer(tcfg, model.init_params(tcfg), mesh_config=MeshConfig(**mesh), device="cpu")
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("target", list(RESTORES))
def test_checkpoint_restores_across_meshes(ranks, target):
    wait, checkpoint = ranks
    written = wait("tiny-dp2-fsdp2")
    got = wait(f"restore-{target}")
    assert int(got["step"]) == 3
    for name in model.init_params(model.LlamaConfig.tiny()):
        assert np.array_equal(got[f"params/{name}"], written[f"params/{name}"]), name
    np.testing.assert_allclose(got["losses"][0], written["losses"][3], rtol=1e-5)
    if target == "one-card":
        svc = TorchCompletionsService({
            "checkpoint": checkpoint, "tokenizer": {"type": "byte"},
            "engine": {"max-slots": 2, "max-seq-len": 64},
        }, device="cpu")
        try:
            assert svc.engine.config == worker.preset("tiny")
            for name, leaf in svc.engine.params.items():
                assert np.array_equal(leaf.numpy(), written[f"params/{name}"]), name
        finally:
            svc.close()
