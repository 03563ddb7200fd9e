"""The GPipe schedule in the port against the JAX package's, on the CPU.

The port's ``parallel/pipeline.py`` runs one process per stage over gloo
(one pool of four ranks, ``tests/torch_mesh_worker.py``'s ``pp_cases``);
the JAX package's ``parallel/pipeline.py`` runs its ``shard_map`` over
the host devices ``tests/conftest.py`` forces. The settings are
``tests/test_pipeline.py``'s: ``tiny`` at 4 layers at pp2, pp4 and
dp2×pp2 with two microbatches, ``tiny_gemma2`` at 4 layers with
``sliding_window=4`` at pp2 (its windows follow the global layer index
across the stages), and ``tiny_moe`` at pp2 with the aux term, all f32
over the tokens ``arange(32) % vocab`` [4, 8]:

- ``pipelined_logits`` on every rank within 1e-5 of JAX's max |logit|
  and of the port's plain ``model.forward``; with ``with_aux`` the aux
  loss within 1e-5 relative of JAX's;
- ``pipelined_loss_fn``'s value within 1e-5 relative of JAX's and its
  gradient, summed over pp and dp as the trainer sums it, leaf by leaf
  within 1e-4 of JAX's max |g| (``jax.grad`` of JAX's
  ``pipelined_loss_fn`` on the same mesh);
- JAX's refusals of the batch's split, with its messages.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from langstream_tpu.parallel.mesh import build_mesh as jax_build_mesh
from langstream_tpu.parallel.mesh import shard_params as jax_shard_params
from langstream_tpu.parallel.pipeline import pipelined_logits as jax_pipelined_logits
from langstream_tpu.parallel.pipeline import pipelined_loss_fn as jax_pipelined_loss_fn
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu_torch.parallel.mesh import AxisGroup, MeshConfig, MeshGroup
from langstream_tpu_torch.parallel.pipeline import pipelined_logits
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
import torch_mesh_worker as worker

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
AUX_WEIGHT = 0.01


def _case(name, preset, mesh, layers=0, sliding_window=0, aux_weight=0.0):
    return {"name": name, "preset": preset, "mesh": mesh, "layers": layers,
            "sliding_window": sliding_window, "params": name, "microbatches": 2,
            "aux_weight": aux_weight, "size": int(np.prod(list(mesh.values())))}


CASES = [
    _case("tiny4-pp2", "tiny", {"pp": 2}, layers=4),
    _case("tiny4-pp4", "tiny", {"pp": 4}, layers=4),
    _case("tiny4-dp2-pp2", "tiny", {"dp": 2, "pp": 2}, layers=4),
    _case("gemma2-pp2", "tiny_gemma2", {"pp": 2}, layers=4, sliding_window=4),
    _case("moe-pp2", "tiny_moe", {"pp": 2}, aux_weight=AUX_WEIGHT),
]


def _close(out, ref, rel, label=""):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (label, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    worst = float(np.abs(out - ref).max())
    assert worst <= rel * scale, (label, worst, scale)


def _setup(case):
    jcfg = dataclasses.replace(getattr(jax_model.LlamaConfig, case["preset"])(), dtype=jnp.float32)
    if case["layers"]:
        jcfg = dataclasses.replace(jcfg, num_layers=case["layers"])
    if case["sliding_window"]:
        jcfg = dataclasses.replace(jcfg, sliding_window=case["sliding_window"])
    tcfg = worker.preset(case["preset"], case["layers"], case["sliding_window"])
    return jcfg, tcfg, jax_model.init_params(jcfg, seed=0)


def _inputs(vocab):
    tokens = np.arange(32, dtype=np.int32).reshape(4, 8) % vocab
    return tokens, np.ones((4, 8), dtype=bool)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    paths = {}
    for case in CASES:
        paths[case["name"]] = str(root / f"{case['name']}.npz")
        np.savez(paths[case["name"]], **{k: np.asarray(v) for k, v in _setup(case)[2].items()})
    children, wait = worker.start_pool("pp_cases", CASES, {"params": paths}, str(root), str(REPO))
    yield wait
    for child in children:
        if child.poll() is None:
            child.kill()


def _jax(case):
    """JAX's pipelined logits and aux, loss and gradient on the case's
    mesh."""
    jcfg, _, jparams = _setup(case)
    tokens, mask = (jnp.asarray(a) for a in _inputs(jcfg.vocab_size))
    mesh_config = JaxMeshConfig(**case["mesh"])
    mesh = jax_build_mesh(mesh_config, devices=jax.devices()[:mesh_config.size])
    freqs = jax_model.model_freqs(jcfg)
    with mesh:
        sharded = jax_shard_params(jparams, jax_model.logical_axes(jcfg), mesh)
        logits, aux = jax.jit(lambda p: jax_pipelined_logits(
            jcfg, p, tokens, mask, freqs, mesh, case["microbatches"], with_aux=True))(sharded)
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_pipelined_loss_fn(
            jcfg, p, tokens, mask, freqs, mesh, case["microbatches"],
            moe_aux_weight=case["aux_weight"])))(sharded)
    return (np.asarray(logits), float(aux), float(loss),
            {name: np.asarray(leaf) for name, leaf in grads.items()})


@pytest.mark.parametrize("case", CASES, ids=[case["name"] for case in CASES])
def test_pipeline_matches_jax(ranks, case):
    logits, aux, loss, grads = _jax(case)
    _, tcfg, jparams = _setup(case)
    tokens, mask = _inputs(tcfg.vocab_size)
    plain = model.forward(tcfg, params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg),
                          torch.from_numpy(tokens), mask=torch.from_numpy(mask))
    got = ranks(case["name"])
    _close(got["logits"], logits, 1e-5, "logits vs JAX")
    _close(got["logits"], plain.detach(), 1e-5, "logits vs plain")
    np.testing.assert_allclose(float(got["aux"]), aux, rtol=1e-5)
    if case["aux_weight"]:
        assert float(got["aux"]) > 0
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    assert {name[len("grads/"):] for name in got if name.startswith("grads/")} == set(grads)
    for name, grad in grads.items():
        _close(got[f"grads/{name}"], grad, 1e-4, name)


@pytest.mark.parametrize("microbatches,mesh,message", [
    (3, {"pp": 2}, "must divide batch"), (4, {"dp": 2, "pp": 2}, "must divide the microbatch size"),
], ids=["batch", "microbatch"])
def test_pipeline_refuses_what_jax_refuses(microbatches, mesh, message):
    """The batch's split, checked before any rank talks: the same
    messages as JAX's."""
    case = CASES[0]
    jcfg, tcfg, jparams = _setup(case)
    tokens, mask = _inputs(jcfg.vocab_size)
    mesh_config = JaxMeshConfig(**mesh)
    jax_mesh = jax_build_mesh(mesh_config, devices=jax.devices()[:mesh_config.size])
    with pytest.raises(ValueError, match=message) as jax_error:
        jax_pipelined_logits(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(mask),
                             jax_model.model_freqs(jcfg), jax_mesh, microbatches)
    port_config = MeshConfig(**mesh)
    groups = {(axis,): AxisGroup(0, size) for axis, size in mesh.items()}
    with pytest.raises(ValueError) as port_error:
        pipelined_logits(tcfg, {}, torch.from_numpy(tokens), torch.from_numpy(mask),
                         model.model_freqs(tcfg), MeshGroup(port_config, 0, groups), microbatches)
    assert str(port_error.value) == str(jax_error.value)
