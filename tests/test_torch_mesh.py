"""The port's mesh (``parallel/mesh.py``) and the model's sharding rules
against the JAX package's, on the CPU (JAX meshes over the host devices
``tests/conftest.py`` forces):

- ``validate_mesh``: the same error, case for case, or none;
- ``logical_axes`` leaf for leaf JAX's on Llama, Qwen-2 (biases), Gemma-2
  (tied head, sandwich norms) and the MoE ``tiny_moe``; at tp 1, 2 and 4
  the mesh axis of every dimension (``logical_to_physical``) equal to
  the entry of JAX's ``PartitionSpec``;
- each rank's shard (``shard_params``) concatenating back to the leaf,
  int8 leaves included, whose scale splits with a column-sharded weight
  and stays whole under a row-sharded one; ``quantize_logical_axes`` as
  JAX's;
- a rank's config, and the weights a rank keeps as they are drawn equal to
  the full draw's shard bit for bit (bf16 and int8);
- the backend rule, and the group of one rank.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.parallel import mesh as jax_mesh
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local import quant as jax_quant
from langstream_tpu_torch.parallel import collectives, mesh
from langstream_tpu_torch.providers.torch_local import model, quant
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

FAMILIES = {
    "llama": (model.LlamaConfig.tiny, jax_model.LlamaConfig.tiny),
    "qwen2": (model.LlamaConfig.tiny_qwen2, jax_model.LlamaConfig.tiny_qwen2),
    "gemma2": (model.LlamaConfig.tiny_gemma2, jax_model.LlamaConfig.tiny_gemma2),
    "moe": (model.LlamaConfig.tiny_moe, jax_model.LlamaConfig.tiny_moe),
}

VALIDATE_CASES = [
    (dict(tp=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=128)),
    (dict(tp=4), dict(num_heads=4, num_kv_heads=2, intermediate_size=128)),
    (dict(tp=2), dict(num_heads=6, num_kv_heads=2, intermediate_size=128)),
    (dict(tp=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=129)),
    (dict(ep=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=128)),
    (dict(ep=3), dict(num_heads=4, num_kv_heads=2, intermediate_size=128, num_experts=4)),
    (dict(ep=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=128, num_experts=4)),
    (dict(pp=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=128)),
    (dict(pp=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=128, num_layers=3,
                      allow_pp=True)),
    (dict(pp=2, tp=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=128, allow_pp=True)),
    (dict(pp=2, dp=2), dict(num_heads=4, num_kv_heads=2, intermediate_size=128, num_layers=4,
                            allow_pp=True)),
]


@pytest.mark.parametrize("axes,model_kwargs", VALIDATE_CASES,
                         ids=[f"case{i}" for i in range(len(VALIDATE_CASES))])
def test_validate_mesh_matches_jax(axes, model_kwargs):
    def outcome(module):
        try:
            module.validate_mesh(module.MeshConfig(**axes), **model_kwargs)
        except ValueError as error:
            return str(error)
        return None

    assert outcome(mesh) == outcome(jax_mesh)


def _jax_mesh(tp):
    return jax_mesh.build_mesh(jax_mesh.MeshConfig(tp=tp), devices=jax.devices()[:tp])


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logical_axes_and_splits_match_jax(family, tp):
    port_config, jax_config = (make() for make in FAMILIES[family])
    axes, jax_axes = model.logical_axes(port_config), jax_model.logical_axes(jax_config)
    assert sorted(axes) == sorted(jax_axes)
    config = mesh.MeshConfig(tp=tp)
    for name, leaf_axes in axes.items():
        assert leaf_axes.names == jax_axes[name].names, name
        spec = jax_mesh.logical_to_physical(jax_axes[name].names, _jax_mesh(tp))
        want = tuple(spec) + (None,) * (len(leaf_axes.names) - len(tuple(spec)))
        assert mesh.logical_to_physical(leaf_axes.names, config) == want, name
        assert mesh.split_dim(leaf_axes, config) == (want.index("tp") if "tp" in want else None)


def _port_params(family, int8=False):
    port_config, jax_config = (make() for make in FAMILIES[family])
    jparams = jax_model.init_params(jax_config, seed=3)
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, port_config)
    if int8:
        params = quant.quantize_params(params, port_config.num_experts)
    return port_config, jparams, params


@pytest.mark.parametrize("int8", [False, True], ids=["model-dtype", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rank_shards_concatenate_back(family, int8):
    config, _, params = _port_params(family, int8)
    tp = 2
    axes = model.rank_axes(config, params)
    shards = [mesh.shard_params(params, axes, mesh.MeshConfig(tp=tp), rank) for rank in range(tp)]
    for name, leaf in params.items():
        parts = [shard[name] for shard in shards]
        if isinstance(leaf, quant.QTensor):
            pairs = (("q", axes[name].q), ("scale", axes[name].scale))
            tensors = [(getattr(leaf, attr), [getattr(p, attr) for p in parts], a) for attr, a in pairs]
        else:
            tensors = [(leaf, parts, axes[name])]
        for whole, pieces, leaf_axes in tensors:
            dim = mesh.split_dim(leaf_axes, mesh.MeshConfig(tp=tp))
            if dim is None:
                assert all(piece is whole for piece in pieces), name
            else:
                assert all(piece.shape[dim] == whole.shape[dim] // tp for piece in pieces), name
                assert torch.equal(torch.cat(pieces, dim=dim), whole), name
    if int8:
        # a column-sharded weight's scale splits with it; a row-sharded
        # one's (the contraction axis split) stays whole
        assert shards[0]["wq"].scale.shape[-1] == params["wq"].scale.shape[-1] // tp
        assert torch.equal(shards[1]["wo"].scale, params["wo"].scale)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_logical_axes_matches_jax(family):
    config, jparams, params = _port_params(family, int8=True)
    jq = jax_quant.quantize_params(jparams, config.num_experts)
    port = quant.quantize_logical_axes(model.logical_axes(config), params)
    ref = jax_quant.quantize_logical_axes(jax_model.logical_axes(FAMILIES[family][1]()), jq)
    assert sorted(port) == sorted(ref)
    for name, axes in port.items():
        if isinstance(axes, quant.QTensor):
            assert isinstance(ref[name], jax_quant.QTensor), name
            assert (axes.q.names, axes.scale.names) == (ref[name].q.names, ref[name].scale.names)
        else:
            assert axes.names == ref[name].names, name


def test_rank_config_pins_head_dim():
    """Llama-3-8B at tp=2: 16 heads over 4 kv heads of 128, half the
    intermediate width, the vocabulary whole; Gemma-2's head_dim of 256
    pinned too (``hidden // heads`` would give 2304 // 4)."""
    group = mesh.AxisGroup(1, 2)
    rank = model.rank_config(model.LlamaConfig.llama3_8b(), group)
    assert (rank.num_heads, rank.num_kv_heads, rank.dims_per_head) == (16, 4, 128)
    assert (rank.intermediate_size, rank.vocab_size) == (7168, 128256)
    assert rank.tp_group is group and rank == dataclasses.replace(rank, tp_group=None)
    assert isinstance(rank, model.LlamaConfig) and model.LlamaConfig.llama3_8b().__class__ is model.LlamaConfig
    gemma = model.rank_config(model.LlamaConfig.gemma2_2b(), group)
    assert (gemma.num_heads, gemma.dims_per_head) == (4, 256)
    with pytest.raises(ValueError, match="vocab_size"):
        model.rank_config(dataclasses.replace(model.LlamaConfig.tiny(), vocab_size=255), group)


@pytest.mark.parametrize("weights", ["bf16", "int8", "int8-direct"])
def test_weights_kept_as_drawn_equal_the_full_draws_shard(weights):
    """A rank drawing with ``keep`` holds, bit for bit, its shard of the
    full draw (the same generator sequence), through ``init_params``,
    ``init_quantized_params`` by quantizing the draws, and its direct
    int8 draw; ``rank_params`` passes an already-sharded dict through."""
    config = dataclasses.replace(model.LlamaConfig.tiny(), dtype=torch.bfloat16)
    tp_mesh = mesh.MeshConfig(tp=2)
    draw = {"bf16": model.init_params, "int8": quant.init_quantized_params,
            "int8-direct": functools.partial(quant.init_quantized_params, direct=True)}[weights]
    full = draw(config, seed=5)
    for rank in range(2):
        kept = draw(config, seed=5, keep=lambda name, leaf: model.shard_leaf(config, name, leaf,
                                                                            tp_mesh, rank))
        want = model.rank_params(config, full, tp_mesh, rank)
        assert sorted(kept) == sorted(want)
        for name in want:
            a, b = kept[name], want[name]
            if isinstance(b, quant.QTensor):
                assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), name
            else:
                assert torch.equal(a, b), name
        assert model.rank_params(config, kept, tp_mesh, rank) is kept


def test_backend_rule_and_group_of_one():
    assert mesh.backend_for(["h:cpu", "h:cpu"]) == "gloo"
    assert mesh.backend_for(["h:GPU-0", "h:GPU-0"]) == "gloo"
    assert mesh.backend_for(["h:GPU-0", "h:GPU-1"]) == "nccl"
    assert mesh.backend_for(["a:GPU-0", "b:GPU-0"]) == "nccl"
    one = mesh.build_group(mesh.MeshConfig(), "cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert (one.rank, one.size) == (0, 1)
    assert collectives.reduce_sum(x, one) is x and collectives.enter(x, one) is x
    assert collectives.gather(x, one, 1, reduce=False) is x
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh.require_serving_mesh(mesh.MeshConfig(dp=2, tp=2))
    mesh.require_serving_mesh(mesh.MeshConfig(tp=8))
