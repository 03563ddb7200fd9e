"""The port's checkpoint loaders (``weights.py``) against the
``safetensors`` package and the JAX package's loaders, on the CPU.

- The port's own safetensors reader returns what the ``safetensors``
  package reads, bit for bit and dtype for dtype, on bf16, f16 and f32
  files, single and sharded (an index naming the shards).
- ``load_safetensors_checkpoint`` gives the JAX loader's params, carried
  across with ``convert.params_from_jax``, bit for bit, for Llama (tiny),
  Qwen-2 (biases) and Gemma-2 (four norms, tied embeddings), from bf16,
  f16 and f32 files, single and sharded; ``load_config`` gives JAX's
  config on the ``config.json`` of Llama-3.1 (``rope_scaling``), Qwen-2
  and Gemma-2.
- ``load_hf_checkpoint`` reads a ``pytorch_model.bin`` directory (a tiny
  ``transformers`` Llama saved with ``safe_serialization=False``, one
  file and sharded) into the params JAX's ``load_hf_checkpoint`` gives.
- A Mixtral directory, safetensors and ``pytorch_model.bin``, loads bit
  for bit as JAX's loaders load it; an orbax directory raises before any
  tensor is read.
- The checkpoint writer of ``chip_smoke.py`` writes files the
  ``safetensors`` package reads back.
- The provider with ``checkpoint`` serves the JAX provider's greedy and
  seeded streams; ``model`` is ignored, and ``quantization: int8``
  quantizes the loaded weights.
"""

import asyncio
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

import chip_smoke
from langstream_tpu.providers.jax_local import engine as jax_engine
from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.providers.jax_local import weights as jax_weights
from langstream_tpu.providers.jax_local.provider import JaxCompletionsService
from langstream_tpu_torch.providers.torch_local import engine, quant, weights
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

torch.set_num_threads(2)

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}

# tiny HF configs of the three dense families, as save_pretrained writes
# them (Gemma leaves tie_word_embeddings out: it is the family default)
HF_CONFIGS = {
    "tiny": {
        "model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 500000.0,
        "rms_norm_eps": 1e-5, "max_position_embeddings": 256, "tie_word_embeddings": False,
    },
    "tiny_qwen2": {
        "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"], "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 256, "tie_word_embeddings": False,
    },
    "tiny_gemma2": {
        "model_type": "gemma2", "architectures": ["Gemma2ForCausalLM"], "vocab_size": 256,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 256,
        "query_pre_attn_scalar": 16, "attn_logit_softcapping": 50.0,
        "final_logit_softcapping": 30.0, "sliding_window": 8,
        "layer_types": ["sliding_attention", "full_attention"],
    },
}


def hf_state(hf: dict, seed: int, dtype: torch.dtype) -> dict:
    """Random HF-named tensors for ``hf``'s shapes, in ``dtype``."""
    rng = np.random.default_rng(seed)
    h, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    hd = hf.get("head_dim") or h // hf["num_attention_heads"]
    q, kv = hf["num_attention_heads"] * hd, hf["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (v, h), "model.norm.weight": (h,)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({
            p + "self_attn.q_proj.weight": (q, h), p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h), p + "self_attn.o_proj.weight": (h, q),
            p + "mlp.gate_proj.weight": (f, h), p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f), p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
        })
        if hf["model_type"] == "qwen2":
            shapes.update({p + "self_attn.q_proj.bias": (q,), p + "self_attn.k_proj.bias": (kv,),
                           p + "self_attn.v_proj.bias": (kv,)})
        if hf["model_type"] == "gemma2":
            shapes.update({p + "pre_feedforward_layernorm.weight": (h,),
                           p + "post_feedforward_layernorm.weight": (h,)})
    if not hf.get("tie_word_embeddings", hf["model_type"] == "gemma2"):
        shapes["lm_head.weight"] = (v, h)
    return {name: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.3).to(dtype)
            for name, shape in shapes.items()}


def write_checkpoint(path, hf: dict, state: dict, sharded: bool) -> None:
    """``config.json`` and the tensors with the ``safetensors`` package:
    one file, or two shards and the HF index naming them."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    if not sharded:
        save_file(state, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
        return
    names = sorted(state)
    halves = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    weight_map = {}
    for fname, part in halves.items():
        save_file({name: state[name] for name in part}, os.path.join(path, fname),
                  metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(part, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as fh:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map}, fh)


def assert_params_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def assert_configs_equal(tcfg, jcfg) -> None:
    for field in dataclasses.fields(jcfg):
        if field.name != "dtype":
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name


# ---------------------------------------------------------------------- #
# the reader
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reader_equals_the_safetensors_package(tmp_path, dtype, sharded):
    """Every tensor of the files, 0-d and odd shapes and an int32 one
    beside the float ones, equals the package's read of it."""
    state = hf_state(HF_CONFIGS["tiny"], 1, DTYPES[dtype])
    state["scalar"] = torch.tensor(1.5).to(DTYPES[dtype])
    state["odd"] = torch.arange(3 * 5 * 7, dtype=torch.float32).reshape(3, 5, 7).to(DTYPES[dtype])
    state["positions"] = torch.arange(-7, 9, dtype=torch.int32)
    write_checkpoint(tmp_path, HF_CONFIGS["tiny"], state, sharded)
    store = weights.SafetensorsDir(str(tmp_path))
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    assert len(files) == (2 if sharded else 1)
    seen = set()
    for fname in files:
        with safe_open(os.path.join(tmp_path, fname), framework="pt") as fh:
            for name in fh.keys():
                want, got = fh.get_tensor(name), store.get(name)
                assert got.dtype == want.dtype and got.shape == want.shape, name
                assert torch.equal(got, want), name
                seen.add(name)
    assert seen == set(state) == set(store.keys())


def test_reader_refuses_a_truncated_file(tmp_path):
    save_file({"w": torch.ones(64, 64)}, os.path.join(tmp_path, "model.safetensors"))
    path = os.path.join(tmp_path, "model.safetensors")
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 100)
    with pytest.raises(ValueError, match="ends inside its data"):
        weights.SafetensorsDir(str(tmp_path)).get("w")


# ---------------------------------------------------------------------- #
# the loaders against JAX's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_safetensors_checkpoint_equals_jax(tmp_path, family, dtype, sharded):
    """bf16 params (the provider's dtype) from a file of each dtype, bit
    for bit equal to JAX's loader's, with its config."""
    hf = HF_CONFIGS[family]
    write_checkpoint(tmp_path, hf, hf_state(hf, 2, DTYPES[dtype]), sharded)
    jcfg, jparams = jax_weights.load_safetensors_checkpoint(str(tmp_path))
    tcfg, tparams = weights.load_safetensors_checkpoint(str(tmp_path), device="cpu")
    assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert_configs_equal(tcfg, jcfg)
    assert_params_equal(tparams, params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg))


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_f32_load_is_exact(tmp_path, dtype):
    """Loaded in f32, a 16-bit file's values cross exactly, as in JAX."""
    hf = HF_CONFIGS["tiny_qwen2"]
    write_checkpoint(tmp_path, hf, hf_state(hf, 3, DTYPES[dtype]), sharded=True)
    _, jparams = jax_weights.load_safetensors_checkpoint(str(tmp_path), dtype=jnp.float32)
    tcfg, tparams = weights.load_safetensors_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert tcfg.dtype == torch.float32
    assert_params_equal(tparams, params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg))


# realistic config.json files of the three families (the HF hub's, trimmed
# of keys neither loader reads)
CONFIG_FILES = {
    "llama-3.1-8b": {
        "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
        "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 131072, "tie_word_embeddings": False,
        "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    },
    "qwen2-7b": {
        "model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584,
        "intermediate_size": 18944, "num_hidden_layers": 28, "num_attention_heads": 28,
        "num_key_value_heads": 4, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 32768, "tie_word_embeddings": False, "sliding_window": 131072,
    },
    "gemma-2-9b": {
        "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 3584,
        "intermediate_size": 14336, "num_hidden_layers": 42, "num_attention_heads": 16,
        "num_key_value_heads": 8, "head_dim": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 8192, "query_pre_attn_scalar": 256,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0, "sliding_window": 4096,
    },
    "mistral-defaults": {  # the loader's defaults: no eps, no max positions
        "model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
        "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    },
}


@pytest.mark.parametrize("name", sorted(CONFIG_FILES))
def test_load_config_equals_jax(tmp_path, name):
    with open(os.path.join(tmp_path, "config.json"), "w") as fh:
        json.dump(CONFIG_FILES[name], fh)
    assert_configs_equal(weights.load_config(str(tmp_path)), jax_weights.load_config(str(tmp_path)))


def test_gemma2_layer_types_are_checked(tmp_path):
    hf = dict(HF_CONFIGS["tiny_gemma2"], layer_types=["full_attention", "sliding_attention"])
    with open(os.path.join(tmp_path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    for load_config in (weights.load_config, jax_weights.load_config):
        with pytest.raises(ValueError, match="layer_types"):
            load_config(str(tmp_path))


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_pytorch_model_bin_equals_jax(tmp_path, sharded):
    """A tiny ``transformers`` Llama saved as ``pytorch_model.bin`` (or
    its sharded twin with an index): JAX's ``load_hf_checkpoint`` and the
    port's give the same config and the same bf16 params; the port's
    checkpoint dispatch takes the directory to that loader."""
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(0)
    hf_model = LlamaForCausalLM(HFLlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=500000.0, tie_word_embeddings=False))
    hf_model.save_pretrained(str(tmp_path), safe_serialization=False,
                             max_shard_size="100KB" if sharded else "10GB")
    files = os.listdir(tmp_path)
    assert ("pytorch_model.bin.index.json" in files) == sharded
    assert not any(f.endswith(".safetensors") for f in files)
    jcfg, jparams = jax_model.load_hf_checkpoint(str(tmp_path))
    for tcfg, tparams in (weights.load_hf_checkpoint(str(tmp_path), device="cpu"),
                          weights.load_checkpoint(str(tmp_path), device="cpu")):
        assert_configs_equal(tcfg, jcfg)
        assert_params_equal(tparams, params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                                                     tcfg))


MIXTRAL_HF = {
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"], "vocab_size": 256,
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 256, "tie_word_embeddings": False, "num_local_experts": 4,
    "num_experts_per_tok": 2,
}


def mixtral_state(config, params) -> dict:
    """JAX ``tiny_moe`` params under the HF Mixtral names, as
    ``tests/test_weights.py`` writes them: each ``[in, out]`` matrix as
    the ``[out, in]`` tensor HF stores, the router ``[E, H]``, each
    expert's ``w1`` / ``w3`` / ``w2`` (gate, up, down) apart."""
    f32 = {name: np.asarray(leaf, np.float32) for name, leaf in params.items()}
    state = {"model.embed_tokens.weight": f32["embedding"], "model.norm.weight": f32["final_norm"],
             "lm_head.weight": f32["lm_head"].T}
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        for leaf, name in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                           ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")):
            state[p + name + ".weight"] = f32[leaf][i].T
        state[p + "block_sparse_moe.gate.weight"] = f32["router"][i].T
        for e in range(config.num_experts):
            for hf_w, ours in (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down")):
                state[p + f"block_sparse_moe.experts.{e}.{hf_w}.weight"] = f32[ours][i, e].T
        state[p + "input_layernorm.weight"] = f32["attn_norm"][i]
        state[p + "post_attention_layernorm.weight"] = f32["mlp_norm"][i]
    return {name: torch.from_numpy(np.array(value, order="C")) for name, value in state.items()}


@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_mixtral_raises_before_reading(tmp_path, form):
    """A Mixtral directory (``block_sparse_moe`` experts and router) of
    JAX's ``tiny_moe`` weights, as safetensors shards or a
    ``pytorch_model.bin``: the port's loader and its checkpoint dispatch
    give JAX's loader's config and bf16 params bit for bit (the
    safetensors loader's, or ``load_hf_checkpoint`` through
    ``transformers``), the experts stacked ``[L, E, in, out]``."""
    jcfg = jax_model.LlamaConfig.tiny_moe()
    state = mixtral_state(jcfg, jax_model.init_params(jcfg, seed=4))
    if form == "safetensors":
        write_checkpoint(tmp_path, MIXTRAL_HF, state, sharded=True)
        want_cfg, want = jax_weights.load_safetensors_checkpoint(str(tmp_path))
        load = weights.load_safetensors_checkpoint
    else:
        with open(os.path.join(tmp_path, "config.json"), "w") as fh:
            json.dump(MIXTRAL_HF, fh)
        torch.save(state, os.path.join(tmp_path, "pytorch_model.bin"))
        want_cfg, want = jax_model.load_hf_checkpoint(str(tmp_path))
        load = weights.load_hf_checkpoint
    assert want_cfg.num_experts == 4 and tuple(want["w_down"].shape) == (2, 4, 128, 64)
    for tcfg, tparams in (load(str(tmp_path), device="cpu"),
                          weights.load_checkpoint(str(tmp_path), device="cpu")):
        assert_configs_equal(tcfg, want_cfg)
        assert_params_equal(tparams, params_from_jax({k: np.asarray(v) for k, v in want.items()}, tcfg))
        assert tuple(tparams["router"].shape) == (2, 64, 4)


def test_orbax_directory_raises_before_reading(tmp_path):
    os.makedirs(os.path.join(tmp_path, "100"))
    with open(os.path.join(tmp_path, "100", "garbage"), "wb") as fh:
        fh.write(b"\xff" * 64)
    with pytest.raises(NotImplementedError, match="orbax.*A11"):
        weights.load_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        TorchCompletionsService({"checkpoint": str(tmp_path)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        weights.load_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_shape_mismatch_names_the_tensor(tmp_path):
    hf = HF_CONFIGS["tiny"]
    state = hf_state(hf, 4, torch.bfloat16)
    state["model.layers.1.mlp.up_proj.weight"] = state["model.layers.1.mlp.up_proj.weight"][:, :32].contiguous()
    write_checkpoint(tmp_path, hf, state, sharded=False)
    with pytest.raises(ValueError, match="layers.1.mlp.up_proj"):
        weights.load_safetensors_checkpoint(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------- #
# the smoke's writer
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("family", ["tiny", "tiny_qwen2", "tiny_moe"])
def test_smoke_writer_is_read_back_by_the_safetensors_package(tmp_path, family):
    """``chip_smoke.write_hf_checkpoint`` of the port's params, in shards
    with an index: the package reads every tensor back as the writer's
    HF layout of the params, and the port's and JAX's loaders both give
    the params back bit for bit."""
    from langstream_tpu_torch.providers.torch_local import model

    config = dataclasses.replace(getattr(model.LlamaConfig, family)(), dtype=torch.bfloat16)
    params = model.init_params(config, seed=5)
    if config.qkv_bias:
        params.update({name: torch.randn_like(params[name]) for name in ("bq", "bk", "bv")})
    written = chip_smoke.write_hf_checkpoint(str(tmp_path), config, params, max_shard_bytes=60_000)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    assert len(files) >= 2 and written == sum(os.path.getsize(tmp_path / f) for f in files)
    with open(tmp_path / "model.safetensors.index.json") as fh:
        weight_map = json.load(fh)["weight_map"]
    state = dict(chip_smoke.hf_tensors(config, params))
    assert sorted(weight_map) == sorted(state)
    for fname in files:
        with safe_open(str(tmp_path / fname), framework="pt") as fh:
            for name in fh.keys():
                assert weight_map[name] == fname
                assert torch.equal(fh.get_tensor(name), state[name].contiguous()), name
    tcfg, loaded = weights.load_safetensors_checkpoint(str(tmp_path), device="cpu")
    assert tcfg == config
    assert_params_equal(loaded, params)
    _, jparams = jax_weights.load_safetensors_checkpoint(str(tmp_path))
    assert_params_equal(params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tcfg), params)


# ---------------------------------------------------------------------- #
# the provider
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny-llama")
    write_checkpoint(path, HF_CONFIGS["tiny"], hf_state(HF_CONFIGS["tiny"], 6, torch.bfloat16),
                     sharded=True)
    return str(path)


ENGINE = {"max-slots": 2, "max-seq-len": 128, "decode-chunk": 4, "prefill-buckets": [32],
          "sampling-seed": 1, "supervisor": False}


def test_provider_checkpoint_streams_equal_jax(tiny_checkpoint):
    """The provider with ``checkpoint`` (``model`` names another preset,
    and is ignored): its engine holds the loaded weights, and its greedy
    and seeded streams equal the JAX provider's over the same directory."""
    config = {"checkpoint": tiny_checkpoint, "model": {"preset": "llama-3-8b"}, "engine": ENGINE}
    service = TorchCompletionsService(config, device="cpu")
    reference = JaxCompletionsService(config)
    try:
        _, loaded = weights.load_safetensors_checkpoint(tiny_checkpoint, device="cpu")
        assert service.engine.config.hidden_size == 64 and service.load_s > 0
        assert_params_equal(service.engine.params, loaded)
        prompt = service.tokenizer.encode("once upon a time")
        for kwargs in (dict(max_new_tokens=12), dict(max_new_tokens=12, temperature=0.9, seed=11)):
            got = asyncio.run(service.engine.generate(prompt, engine.SamplingParams(**kwargs)))
            want = asyncio.run(reference.engine.generate(prompt, jax_engine.SamplingParams(**kwargs)))
            assert got.tokens == want.tokens and len(got.tokens) == 12, kwargs
            np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=2e-2, atol=2e-2)
    finally:
        service.engine.stop()
        asyncio.run(reference.close())


def test_provider_quantizes_a_checkpoint(tiny_checkpoint):
    """``quantization: int8`` over a checkpoint: the engine holds
    ``quantize_params`` of the loaded weights, and serves."""
    service = TorchCompletionsService({"checkpoint": tiny_checkpoint, "quantization": "int8",
                                       "engine": ENGINE}, device="cpu")
    try:
        _, loaded = weights.load_safetensors_checkpoint(tiny_checkpoint, device="cpu")
        expected = quant.quantize_params(loaded)
        for name in quant.QUANTIZED_PARAMS:
            leaf = service.engine.params[name]
            assert isinstance(leaf, quant.QTensor), name
            assert torch.equal(leaf.q, expected[name].q) and torch.equal(leaf.scale, expected[name].scale)
        text = asyncio.run(service.get_text_completions(["once upon"], {"max-tokens": 5}))
        assert text.completion_tokens == 5
    finally:
        service.engine.stop()


def test_loaders_import_no_safetensors_or_transformers():
    """The loader reads both formats itself; the HF tokenizer imports
    ``transformers`` only inside the constructor."""
    import ast
    import pathlib

    package = pathlib.Path(weights.__file__).parent
    for name in ("weights.py", "tokenizer.py", "provider.py"):
        tree = ast.parse((package / name).read_text())
        top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))]
        modules = [alias.name for node in top if isinstance(node, ast.Import) for alias in node.names]
        modules += [node.module for node in top if isinstance(node, ast.ImportFrom)]
        assert not any(m.split(".")[0] in ("safetensors", "transformers") for m in modules), name
    everywhere = [node for node in ast.walk(ast.parse((package / "weights.py").read_text()))
                  if isinstance(node, (ast.Import, ast.ImportFrom))]
    assert not any("safetensors" in ast.dump(node) or "transformers" in ast.dump(node)
                   for node in everywhere)


def test_serve_flags_map_as_the_jax_cli():
    """``--checkpoint``, ``--tokenizer`` and ``--logprobs-top-k`` reach
    the provider config as the JAX ``serve`` maps them: a ``--model`` that
    is no preset only names the served model when a checkpoint gives the
    config, and is refused without one."""
    from langstream_tpu_torch.cli.main import build_parser, serve_config

    config = serve_config(build_parser().parse_args([
        "serve", "--model", "my-llama", "--checkpoint", "/models/x", "--tokenizer", "/models/x",
        "--logprobs-top-k", "5", "--quantization", "int8"]))
    assert config["checkpoint"] == "/models/x" and config["model"] == {}
    assert config["tokenizer"] == {"type": "hf", "path": "/models/x"}
    assert config["engine"]["logprobs-top-k"] == 5 and config["quantization"] == "int8"
    preset = serve_config(build_parser().parse_args(["serve", "--model", "llama-3-8b",
                                                     "--checkpoint", "/models/x"]))
    assert preset["model"]["preset"] == "llama-3-8b" and preset["checkpoint"] == "/models/x"
    plain = serve_config(build_parser().parse_args(["serve"]))
    assert "checkpoint" not in plain and "tokenizer" not in plain
    assert plain["engine"]["logprobs-top-k"] == 0
    with pytest.raises(SystemExit):
        serve_config(build_parser().parse_args(["serve", "--model", "my-llama"]))
