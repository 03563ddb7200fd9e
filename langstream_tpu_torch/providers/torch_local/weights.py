"""HuggingFace checkpoint directories → the port's stacked param dict
(Llama, Qwen-2, Gemma-2, Mixtral).

Port of ``langstream_tpu/providers/jax_local/weights.py`` and of the JAX
``model.load_hf_checkpoint``, with no ``safetensors`` or ``transformers``
package: the port reads both file formats itself.

- :class:`SafetensorsDir` reads the safetensors format: an 8-byte
  little-endian header length, a JSON header that gives each tensor's
  ``dtype``, ``shape`` and ``data_offsets`` (measured from the end of the
  header) beside an optional ``__metadata__``, then the raw little-endian
  bytes. One file, or shards named by ``model.safetensors.index.json``.
  Each tensor is read alone into a fresh host buffer and viewed in its
  dtype (numpy has no bf16, so the bytes cross as ``uint8``).
- :class:`TorchBinDir` reads ``pytorch_model.bin`` (or the shards that
  ``pytorch_model.bin.index.json`` names) through ``torch.load(...,
  weights_only=True, mmap=True)``.

Both loaders map the HF names onto the JAX package's layout: each layer's
``[out, in]`` matrix transposed to ``[in, out]`` and stacked on a leading
layer axis; norms (and Qwen-2's q/k/v biases) in f32; Gemma-2's four
norms; Mixtral's experts ``block_sparse_moe.experts.{e}.w1`` / ``w3`` /
``w2`` as ``w_gate`` / ``w_up`` / ``w_down`` ``[L, E, in, out]`` and its
router ``block_sparse_moe.gate`` ``[E, H]`` as ``router`` ``[L, H, E]``;
``lm_head`` unless the embeddings are tied. Each stacked leaf is
allocated once on the device and filled layer by layer, expert by
expert (a ``torch.stack`` would hold every layer twice), so at most one
source tensor is on the host at a time, and the transpose runs on the
device. A tensor stored in another dtype than the config's is cast
once, rounding to nearest even, through f32 when it is a 16-bit float:
the JAX loaders go through f32, which holds every f16 and bf16 value
exactly, so the bits are theirs.

:func:`write_safetensors` writes the format, for the port's training
checkpoints (``training/checkpoint.py``). :func:`load_checkpoint`
dispatches as the JAX provider does, and loads a directory of step
directories the port wrote through ``training.checkpoint.load_model``;
an orbax directory of the JAX package raises before any tensor is read.

:func:`load_hf_bert` reads a HuggingFace BERT directory (MiniLM and its
kin) into the encoder's params of ``embeddings.py`` with the same two
readers: the JAX ``load_hf_bert`` instantiates the ``transformers``
model for this, the port reads the same tensors.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import struct
import types
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.providers.torch_local.embeddings import EncoderConfig
from langstream_tpu_torch.providers.torch_local.model import (
    LlamaConfig,
    config_from_hf,
    validate_family_params,
)

# safetensors dtype names → torch dtypes
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "BOOL": torch.bool,
}

# the MoE leaves with an expert axis after the layer axis
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")

SAFETENSORS_INDEX = "model.safetensors.index.json"
BIN_FILE = "pytorch_model.bin"
BIN_INDEX = "pytorch_model.bin.index.json"


def write_safetensors(path: str, tensors) -> int:
    """One safetensors file of ``tensors`` ((name, tensor) pairs, on any
    device): the 8-byte little-endian length of a JSON header giving each
    tensor's dtype, shape and byte range from the header's end (padded
    with spaces to 8 bytes, as the package pads it), then each tensor's
    bytes in order, copied to the host one at a time. Returns the bytes
    written."""
    tensors = list(tensors)
    names = {dtype: name for name, dtype in SAFETENSORS_DTYPES.items()}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, tensor in tensors:
        nbytes = tensor.numel() * tensor.element_size()
        header[name] = {"dtype": names[tensor.dtype], "shape": list(tensor.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for _, tensor in tensors:
            host = tensor.detach().contiguous().cpu().reshape(-1)
            fh.write(memoryview(host.view(torch.uint8).numpy()))
            del host
    return 8 + len(raw) + offset


def read_safetensors_header(path: str) -> Tuple[Dict[str, Any], int]:
    """A safetensors file's header (``__metadata__`` dropped) and the
    byte offset its data starts at."""
    with open(path, "rb") as fh:
        prefix = fh.read(8)
        if len(prefix) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (length,) = struct.unpack("<Q", prefix)
        if length > os.path.getsize(path) - 8:
            raise ValueError(f"{path}: header length {length} runs past the end of the file")
        header = json.loads(fh.read(length))
    header.pop("__metadata__", None)
    return header, 8 + length


class SafetensorsDir:
    """Lazy tensor access over a HF checkpoint directory: one or more
    ``*.safetensors`` files, or the shards ``model.safetensors.index.json``
    maps. :meth:`get` returns a CPU tensor in the file's dtype."""

    def __init__(self, path: str) -> None:
        self.path = path
        index = os.path.join(path, SAFETENSORS_INDEX)
        if os.path.exists(index):
            with open(index) as fh:
                files = sorted(set(json.load(fh)["weight_map"].values()))
        else:
            files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
        # name -> (file, dtype name, shape, absolute [begin, end))
        self._entries: Dict[str, Tuple[str, str, Tuple[int, ...], int, int]] = {}
        for fname in files:
            file_path = os.path.join(path, fname)
            header, data_start = read_safetensors_header(file_path)
            for name, info in header.items():
                begin, end = info["data_offsets"]
                self._entries[name] = (file_path, info["dtype"], tuple(info["shape"]),
                                       data_start + begin, data_start + end)
        if not self._entries:
            raise FileNotFoundError(f"no *.safetensors under {path}")

    def keys(self) -> Iterator[str]:
        return iter(self._entries)

    def get(self, name: str) -> torch.Tensor:
        if name not in self._entries:
            raise KeyError(f"tensor {name} is not in the checkpoint at {self.path}")
        file_path, dtype_name, shape, begin, end = self._entries[name]
        if dtype_name not in SAFETENSORS_DTYPES:
            raise ValueError(f"tensor {name} has unsupported dtype {dtype_name}")
        dtype = SAFETENSORS_DTYPES[dtype_name]
        count = 1
        for dim in shape:
            count *= dim
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"tensor {name}: {end - begin} bytes for {dtype} {list(shape)}")
        buffer = torch.empty(end - begin, dtype=torch.uint8)
        with open(file_path, "rb") as fh:
            fh.seek(begin)
            if fh.readinto(buffer.numpy()) != end - begin:
                raise ValueError(f"tensor {name}: {file_path} ends inside its data")
        return buffer.view(dtype).reshape(shape)

    def close(self) -> None:
        """Nothing stays open between reads."""


class TorchBinDir:
    """Lazy tensor access over ``pytorch_model.bin`` or the shards
    ``pytorch_model.bin.index.json`` maps, each memory-mapped once it is
    first needed (``torch.load(..., weights_only=True, mmap=True)``)."""

    def __init__(self, path: str) -> None:
        self.path = path
        index = os.path.join(path, BIN_INDEX)
        if os.path.exists(index):
            with open(index) as fh:
                self._name_to_file = dict(json.load(fh)["weight_map"])
            self._files: Dict[str, Dict[str, torch.Tensor]] = {}
        elif os.path.exists(os.path.join(path, BIN_FILE)):
            self._files = {BIN_FILE: self._open(BIN_FILE)}
            self._name_to_file = dict.fromkeys(self._files[BIN_FILE], BIN_FILE)
        else:
            raise FileNotFoundError(
                f"no *.safetensors, {BIN_FILE} or {BIN_INDEX} under {path}")

    def _open(self, fname: str) -> Dict[str, torch.Tensor]:
        return torch.load(os.path.join(self.path, fname), map_location="cpu",
                          weights_only=True, mmap=True)

    def keys(self) -> Iterator[str]:
        return iter(self._name_to_file)

    def get(self, name: str) -> torch.Tensor:
        if name not in self._name_to_file:
            raise KeyError(f"tensor {name} is not in the checkpoint at {self.path}")
        fname = self._name_to_file[name]
        if fname not in self._files:
            self._files[fname] = self._open(fname)
        return self._files[fname][name]

    def close(self) -> None:
        self._files.clear()


def load_config(path: str) -> LlamaConfig:
    """A LlamaConfig from a HF ``config.json``, with the JAX loader's
    defaults for keys ``save_pretrained`` leaves out (it omits values
    equal to the architecture's default: Gemma ties its embeddings by
    default, Llama and Qwen do not)."""
    with open(os.path.join(path, "config.json")) as fh:
        hf = json.load(fh)
    hf.setdefault("rms_norm_eps", 1e-5)
    hf.setdefault("max_position_embeddings", 4096)
    hf.setdefault("tie_word_embeddings", hf.get("model_type") in ("gemma", "gemma2"))
    return config_from_hf(types.SimpleNamespace(**hf))


def param_shapes(config: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """The shape of every leaf of the config's param dict (a MoE config's
    expert weights with the expert axis after the layer axis)."""
    h, f, v, layers = config.hidden_size, config.intermediate_size, config.vocab_size, config.num_layers
    q, kv = config.num_heads * config.dims_per_head, config.num_kv_heads * config.dims_per_head
    experts = (config.num_experts,) if config.num_experts else ()
    shapes = {
        "embedding": (v, h), "wq": (layers, h, q), "wk": (layers, h, kv), "wv": (layers, h, kv),
        "wo": (layers, q, h), "w_gate": (layers, *experts, h, f), "w_up": (layers, *experts, h, f),
        "w_down": (layers, *experts, f, h), "attn_norm": (layers, h), "mlp_norm": (layers, h),
        "final_norm": (h,),
    }
    if config.num_experts:
        shapes["router"] = (layers, h, config.num_experts)
    if config.post_norms:
        shapes.update(post_attn_norm=(layers, h), post_mlp_norm=(layers, h))
    if config.qkv_bias:
        shapes.update(bq=(layers, q), bk=(layers, kv), bv=(layers, kv))
    if not config.tie_embeddings:
        shapes["lm_head"] = (h, v)
    return shapes


def _cast(tensor: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to ``dtype`` once, through f32 from a 16-bit float (exact),
    as the JAX loaders do."""
    if tensor.dtype == dtype:
        return tensor
    if tensor.dtype in (torch.float16, torch.bfloat16):
        tensor = tensor.float()
    return tensor.to(dtype)


def _load_params(store: Any, config: LlamaConfig, device: torch.device) -> Dict[str, torch.Tensor]:
    """The stacked param dict from ``store`` (``get(name)`` → a host
    tensor in the file's dtype): matrices in ``config.dtype``, norms and
    biases in f32."""
    dtype = config.dtype
    shapes = param_shapes(config)

    def fetch(name: str, transpose: bool) -> torch.Tensor:
        tensor = store.get(name).to(device)
        return tensor.t() if transpose else tensor

    def leaf(key: str, name: str, cast=dtype, transpose: bool = False) -> torch.Tensor:
        tensor = fetch(name, transpose)
        if tuple(tensor.shape) != shapes[key]:
            raise ValueError(f"{name}: shape {list(tensor.shape)}, the config wants {list(shapes[key])}")
        return _cast(tensor, cast).contiguous()

    def stacked(key: str, pattern: str, cast=dtype, transpose: bool = True) -> torch.Tensor:
        """Leaf ``key`` from one stored tensor a layer
        (``pattern.format(layer)``), or a (layer, expert) for the expert
        weights (``pattern.format(layer, expert)``)."""
        lead = 2 if config.num_experts and key in EXPERT_LEAVES else 1
        want = shapes[key][lead:]
        out = torch.empty(shapes[key], dtype=cast, device=device)
        for index in itertools.product(*map(range, shapes[key][:lead])):
            name = pattern.format(*index)
            tensor = fetch(name, transpose)
            if tuple(tensor.shape) != want:
                raise ValueError(f"{name}: shape {list(tensor.shape)}, the config wants {list(want)}")
            out[index].copy_(_cast(tensor, cast))
            del tensor
        return out

    f32 = torch.float32
    prefix = "model.layers.{}."
    if config.num_experts:
        moe = prefix + "block_sparse_moe."
        mlp = {
            "w_gate": stacked("w_gate", moe + "experts.{}.w1.weight"),
            "w_up": stacked("w_up", moe + "experts.{}.w3.weight"),
            "w_down": stacked("w_down", moe + "experts.{}.w2.weight"),
            "router": stacked("router", moe + "gate.weight"),
        }
    else:
        mlp = {
            "w_gate": stacked("w_gate", prefix + "mlp.gate_proj.weight"),
            "w_up": stacked("w_up", prefix + "mlp.up_proj.weight"),
            "w_down": stacked("w_down", prefix + "mlp.down_proj.weight"),
        }
    params = {
        "embedding": leaf("embedding", "model.embed_tokens.weight"),
        "wq": stacked("wq", prefix + "self_attn.q_proj.weight"),
        "wk": stacked("wk", prefix + "self_attn.k_proj.weight"),
        "wv": stacked("wv", prefix + "self_attn.v_proj.weight"),
        "wo": stacked("wo", prefix + "self_attn.o_proj.weight"),
        **mlp,
        "attn_norm": stacked("attn_norm", prefix + "input_layernorm.weight", f32, False),
    }
    if config.post_norms:
        # Gemma-2's sandwich: post_attention_layernorm is the POST-attn
        # norm, the feedforward pair wraps the MLP
        params["post_attn_norm"] = stacked(
            "post_attn_norm", prefix + "post_attention_layernorm.weight", f32, False)
        params["mlp_norm"] = stacked("mlp_norm", prefix + "pre_feedforward_layernorm.weight", f32, False)
        params["post_mlp_norm"] = stacked(
            "post_mlp_norm", prefix + "post_feedforward_layernorm.weight", f32, False)
    else:
        params["mlp_norm"] = stacked("mlp_norm", prefix + "post_attention_layernorm.weight", f32, False)
    params["final_norm"] = leaf("final_norm", "model.norm.weight", f32)
    if config.qkv_bias:
        for key, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            params[key] = stacked(key, prefix + f"self_attn.{proj}.bias", f32, False)
    if not config.tie_embeddings:
        params["lm_head"] = leaf("lm_head", "lm_head.weight", transpose=True)
    validate_family_params(config, params)
    return params


def _load(store_type, path: str, dtype: Any, config: Optional[LlamaConfig], device: Any
          ) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    device = resolve_device(device)
    config = dataclasses.replace(config or load_config(path), dtype=dtype)
    store = store_type(path)
    try:
        return config, _load_params(store, config, device)
    finally:
        store.close()


def load_safetensors_checkpoint(
    path: str, dtype: Any = torch.bfloat16, config: Optional[LlamaConfig] = None,
    device: Any = "cuda",
) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """(config, stacked params on ``device``) from a directory of
    safetensors files; ``config`` defaults to its ``config.json``'s."""
    return _load(SafetensorsDir, path, dtype, config, device)


def load_hf_checkpoint(
    path: str, dtype: Any = torch.bfloat16, config: Optional[LlamaConfig] = None,
    device: Any = "cuda",
) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """(config, stacked params on ``device``) from a HF directory without
    safetensors: ``pytorch_model.bin`` or its index's shards, mapped to
    the same names. The JAX ``load_hf_checkpoint`` instantiates the
    ``transformers`` model for this; the port reads the same tensors."""
    return _load(TorchBinDir, path, dtype, config, device)


def has_safetensors(path: str) -> bool:
    return os.path.isdir(path) and any(
        f.endswith(".safetensors") or f == SAFETENSORS_INDEX for f in os.listdir(path))


def is_orbax_dir(path: str) -> bool:
    """The JAX provider's test for an orbax checkpoint: numeric step
    subdirectories."""
    return os.path.isdir(path) and any(
        entry.isdigit() and os.path.isdir(os.path.join(path, entry)) for entry in os.listdir(path))


def load_checkpoint(path: str, device: Any = "cuda") -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """The JAX provider's checkpoint dispatch: safetensors files → the
    safetensors loader; numeric step subdirectories → the latest step
    through ``training.checkpoint.load_model`` when the port wrote it (a
    trainer's save directory or a ``save_model`` export), else raise
    before reading a tensor (an orbax checkpoint of the JAX package is
    not read); otherwise → the ``pytorch_model.bin`` loader in bf16."""
    if has_safetensors(path):
        return load_safetensors_checkpoint(path, device=device)
    if is_orbax_dir(path):
        from langstream_tpu_torch.training.checkpoint import committed_steps, is_step_dir, load_model

        if not is_step_dir(os.path.join(path, str(committed_steps(path)[-1]))):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint (numeric step directories the port did not "
                "write): loading it is not ported to langstream_tpu_torch (see ROADMAP.md, A11)")
        return load_model(path, device=device)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory {path} does not exist")
    return load_hf_checkpoint(path, device=device)


# BertConfig's defaults, for keys a config.json leaves out
BERT_DEFAULTS = {
    "vocab_size": 30522, "hidden_size": 768, "intermediate_size": 3072,
    "num_hidden_layers": 12, "num_attention_heads": 12, "max_position_embeddings": 512,
    "layer_norm_eps": 1e-12,
}


class _StateDict:
    """A model object's ``state_dict()`` as a tensor store."""

    def __init__(self, state: Dict[str, torch.Tensor]) -> None:
        self._state = state

    def keys(self) -> Iterator[str]:
        return iter(self._state)

    def get(self, name: str) -> torch.Tensor:
        return self._state[name]

    def close(self) -> None:
        self._state = {}


def _bert_params(store: Any, config: EncoderConfig, device: torch.device) -> Dict[str, torch.Tensor]:
    """The encoder's stacked params from a BERT ``store``: each layer's
    ``[out, in]`` matrix transposed and stacked, every leaf rounded to
    ``config.dtype`` once and the norms widened back to f32 from it (the
    JAX loader's order), ``token_type_embeddings[0]`` folded into
    ``tok_emb``. The keys may carry the ``bert.`` prefix of a task
    model's checkpoint; ``pooler.*`` and ``embeddings.position_ids`` are
    not read."""
    names = set(store.keys())
    prefix = ("bert." if "embeddings.word_embeddings.weight" not in names
              and "bert.embeddings.word_embeddings.weight" in names else "")
    dtype, f32 = config.dtype, torch.float32
    shapes = config.param_shapes()

    def fetch(name: str, transpose: bool, want) -> torch.Tensor:
        tensor = store.get(prefix + name).to(device)
        tensor = tensor.t() if transpose else tensor
        if tuple(tensor.shape) != tuple(want):
            raise ValueError(f"{prefix + name}: shape {list(tensor.shape)}, the config wants {list(want)}")
        return _cast(tensor, dtype)

    def leaf(key: str, name: str, widen: bool = False) -> torch.Tensor:
        tensor = fetch(name, False, shapes[key])
        return (tensor.to(f32) if widen else tensor).contiguous()

    def stacked(key: str, pattern: str, transpose: bool = True, widen: bool = False) -> torch.Tensor:
        out = torch.empty(shapes[key], dtype=f32 if widen else dtype, device=device)
        for layer in range(config.num_layers):
            out[layer].copy_(fetch(pattern.format(layer), transpose, shapes[key][1:]))
        return out

    p = "encoder.layer.{}."
    params = {
        "tok_emb": leaf("tok_emb", "embeddings.word_embeddings.weight"),
        "pos_emb": leaf("pos_emb", "embeddings.position_embeddings.weight"),
        "emb_norm_w": leaf("emb_norm_w", "embeddings.LayerNorm.weight", widen=True),
        "emb_norm_b": leaf("emb_norm_b", "embeddings.LayerNorm.bias", widen=True),
    }
    for key, name in (("q", "attention.self.query"), ("k", "attention.self.key"),
                      ("v", "attention.self.value"), ("o", "attention.output.dense"),
                      ("_in", "intermediate.dense"), ("_out", "output.dense")):
        params["w" + key] = stacked("w" + key, p + name + ".weight")
        params["b" + key] = stacked("b" + key, p + name + ".bias", transpose=False)
    for key, name in (("attn_norm", "attention.output.LayerNorm"), ("mlp_norm", "output.LayerNorm")):
        params[key + "_w"] = stacked(key + "_w", p + name + ".weight", transpose=False, widen=True)
        params[key + "_b"] = stacked(key + "_b", p + name + ".bias", transpose=False, widen=True)
    # token_type embeddings fold into token embeddings (single-segment use)
    token_type = "embeddings.token_type_embeddings.weight"
    if prefix + token_type in names:
        segment = _cast(store.get(prefix + token_type)[0].to(device), dtype)
        params["tok_emb"] = params["tok_emb"] + segment[None, :]
    return params


def load_hf_bert(path_or_model: Any, device: Any = "cuda", dtype: torch.dtype = torch.float32
                 ) -> Tuple[EncoderConfig, Dict[str, torch.Tensor]]:
    """(config, encoder params on ``device``) from a HuggingFace
    BERT-architecture checkpoint, as the JAX ``load_hf_bert`` gives them:
    a local directory (``config.json`` with ``model_type: bert``, and
    safetensors files or ``pytorch_model.bin``), or a model object with
    ``config`` and ``state_dict()``. A directory of another architecture
    raises before any tensor is read."""
    device = resolve_device(device)
    if isinstance(path_or_model, (str, os.PathLike)):
        path = os.fspath(path_or_model)
        with open(os.path.join(path, "config.json")) as fh:
            hf = json.load(fh)
        if hf.get("model_type") != "bert":
            raise ValueError(f"{path} holds a {hf.get('model_type')!r} model, not a BERT-architecture "
                             "encoder (model_type 'bert')")
        hf = types.SimpleNamespace(**{**BERT_DEFAULTS, **hf})
        store = SafetensorsDir(path) if has_safetensors(path) else TorchBinDir(path)
    else:
        hf = path_or_model.config
        store = _StateDict(path_or_model.state_dict())
    config = EncoderConfig(
        vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        max_positions=hf.max_position_embeddings,
        norm_eps=hf.layer_norm_eps,
        dtype=dtype,
    )
    try:
        return config, _bert_params(store, config, device)
    finally:
        store.close()
