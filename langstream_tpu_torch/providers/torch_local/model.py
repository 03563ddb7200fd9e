"""Llama-family decoder in PyTorch over a stacked-parameter dict.

Port of ``langstream_tpu/providers/jax_local/model.py`` for the dense and
paged serving paths and the differentiable forward, dense and
mixture-of-experts (Mixtral). Parameters are a dict of tensors with the
per-layer weights stacked on a leading layer axis, in the JAX package's
``[in, out]`` layout, so ``x @ W`` is what its
``qeinsum("...h,hd->...d")`` computed and parameters carry across
unchanged (see ``convert.py``). The ``lax.scan`` over layers is a Python
loop.

Attention goes through the kernel wrappers in ``ops/``: on the card they
launch the hand-written CUDA kernels, on the CPU they run the plain
versions. Dense prefill-at-offset attention is plain PyTorch everywhere,
as the JAX package leaves it to XLA. The matrix products outside
attention stay ``torch.matmul``, through ``quant.qmatmul``: a weight may
be a :class:`~langstream_tpu_torch.providers.torch_local.quant.QTensor`
(weight-only int8, ``quantize="int8"`` in the engine), contracted against
its int8 values with the scale on the output, in every call kind.

A config with ``num_experts`` takes the MoE MLP of ``ops/moe.py``: every
serving call in its exact regime (every expert on every token, nothing
dropped), :func:`forward` in the capacity regime unless ``dropless``, as
the JAX package trains. Its expert weights ``[L, E, H, F]`` / ``[L, E, F,
H]`` and router ``[L, H, E]`` stay in the model dtype under int8 weights,
as in the JAX package.

:func:`forward` is the cache-free training and scoring path: the JAX
``apply_layers`` loop with autograd, each stacked leaf taken apart once
(:func:`unstack_layers`), attention through the plain
``prefill_attention``, as the JAX package differentiates it.

The int8 KV cache (``kv_quant``) is chosen by the ``k_scale`` leaf, as in
the JAX package: each layer's new k/v rows are quantized once
(``quantize_kv``), written with their scales, and every attention seam
takes the int8 twin of its function (the JAX ``_*_attn_quant``s).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from langstream_tpu_torch.ops.attention import (
    chunk_attention,
    chunk_attention_quant,
    paged_chunk_attention,
    paged_chunk_attention_quant,
    paged_decode_attention,
    paged_decode_attention_quant,
    paged_write_rows,
    prefill_attention,
    quantize_kv,
)
from langstream_tpu_torch.ops.decode_kernel import (
    flash_decode_attention,
    flash_decode_attention_quant,
)
from langstream_tpu_torch.ops.flash_attention import (
    flash_prefill_attention,
    flash_prefill_attention_quant,
)
from langstream_tpu_torch.ops.paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_quant,
    ragged_q_paged_attention,
    ragged_q_paged_attention_quant,
)
from langstream_tpu_torch.ops.moe import moe_mlp
from langstream_tpu_torch.ops.norms import rms_norm
from langstream_tpu_torch.parallel import collectives
from langstream_tpu_torch.parallel.mesh import L
from langstream_tpu_torch.ops.rope import apply_rope, rope_frequencies
from langstream_tpu_torch.providers.torch_local.quant import qmatmul


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Field for field the JAX package's ``LlamaConfig``; ``dtype`` is a
    torch dtype."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    # Mixture-of-experts (Mixtral family). 0 = dense SwiGLU MLP;
    # capacity_factor is the training regime's (serving never drops).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    capacity_factor: float = 2.0
    # Gemma-2 family extensions — every default is the Llama behavior.
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sliding_window: int = 0       # >0: even layers slide, odd layers full
    norm_plus_one: bool = False   # RMSNorm applies (1 + w)
    post_norms: bool = False      # sandwich norms after attn + mlp blocks
    scale_embedding: bool = False  # x *= sqrt(hidden) after the lookup
    act: str = "silu"             # MLP gate activation: silu | gelu_tanh
    qkv_bias: bool = False        # q/k/v projection biases (Qwen-2 family)
    rope_scaling: Optional[Tuple] = None
    dtype: Any = torch.bfloat16
    # The JAX package's Pallas gates; kept so configs round-trip. The
    # port's kernels are gated by the tensors' device alone.
    use_flash: bool = True
    flash_interpret: bool = False

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def llama3_8b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8,
            rope_theta=500000.0, max_seq_len=max_seq_len,
        )

    @classmethod
    def llama3_70b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8,
            rope_theta=500000.0, max_seq_len=max_seq_len,
        )

    @classmethod
    def llama3_1b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192,
            num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
            rope_theta=500000.0, max_seq_len=max_seq_len, tie_embeddings=True,
            rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192.0),
        )

    @classmethod
    def llama31_8b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return dataclasses.replace(
            cls.llama3_8b(max_seq_len),
            rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0),
        )

    @classmethod
    def mixtral_8x7b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8,
            rope_theta=1e6, max_seq_len=max_seq_len,
            num_experts=8, num_experts_per_tok=2,
        )

    @classmethod
    def gemma2_2b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=256000, hidden_size=2304, intermediate_size=9216,
            num_layers=26, num_heads=8, num_kv_heads=4, head_dim=256,
            rope_theta=10000.0, max_seq_len=max_seq_len, norm_eps=1e-6,
            tie_embeddings=True, attn_logit_softcap=50.0,
            final_logit_softcap=30.0, query_pre_attn_scalar=256.0,
            sliding_window=4096, norm_plus_one=True, post_norms=True,
            scale_embedding=True, act="gelu_tanh",
        )

    @classmethod
    def gemma2_9b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return dataclasses.replace(
            cls.gemma2_2b(max_seq_len), hidden_size=3584,
            intermediate_size=14336, num_layers=42, num_heads=16,
            num_kv_heads=8, head_dim=256,
        )

    @classmethod
    def tiny_gemma2(cls, max_seq_len: int = 256) -> "LlamaConfig":
        return cls(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            rope_theta=10000.0, max_seq_len=max_seq_len, norm_eps=1e-6,
            tie_embeddings=True, attn_logit_softcap=50.0,
            final_logit_softcap=30.0, query_pre_attn_scalar=16.0,
            sliding_window=8, norm_plus_one=True, post_norms=True,
            scale_embedding=True, act="gelu_tanh", dtype=torch.float32,
        )

    @classmethod
    def qwen25_7b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1e6, max_seq_len=max_seq_len, norm_eps=1e-6,
            qkv_bias=True,
        )

    @classmethod
    def qwen25_0_5b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=151936, hidden_size=896, intermediate_size=4864,
            num_layers=24, num_heads=14, num_kv_heads=2, head_dim=64,
            rope_theta=1e6, max_seq_len=max_seq_len, norm_eps=1e-6,
            qkv_bias=True, tie_embeddings=True,
        )

    @classmethod
    def tiny_qwen2(cls, max_seq_len: int = 256) -> "LlamaConfig":
        return dataclasses.replace(cls.tiny(max_seq_len), qkv_bias=True)

    @classmethod
    def tiny(cls, max_seq_len: int = 256) -> "LlamaConfig":
        return cls(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2,
            max_seq_len=max_seq_len, dtype=torch.float32,
        )

    @classmethod
    def tiny_moe(cls, max_seq_len: int = 256) -> "LlamaConfig":
        return dataclasses.replace(
            cls.tiny(max_seq_len), num_experts=4, num_experts_per_tok=2
        )

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "LlamaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        # an empty value (an app's placeholder with an empty default, as
        # `num_layers: "${globals.num-layers:-}"`) leaves the field unset
        clean = {k.replace("-", "_"): v for k, v in config.items() if v != ""}
        if isinstance(clean.get("dtype"), str):
            # checkpoints and configs spell the dtype by name ("bfloat16")
            clean["dtype"] = getattr(torch, clean["dtype"])
        if clean.get("rope_scaling") is not None:
            clean["rope_scaling"] = normalize_rope_scaling(clean["rope_scaling"])
        presets = {
            "llama-3-8b": cls.llama3_8b, "llama-3-70b": cls.llama3_70b,
            "llama-3.1-8b": cls.llama31_8b,
            "llama-3-1b": cls.llama3_1b, "tiny": cls.tiny,
            "mixtral-8x7b": cls.mixtral_8x7b, "tiny-moe": cls.tiny_moe,
            "gemma-2-2b": cls.gemma2_2b, "gemma-2-9b": cls.gemma2_9b,
            "tiny-gemma2": cls.tiny_gemma2,
            "qwen-2.5-7b": cls.qwen25_7b, "qwen-2.5-0.5b": cls.qwen25_0_5b,
            "tiny-qwen2": cls.tiny_qwen2,
        }
        preset = clean.pop("preset", None)
        if preset:
            base = presets[preset]()
            return dataclasses.replace(
                base, **{k: v for k, v in clean.items() if k in known}
            )
        return cls(**{k: v for k, v in clean.items() if k in known})

    def num_params(self) -> int:
        head_dim = self.dims_per_head
        attn = self.hidden_size * head_dim * (2 * self.num_heads + 2 * self.num_kv_heads)
        mlp = 3 * self.hidden_size * self.intermediate_size
        if self.num_experts:
            mlp = mlp * self.num_experts + self.hidden_size * self.num_experts
        per_layer = attn + mlp + 2 * self.hidden_size
        emb = self.vocab_size * self.hidden_size * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + emb + self.hidden_size


def normalize_rope_scaling(value: Any) -> Optional[Tuple]:
    """HF configs carry rope scaling as a dict; the config field is a
    hashable tuple ("llama3", factor, low, high, original_max). Only the
    llama3 type is supported — anything else raises."""
    if value is None or isinstance(value, tuple):
        return value
    if isinstance(value, list):
        return tuple(value)
    value = {k.replace("-", "_"): v for k, v in value.items()}
    kind = value.get("rope_type") or value.get("type")
    if kind == "default":
        return None
    if kind != "llama3":
        raise ValueError(f"unsupported rope scaling type: {kind!r}")
    keys = (
        "factor", "low_freq_factor", "high_freq_factor",
        "original_max_position_embeddings",
    )
    missing = [key for key in keys if key not in value]
    if missing:
        raise ValueError(f"llama3 rope_scaling missing {missing}")
    return ("llama3", *(float(value[key]) for key in keys))


def config_from_hf(hf_config: Any) -> LlamaConfig:
    """The JAX package's ``model.config_from_hf``: a HuggingFace config
    (an object with the ``config.json`` keys as attributes) → LlamaConfig.
    Qwen-2 adds the q/k/v biases; Gemma-2 its softcaps, query scalar,
    sliding window (even layers slide, odd layers full, checked against
    ``layer_types``), sandwich norms and tanh-GELU; ``num_local_experts``
    (Mixtral) becomes ``num_experts``."""
    rope_scaling = normalize_rope_scaling(getattr(hf_config, "rope_scaling", None))
    model_type = getattr(hf_config, "model_type", "")
    gemma2 = model_type == "gemma2"
    if gemma2:
        layer_types = getattr(hf_config, "layer_types", None)
        if layer_types is not None:
            expected = [
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(hf_config.num_hidden_layers)
            ]
            if list(layer_types) != expected:
                raise ValueError(f"unsupported gemma2 layer_types pattern: {layer_types}")
    family: Dict[str, Any] = {}
    if model_type == "qwen2":
        family = dict(qkv_bias=True)
    if gemma2:
        family = dict(
            attn_logit_softcap=getattr(hf_config, "attn_logit_softcapping", None),
            final_logit_softcap=getattr(hf_config, "final_logit_softcapping", None),
            query_pre_attn_scalar=float(getattr(hf_config, "query_pre_attn_scalar", 0) or 0) or None,
            sliding_window=getattr(hf_config, "sliding_window", 0) or 0,
            norm_plus_one=True,
            post_norms=True,
            scale_embedding=True,
            act="gelu_tanh",
        )
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        head_dim=getattr(hf_config, "head_dim", None),
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
        max_seq_len=hf_config.max_position_embeddings,
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        num_experts=getattr(hf_config, "num_local_experts", 0) or 0,
        num_experts_per_tok=getattr(hf_config, "num_experts_per_tok", 2),
        rope_scaling=rope_scaling,
        **family,
    )


def init_params(
    config: LlamaConfig, seed: int = 0, device: torch.device | str = "cpu", keep=None,
) -> Dict[str, torch.Tensor]:
    """Random-init (scaled normal) parameters with stacked layers, drawn
    on ``device`` from ``seed``. The numbers are not ``jax.random``'s;
    parity tests carry the JAX params across with ``convert.py``. A MoE
    config draws ``[L, E, ...]`` expert weights and the router with the
    JAX scales, straight into the model dtype, as every leaf is.
    ``keep(name, leaf)``, when given, is applied to each leaf as soon as
    it is drawn (a tp rank keeps its shard, :func:`rank_params`): the
    draws are the same, and the whole model is never held at once."""
    generator = torch.Generator(device=device).manual_seed(seed)
    h, f, v = config.hidden_size, config.intermediate_size, config.vocab_size
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.dims_per_head
    layers = config.num_layers
    dtype = config.dtype

    def normal(shape, std):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.normal_(0.0, std, generator=generator)

    scale = 1.0 / math.sqrt(h)
    deep = scale / math.sqrt(2 * layers)
    norm_fill = 0.0 if config.norm_plus_one else 1.0

    def norm_init(shape):
        return torch.full(shape, norm_fill, dtype=torch.float32, device=device)

    params: Dict[str, torch.Tensor] = {}

    def put(name, leaf):
        params[name] = keep(name, leaf) if keep is not None else leaf

    experts = (config.num_experts,) if config.num_experts else ()
    put("embedding", normal((v, h), scale))
    put("wq", normal((layers, h, nh * hd), scale))
    put("wk", normal((layers, h, nkv * hd), scale))
    put("wv", normal((layers, h, nkv * hd), scale))
    put("wo", normal((layers, nh * hd, h), deep))
    put("w_gate", normal((layers, *experts, h, f), scale))
    put("w_up", normal((layers, *experts, h, f), scale))
    put("w_down", normal((layers, *experts, f, h), deep))
    put("attn_norm", norm_init((layers, h)))
    put("mlp_norm", norm_init((layers, h)))
    put("final_norm", norm_init((h,)))
    if config.post_norms:
        put("post_attn_norm", norm_init((layers, h)))
        put("post_mlp_norm", norm_init((layers, h)))
    if config.qkv_bias:
        for name, width in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            put(name, torch.zeros((layers, width), dtype=torch.float32, device=device))
    if config.num_experts:
        put("router", normal((layers, h, config.num_experts), scale))
    if not config.tie_embeddings:
        put("lm_head", normal((h, v), scale))
    return params


# ---------------------------------------------------------------------- #
# tensor parallelism
# ---------------------------------------------------------------------- #
def logical_axes(config: LlamaConfig) -> Dict[str, Any]:
    """Logical sharding axes per parameter, leaf for leaf the JAX
    package's ``logical_axes`` (fed to ``parallel.mesh``'s rules)."""
    if config.num_experts:
        mlp_axes = {
            "w_gate": L("layers", "expert", "embed", "mlp"),
            "w_up": L("layers", "expert", "embed", "mlp"),
            "w_down": L("layers", "expert", "mlp", "embed"),
            "router": L("layers", "embed", None),
        }
    else:
        mlp_axes = {
            "w_gate": L("layers", "embed", "mlp"),
            "w_up": L("layers", "embed", "mlp"),
            "w_down": L("layers", "mlp", "embed"),
        }
    axes = {
        "embedding": L("vocab", "embed"),
        "wq": L("layers", "embed", "heads"),
        "wk": L("layers", "embed", "heads"),
        "wv": L("layers", "embed", "heads"),
        "wo": L("layers", "heads", "embed"),
        **mlp_axes,
        "attn_norm": L("layers", None),
        "mlp_norm": L("layers", None),
        "final_norm": L(None),
    }
    if config.post_norms:
        axes["post_attn_norm"] = L("layers", None)
        axes["post_mlp_norm"] = L("layers", None)
    if config.qkv_bias:
        axes["bq"] = L("layers", "heads")
        axes["bk"] = L("layers", "heads")
        axes["bv"] = L("layers", "heads")
    if not config.tie_embeddings:
        axes["lm_head"] = L("embed", "vocab")
    return axes


@dataclasses.dataclass(frozen=True)
class RankConfig(LlamaConfig):
    """One tp rank's :class:`LlamaConfig` (:func:`rank_config`): the
    fields of its shard, and its group (``parallel.mesh.AxisGroup``), which
    the model's collectives use; not part of the config's identity."""

    tp_group: Any = dataclasses.field(default=None, compare=False, hash=False, repr=False)
    # a training rank's MoE groups (:class:`MoEGroups`), None when serving
    moe: Any = dataclasses.field(default=None, compare=False, hash=False, repr=False)


@dataclasses.dataclass(frozen=True)
class MoEGroups:
    """What a training rank's MoE MLP needs of the mesh: the group over
    which the experts' shares are summed (``tp × ep``: each rank holds
    ``num_experts / ep`` experts, each cut over tp on ``mlp``), the
    global id of its first expert, and the batch axes' group, over whose
    rows the routing groups run (JAX routes the global batch)."""

    share: Any = None
    first_expert: int = 0
    batch: Any = None


def rank_config(config: LlamaConfig, group: Any, moe: Optional[MoEGroups] = None) -> RankConfig:
    """One tp rank's config: the heads, kv heads and intermediate width
    divided by the group's size, ``head_dim`` pinned (``dims_per_head``
    would otherwise fall back to ``hidden_size // num_heads`` of the
    divided head count), the vocabulary whole (the embedding's rows and
    the head's columns are split in the params, and the logits gathered
    whole), and the group itself, which the model's collectives use;
    ``moe``: a training rank's MoE groups."""
    tp = group.size
    if config.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={config.vocab_size}")
    fields = {field.name: getattr(config, field.name) for field in dataclasses.fields(LlamaConfig)}
    fields.update(num_heads=config.num_heads // tp, num_kv_heads=config.num_kv_heads // tp,
                  intermediate_size=config.intermediate_size // tp, head_dim=config.dims_per_head)
    return RankConfig(**fields, tp_group=group, moe=moe)


def rank_axes(config: LlamaConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`logical_axes` over ``params`` as they are, int8 leaves
    included (``quant.quantize_logical_axes``)."""
    from langstream_tpu_torch.providers.torch_local.quant import quantize_logical_axes

    return quantize_logical_axes(logical_axes(config), params)


def shard_leaf(config: LlamaConfig, name: str, leaf: Any, mesh: Any, rank: int) -> Any:
    """Rank ``rank``'s slice of one full leaf ``name`` (``keep`` of
    :func:`init_params` for a rank)."""
    from langstream_tpu_torch.parallel.mesh import shard_leaf as shard
    from langstream_tpu_torch.providers.torch_local.quant import quantize_logical_axes

    axes = quantize_logical_axes(logical_axes(config), {name: leaf})[name]
    return shard(leaf, axes, mesh, rank)


def rank_params(config: LlamaConfig, params: Dict[str, Any], mesh: Any, rank: int) -> Dict[str, Any]:
    """This rank's shard of ``params``, which are the full model's (cut
    here) or already the rank's (:func:`init_params` with a ``keep``,
    a loader's per-rank slice: kept as they are). ``config`` is the full
    model's."""
    if mesh.tp == 1:
        return params
    wq = params["wq"]
    width = (wq.q if hasattr(wq, "q") else wq).shape[-1]
    full = config.num_heads * config.dims_per_head
    if width == full // mesh.tp:
        return params
    if width != full:
        raise ValueError(f"wq of width {width} is neither the model's ({full}) nor a tp={mesh.tp} "
                         "shard of it")
    from langstream_tpu_torch.parallel.mesh import shard_params

    return shard_params(params, rank_axes(config, params), mesh, rank)


def _tp(config: LlamaConfig):
    """The config's tp group when it has more than one rank, else None."""
    group = getattr(config, "tp_group", None)
    return group if group is not None and group.size > 1 else None


def _row_product(config: LlamaConfig, x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a weight whose contraction rows are sharded over tp
    (``wo``): each rank's partial sums, kept in f32, added across the
    ranks and rounded once to x's dtype, as one card's product rounds its
    f32 accumulation once."""
    group = _tp(config)
    if group is None:
        return qmatmul(x, w)
    return collectives.reduce_sum(qmatmul(x, w, out_dtype=torch.float32), group).to(x.dtype)


def _cache_leaves(config: LlamaConfig, shape, kv_quant: bool, device) -> Dict[str, torch.Tensor]:
    """k/v of ``shape`` in the model's dtype, or (``kv_quant``) int8 with
    f32 scales of ``shape[:-1]``, one per (position, kv head)."""
    if kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
    }


def init_cache(
    config: LlamaConfig,
    batch: int,
    max_len: Optional[int] = None,
    kv_quant: bool = False,
    device: torch.device | str = "cpu",
) -> Dict[str, torch.Tensor]:
    """Dense KV cache: [layers, batch, max_len, kv_heads, head_dim]
    (``kv_quant``: int8, plus f32 ``k_scale``/``v_scale`` [layers, batch,
    max_len, kv_heads])."""
    max_len = max_len or config.max_seq_len
    shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.dims_per_head)
    return _cache_leaves(config, shape, kv_quant, device)


def init_paged_cache(
    config: LlamaConfig,
    num_blocks: int,
    block_size: int,
    kv_quant: bool = False,
    device: torch.device | str = "cpu",
) -> Dict[str, torch.Tensor]:
    """Paged KV cache (``kv_layout="paged"``): one block pool
    [layers, num_blocks, block_size, kv_heads, head_dim] shared by every
    slot, addressed through per-slot block tables (``paged.py`` owns the
    block accounting). Block 0 is the null block (padding and masked
    writes; never read live). The layout is the JAX package's, so a pool
    crosses between the two as it is. ``kv_quant`` mirrors the dense
    layout: int8 pools plus f32 scales [layers, num_blocks, block_size,
    kv_heads]."""
    shape = (
        config.num_layers, num_blocks, block_size,
        config.num_kv_heads, config.dims_per_head,
    )
    return _cache_leaves(config, shape, kv_quant, device)


def model_freqs(
    config: LlamaConfig, dtype=torch.float32, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """The one way to build this config's RoPE table (theta and the
    rope-scaling recipe)."""
    return rope_frequencies(
        config.dims_per_head, config.max_seq_len, config.rope_theta,
        dtype=dtype, scaling=config.rope_scaling, device=device,
    )


def validate_family_params(config: LlamaConfig, params: Dict[str, Any]) -> None:
    """Fail fast when family-specific tensors are missing (a qkv_bias or
    post_norms config would otherwise run silently without them). A
    weight may be a tensor or an int8 ``QTensor``."""
    required = []
    if config.qkv_bias:
        required += ["bq", "bk", "bv"]
    if config.post_norms:
        required += ["post_attn_norm", "post_mlp_norm"]
    if not config.tie_embeddings:
        required += ["lm_head"]
    if config.num_experts:
        required += ["router"]
    missing = [name for name in required if name not in params]
    if missing:
        raise ValueError(f"params missing {missing}, required by the model config")


def layer_windows(config: LlamaConfig) -> Optional[List[int]]:
    """Per-layer sliding-window sizes (0 = full attention): Gemma-2
    alternates sliding/full starting with sliding at layer 0. None when
    the family has no sliding window."""
    if not config.sliding_window:
        return None
    return [
        config.sliding_window if i % 2 == 0 else 0
        for i in range(config.num_layers)
    ]


def _project_qkv(normed, params, i):
    """q/k/v projections with optional biases (Qwen-2); flat
    [..., H*D] / [..., KVH*D] — callers reshape to heads."""
    q = qmatmul(normed, params["wq"][i])
    k = qmatmul(normed, params["wk"][i])
    v = qmatmul(normed, params["wv"][i])
    if "bq" in params:
        q = q + params["bq"][i].to(q.dtype)
        k = k + params["bk"][i].to(k.dtype)
        v = v + params["bv"][i].to(v.dtype)
    return q, k, v


def _norm(config: LlamaConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, w, config.norm_eps, plus_one=config.norm_plus_one)


def _attn_scale(config: LlamaConfig) -> float:
    """Gemma scales scores by query_pre_attn_scalar**-0.5 instead of
    head_dim**-0.5; None keeps the Llama default."""
    return (config.query_pre_attn_scalar or config.dims_per_head) ** -0.5


def _embed(config: LlamaConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    # ids past the vocabulary clamp to its last row, as JAX's gather does
    # (the byte tokenizer's specials 256-258 exceed the tiny presets' 256)
    ids = tokens.long().clamp(0, config.vocab_size - 1)
    group = _tp(config)
    if group is None:
        x = params["embedding"][ids].to(config.dtype)
    else:
        # the rank's rows of the vocabulary: ids outside them look up
        # nothing, and the ranks' rows add up to every id's
        rows = params["embedding"].shape[0]
        local = ids - group.rank * rows
        inside = (local >= 0) & (local < rows)
        x = params["embedding"][local.clamp(0, rows - 1)].to(config.dtype)
        x = collectives.reduce_sum(torch.where(inside[..., None], x, torch.zeros_like(x)), group)
    if config.scale_embedding:
        x = x * torch.tensor(math.sqrt(config.hidden_size), dtype=x.dtype)
    return x


def _mlp_block(config: LlamaConfig, normed: torch.Tensor, params, i, valid=None,
               dropless: bool = True, out_dtype=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gated MLP of layer i on normed activations → (residual delta,
    MoE load-balancing aux loss, None for the dense MLP): SwiGLU, or GeGLU
    for Gemma; with ``num_experts``, :func:`moe_mlp` in the exact regime
    (``dropless``, every serving call) or the capacity regime with
    ``valid`` keeping padding out of capacity (training). ``out_dtype``:
    the dense MLP's down projection in that dtype (a tp rank's f32 partial
    sums)."""
    if config.num_experts:
        moe = getattr(config, "moe", None)
        groups = {} if moe is None else dict(share_group=moe.share, first_expert=moe.first_expert,
                                             batch_group=moe.batch)
        return moe_mlp(
            normed, params["router"][i], params["w_gate"][i], params["w_up"][i],
            params["w_down"][i], num_selected=config.num_experts_per_tok,
            capacity_factor=None if dropless else config.capacity_factor, valid=valid, **groups,
        )
    gate = qmatmul(normed, params["w_gate"][i])
    up = qmatmul(normed, params["w_up"][i])
    if config.act == "gelu_tanh":
        activated = F.gelu(gate, approximate="tanh")
    else:
        activated = F.silu(gate)
    return qmatmul(activated * up, params["w_down"][i], out_dtype=out_dtype), None


# rows of one pass through the MLP: a call of more rows (a prefill of
# group × bucket tokens) runs it in slices of this many, so that its
# largest intermediates, each rows × intermediate_size, are one slice's.
# Dense prefill-at-offset attention slices its calls by the same count of
# query rows (its f32 scores are rows × heads × max_len). A captured
# prefill keeps its peak in the engine's graph pool for as long as the
# engine lives.
MLP_ROWS = 4096


def mlp_rows(config: LlamaConfig) -> int:
    """Rows of one MLP pass: :data:`MLP_ROWS`, over the expert count for
    the MoE MLP, whose intermediates are ``[E, rows, F]`` (the same bytes
    a slice as the dense MLP's ``[rows, F]``)."""
    return max(1, MLP_ROWS // max(config.num_experts, 1))


def _mlp(config: LlamaConfig, normed: torch.Tensor, params, i) -> torch.Tensor:
    """The serving MLP (:func:`_mlp_block`, MoE in its exact regime) over
    ``normed`` [..., hidden], in slices of :func:`mlp_rows` rows (each
    row's result is the same computation: the exact regime routes each
    token alone; the block keeps ``normed``'s width and dtype)."""
    rows = normed.reshape(-1, normed.shape[-1])
    step = mlp_rows(config)
    group = _tp(config)
    # under tp each row holds the rank's partial sums over its
    # intermediate columns, kept in f32 and added across the ranks once
    # for all slices, then rounded once (the MoE MLP's come in its dtype)
    partial = {} if group is None else {"out_dtype": torch.float32}
    if rows.shape[0] <= step:
        out = _mlp_block(config, normed, params, i, **partial)[0]
    else:
        out = torch.empty(rows.shape, dtype=partial.get("out_dtype", rows.dtype), device=rows.device)
        for start in range(0, rows.shape[0], step):
            out[start:start + step] = _mlp_block(config, rows[start:start + step], params, i,
                                                 **partial)[0]
        out = out.reshape(normed.shape)
    return out if group is None else collectives.reduce_sum(out, group).to(normed.dtype)


def _logits(config: LlamaConfig, params, x: torch.Tensor) -> torch.Tensor:
    group = _tp(config)
    if group is not None:
        x = collectives.enter(x, group)
    if config.tie_embeddings:
        # the embedding is never quantized: the tied head stays in x's dtype
        logits = (x @ params["embedding"].T.to(x.dtype)).float()
    else:
        logits = qmatmul(x, params["lm_head"]).float()
    if group is not None:
        # the rank's columns of the vocabulary, gathered whole: every rank
        # samples from the same full row
        logits = collectives.gather(logits, group, logits.dim() - 1, reduce=False)
    cap = config.final_logit_softcap
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    return logits


def _family(config: LlamaConfig, window) -> Dict[str, Any]:
    return dict(softcap=config.attn_logit_softcap, window=window, scale=_attn_scale(config))


def _new_rows(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor):
    """A layer's new KV rows by cache leaf: k/v as they are, or over an
    int8 cache quantized once, values and scales (the rows attention
    reads, so cold, warm and decode paths see the same contents)."""
    if "k_scale" not in cache:
        return {"k": k, "v": v}
    k_q, k_s = quantize_kv(k)
    v_q, v_s = quantize_kv(v)
    return {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}


def _kv_args(kv: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """A layer's leaves in the attention functions' order: (k, v), or
    (k, k_scale, v, v_scale) for the int8 twins."""
    if "k_scale" in kv:
        return kv["k"], kv["k_scale"], kv["v"], kv["v_scale"]
    return kv["k"], kv["v"]


def _prefill_attn(config, q, kv, lengths, window=None):
    """Cold prefill self-attention over the prompt's own rows ``kv``
    through the flash wrapper (B1, or B4 over int8 rows): the CUDA kernel
    when the tensors are on the card, the plain version on the CPU."""
    fn = flash_prefill_attention_quant if "k_scale" in kv else flash_prefill_attention
    return fn(q, *_kv_args(kv), lengths=lengths, **_family(config, window))


def _decode_attn(config, q, kv, lengths, window=None):
    """Decode attention over a layer's dense cache ``kv`` through the
    flash-decode wrapper (B2, or B5 over an int8 cache)."""
    fn = flash_decode_attention_quant if "k_scale" in kv else flash_decode_attention
    return fn(q, *_kv_args(kv), lengths, **_family(config, window))


def _chunk_attn(config, q, kv, starts, totals, window=None):
    """Dense prefill-at-offset attention: plain PyTorch on every device,
    as the JAX package leaves it to XLA."""
    fn = chunk_attention_quant if "k_scale" in kv else chunk_attention
    return fn(q, *_kv_args(kv), starts, totals, **_family(config, window))


def _layer_tail(config, params, i, x, attn):
    """Output projection, residuals, the MLP block and the optional
    sandwich norms — shared by prefill and decode."""
    attn = _row_product(config, attn, params["wo"][i])
    if "post_attn_norm" in params:
        attn = _norm(config, attn, params["post_attn_norm"][i])
    x = x + attn
    normed = _norm(config, x, params["mlp_norm"][i])
    delta = _mlp(config, normed, params, i)
    if "post_mlp_norm" in params:
        delta = _norm(config, delta, params["post_mlp_norm"][i])
    return x + delta


def _prefill_scan(config, params, tokens, offsets, freqs, attend):
    """The prefill layer loop: token t of row b sits at global position
    ``offsets[b] + t``; ``attend(i, q, k, v, window)`` stores layer i's
    new KV [B, T, KVH, D] and returns its attention [B, T, H, D].
    Returns the final hidden states."""
    batch, seq = tokens.shape
    hd = config.dims_per_head
    positions = offsets.long()[:, None] + torch.arange(seq, device=tokens.device)[None, :]
    # positions past the RoPE table clamp to its last row, as JAX's gather
    # does (only padding tokens of a window at the context's end reach it)
    positions = positions.clamp(max=freqs.shape[1] - 1)
    windows = layer_windows(config)
    x = _embed(config, params, tokens)
    for i in range(config.num_layers):
        normed = _norm(config, x, params["attn_norm"][i])
        q, k, v = _project_qkv(normed, params, i)
        q = apply_rope(q.reshape(batch, seq, config.num_heads, hd), freqs, positions)
        k = apply_rope(k.reshape(batch, seq, config.num_kv_heads, hd), freqs, positions)
        v = v.reshape(batch, seq, config.num_kv_heads, hd)
        attn = attend(i, q, k, v, windows[i] if windows else None)
        x = _layer_tail(config, params, i, x, attn.reshape(batch, seq, -1))
    return x


def _last_token_logits(config, params, x, lengths):
    """Logits [B, V] (f32) of each row's last real token."""
    batch = x.shape[0]
    last = x[torch.arange(batch, device=x.device), lengths.long() - 1]  # [B, hidden]
    return _logits(config, params, _norm(config, last, params["final_norm"]))


@torch.inference_mode()
def prefill(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,     # [B, T] (right-padded)
    lengths: torch.Tensor,    # [B] int32 true prompt lengths
    slot_ids: torch.Tensor,   # [B] cache slots to write
    freqs: torch.Tensor,
) -> torch.Tensor:
    """Run the prompts through the model, write their KV rows [0, T) into
    the cache at ``slot_ids`` and zero rows [T, max_len) of those slots
    (values and, int8, scales), as the JAX ``prefill`` does (IN PLACE:
    the cache tensors are updated, not copied), and return the logits of
    each prompt's last real token [B, V] in f32. Over an int8 cache the
    prompt attends to its quantized rows."""
    validate_family_params(config, params)
    seq = tokens.shape[1]
    slot_ids = slot_ids.long()

    def attend(i, q, k, v, window):
        new = _new_rows(cache, k, v)
        for leaf, value in new.items():
            rows = cache[leaf][i]  # [S, max_len, KVH(, D)] view
            rows[slot_ids, :seq] = value.to(rows.dtype)
            rows[slot_ids, seq:] = rows.new_zeros(())  # on the device: capturable
        return _prefill_attn(config, q, new, lengths, window=window)

    x = _prefill_scan(config, params, tokens, torch.zeros_like(lengths), freqs, attend)
    return _last_token_logits(config, params, x, lengths)


@torch.inference_mode()
def prefill_at_offset(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,     # [B, T] suffix tokens (right-padded)
    lengths: torch.Tensor,    # [B] int32 true suffix lengths
    offsets: torch.Tensor,    # [B] int32 existing valid cache length per row
    slot_ids: torch.Tensor,   # [B] cache slots to extend
    freqs: torch.Tensor,
) -> torch.Tensor:
    """Prefill of a suffix into cache slots that already hold a prefix:
    positions are offset by the prefix, the new KV rows are written at
    ``offset .. offset + T - 1`` (IN PLACE), and attention runs over
    prefix + suffix (:func:`chunk_attention`, in slices of rows of at most
    :data:`MLP_ROWS` query tokens). The caller keeps
    ``offset + T <= max_len``; past it the window is clamped to end at
    ``max_len``, as JAX's ``dynamic_update_slice`` clamps. Returns the
    logits [B, V] (f32) of each row's last real suffix token."""
    validate_family_params(config, params)
    seq = tokens.shape[1]
    max_len = cache["k"].shape[2]
    totals = offsets + lengths
    slots = slot_ids.long()
    write_start = offsets.long().clamp(0, max(max_len - seq, 0))
    rows = write_start[:, None] + torch.arange(seq, device=tokens.device)[None, :]  # [B, T]

    # rows of the batch a pass of attention takes (:data:`MLP_ROWS` query rows)
    per = max(1, MLP_ROWS // seq)

    def attend(i, q, k, v, window):
        new = _new_rows(cache, k, v)
        for leaf, value in new.items():
            stored = cache[leaf][i]
            stored[slots[:, None], rows] = value.to(stored.dtype)
        out = torch.empty_like(q)
        for start in range(0, q.shape[0], per):
            part = slice(start, start + per)
            layer = {leaf: cache[leaf][i][slots[part]] for leaf in new}
            out[part] = _chunk_attn(config, q[part], layer, offsets[part], totals[part], window=window)
        return out

    x = _prefill_scan(config, params, tokens, offsets, freqs, attend)
    return _last_token_logits(config, params, x, lengths)


@torch.inference_mode()
def decode_step(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,     # [S] one new token per slot
    lengths: torch.Tensor,    # [S] int32 length INCLUDING the new token
    freqs: torch.Tensor,
    write_mask: Optional[torch.Tensor] = None,  # [S] bool; False = leave
                                                # this slot's cache alone
) -> torch.Tensor:
    """One decode step for every slot: write the new token's KV at
    position ``lengths - 1`` (IN PLACE, only where ``write_mask``), attend
    over the cache, return next-token logits [S, V] in f32."""
    validate_family_params(config, params)
    slots = tokens.shape[0]
    hd = config.dims_per_head
    positions = lengths.long() - 1  # -1 (empty slot) wraps; its write is masked
    rows = torch.arange(slots, device=tokens.device)
    if write_mask is None:
        write_mask = torch.ones(slots, dtype=torch.bool, device=tokens.device)
    windows = layer_windows(config)
    x = _embed(config, params, tokens)  # [S, hidden]
    for i in range(config.num_layers):
        normed = _norm(config, x, params["attn_norm"][i])
        q, k, v = _project_qkv(normed, params, i)
        q = apply_rope(q.reshape(slots, 1, config.num_heads, hd), freqs, positions[:, None])[:, 0]
        k = apply_rope(k.reshape(slots, 1, config.num_kv_heads, hd), freqs, positions[:, None])[:, 0]
        v = v.reshape(slots, config.num_kv_heads, hd)
        layer = {}
        for leaf, value in _new_rows(cache, k, v).items():
            stored = cache[leaf][i]  # [S, T, KVH(, D)] view
            keep = write_mask.reshape(-1, *([1] * (value.dim() - 1)))
            stored[rows, positions] = torch.where(
                keep, value.to(stored.dtype), stored[rows, positions]
            )
            layer[leaf] = stored
        attn = _decode_attn(
            config, q, layer, lengths, window=windows[i] if windows else None
        )
        x = _layer_tail(config, params, i, x, attn.reshape(slots, -1))
    return _logits(config, params, _norm(config, x, params["final_norm"]))


PAGED_KERNELS = ("fused", "reference")


def _mixed_block_q(width: int) -> int:
    """q tile of the token-ragged mixed launch: spans are ``width``
    tokens per row, so the tile divides the span. Widths that are
    multiples of 8 take 8-token tiles, others one tile per row."""
    return 8 if width % 8 == 0 else width


def _paged_attn(config, q, kv, tables, starts, totals, *, window, kernel, q_offsets=None,
                verify=False):
    """Paged attention over a layer's pools ``kv``, one seam for every
    ragged case: decode (q [S, H, D], starts = lengths - 1),
    prefill-at-offset and cold paged prefill (q [B, T, H, D]), and, with
    ``q_offsets`` (the JAX seam's ``q_lens`` switch), the mixed
    prefill+decode step, where each row carries its own new-token count
    ``totals - starts`` (decode rows 1, prefill windows their width, idle
    rows 0). ``kernel="fused"`` goes through
    :func:`ragged_paged_attention` (B3, or :func:`ragged_paged_attention_quant`,
    B6, over int8 pools) or, for the mixed step, the token-ragged
    :func:`ragged_q_paged_attention` (B7, or B8 over int8 pools) with the
    rows at ``q_offsets`` (``b * W``) of the flattened [S*W, H, D] tile; each
    launches the CUDA kernel on a card tensor (or raises) and runs its
    plain version on a CPU tensor. ``"reference"`` (asked for explicitly)
    runs the gather composition on any device, which already speaks
    per-row starts and totals, so the mixed step needs no path of its
    own there (positions past a row's count compute discarded values).
    ``verify``: the launch is a speculative verify block, which the card
    counts in a class of its own."""
    family = _family(config, window)
    quant = "k_scale" in kv
    decode = q.dim() == 3
    if kernel == "fused":
        if q_offsets is not None and not decode:
            batch, width, heads, dim = q.shape
            fn = ragged_q_paged_attention_quant if quant else ragged_q_paged_attention
            # the flat tile holds row b at b * W, the values of q_offsets
            out = fn(
                q.reshape(batch * width, heads, dim), *_kv_args(kv), tables, starts, totals,
                q_offsets, max_q_len=width, block_q=_mixed_block_q(width),
                q_offsets_host=range(0, batch * width, width), **family,
            )
            return out.reshape(batch, width, heads, dim)
        fn = ragged_paged_attention_quant if quant else ragged_paged_attention
        out = fn(q[:, None] if decode else q, *_kv_args(kv), tables, starts, totals, verify=verify,
                 **family)
        return out[:, 0] if decode else out
    if kernel != "reference":
        raise ValueError(f"unknown paged kernel {kernel!r}")
    if decode:
        fn = paged_decode_attention_quant if quant else paged_decode_attention
        return fn(q, *_kv_args(kv), tables, totals, **family)
    fn = paged_chunk_attention_quant if quant else paged_chunk_attention
    return fn(q, *_kv_args(kv), tables, starts, totals, **family)


@torch.inference_mode()
def paged_prefill(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],   # paged pool (init_paged_cache)
    tokens: torch.Tensor,             # [B, T] (right-padded)
    lengths: torch.Tensor,            # [B] int32 true prompt lengths
    block_tables: torch.Tensor,       # [B, M] int32 pool block per seq block
    freqs: torch.Tensor,
    kernel: str = "fused",            # paged attention: fused | reference
) -> torch.Tensor:
    """Cold prefill into the block pool (IN PLACE); returns the logits
    [B, V] of each prompt's last real token.

    Fused route: cold prefill is prefill-at-offset with every offset 0,
    the same ragged launch the warm and decode paths use, reading the
    just-written blocks through the tables. Reference route: the dense
    cold layer loop of :func:`prefill` (self-attention never reads the
    cache; over int8 pools it reads the quantized rows through B4) with
    the KV scattered through the tables."""
    if kernel == "fused":
        return paged_prefill_at_offset(
            config, params, cache, tokens, lengths, torch.zeros_like(lengths),
            block_tables, freqs, kernel=kernel,
        )
    if kernel != "reference":
        raise ValueError(f"unknown paged kernel {kernel!r}")
    validate_family_params(config, params)
    batch, seq = tokens.shape
    valid = torch.arange(seq, device=tokens.device)[None, :] < lengths[:, None]
    zeros = torch.zeros((batch,), dtype=torch.int32, device=tokens.device)

    def attend(i, q, k, v, window):
        new = _new_rows(cache, k, v)
        for leaf, value in new.items():
            paged_write_rows(cache[leaf][i], value, block_tables, zeros, valid)
        return _prefill_attn(config, q, new, lengths, window=window)

    x = _prefill_scan(config, params, tokens, zeros, freqs, attend)
    return _last_token_logits(config, params, x, lengths)


@torch.inference_mode()
def paged_prefill_at_offset(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],   # paged pool
    tokens: torch.Tensor,             # [B, T] suffix tokens (right-padded)
    lengths: torch.Tensor,            # [B] int32 true suffix lengths
    offsets: torch.Tensor,            # [B] int32 existing valid length per row
    block_tables: torch.Tensor,       # [B, M] int32
    freqs: torch.Tensor,
    kernel: str = "fused",            # paged attention: fused | reference
) -> torch.Tensor:
    """Paged twin of :func:`prefill_at_offset`: the suffix KV scatters
    into table-addressed blocks (IN PLACE; padding rows go to the null
    block) and attention reads prefix + suffix through the same tables,
    which is how a request admitted onto a cached prefix chain attends
    over blocks another request's prefill wrote. Shared blocks are never
    written here: the engine admits suffixes at block boundaries into
    private blocks. Returns the logits [B, V] of each row's last real
    suffix token."""
    validate_family_params(config, params)
    seq = tokens.shape[1]
    valid = torch.arange(seq, device=tokens.device)[None, :] < lengths[:, None]
    totals = offsets + lengths

    def attend(i, q, k, v, window):
        layer = {
            leaf: paged_write_rows(cache[leaf][i], value, block_tables, offsets, valid)
            for leaf, value in _new_rows(cache, k, v).items()
        }
        return _paged_attn(
            config, q, layer, block_tables, offsets, totals, window=window, kernel=kernel,
        )

    x = _prefill_scan(config, params, tokens, offsets, freqs, attend)
    return _last_token_logits(config, params, x, lengths)


@torch.inference_mode()
def paged_decode_step(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],   # paged pool
    tokens: torch.Tensor,             # [S] one new token per slot
    lengths: torch.Tensor,            # [S] int32 length INCLUDING the new token
    block_tables: torch.Tensor,       # [S, M] int32
    freqs: torch.Tensor,
    write_mask: Optional[torch.Tensor] = None,  # [S] bool
    kernel: str = "fused",            # paged attention: fused | reference
) -> torch.Tensor:
    """Paged twin of :func:`decode_step`: the new token's KV scatters
    into its slot's current block (IN PLACE; masked slots route to the
    null block) and attention reads the live context through the tables,
    the decode case (Tq = 1, start = length - 1) of :func:`_paged_attn`.
    Decode never allocates: the engine reserves each request's worst case
    at admission. Returns next-token logits [S, V] in f32."""
    validate_family_params(config, params)
    slots = tokens.shape[0]
    hd = config.dims_per_head
    positions = lengths - 1  # -1 (empty slot) wraps in RoPE; its write is masked
    if write_mask is None:
        write_mask = torch.ones(slots, dtype=torch.bool, device=tokens.device)
    rope_positions = positions.long()[:, None]
    windows = layer_windows(config)
    x = _embed(config, params, tokens)  # [S, hidden]
    for i in range(config.num_layers):
        normed = _norm(config, x, params["attn_norm"][i])
        q, k, v = _project_qkv(normed, params, i)
        q = apply_rope(q.reshape(slots, 1, config.num_heads, hd), freqs, rope_positions)[:, 0]
        k = apply_rope(k.reshape(slots, 1, config.num_kv_heads, hd), freqs, rope_positions)[:, 0]
        v = v.reshape(slots, config.num_kv_heads, hd)
        layer = {
            leaf: paged_write_rows(
                cache[leaf][i], value[:, None], block_tables, positions, write_mask[:, None]
            )
            for leaf, value in _new_rows(cache, k, v).items()
        }
        attn = _paged_attn(
            config, q, layer, block_tables, positions, lengths,
            window=windows[i] if windows else None, kernel=kernel,
        )
        x = _layer_tail(config, params, i, x, attn.reshape(slots, -1))
    return _logits(config, params, _norm(config, x, params["final_norm"]))


@torch.inference_mode()
def paged_mixed_step(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],   # paged pool
    tokens: torch.Tensor,             # [S, W] per-row new tokens
    offsets: torch.Tensor,            # [S] int32 existing valid rows per slot
    num_tokens: torch.Tensor,         # [S] int32 live new tokens (0 = idle row)
    block_tables: torch.Tensor,       # [S, M] int32
    freqs: torch.Tensor,
    write_mask: Optional[torch.Tensor] = None,  # [S] bool
    kernel: str = "fused",            # paged attention: fused | reference
) -> torch.Tensor:
    """The mixed prefill+decode step: :func:`paged_decode_step` and
    :func:`paged_prefill_at_offset` as one model call over per-row token
    counts. A decode row carries its pending token (``offsets = length,
    num_tokens = 1``), an admitting row a window of its prompt
    (``offsets`` = tokens taught so far), an idle row nothing
    (``num_tokens = 0``). Every layer scatters the live positions' KV
    through the tables (IN PLACE; padding and idle positions, and rows
    off ``write_mask``, go to the null block), attends through the
    token-ragged seam of :func:`_paged_attn`, and runs the whole [S, W]
    grid through the projections, as the JAX step does. Returns the
    logits [S, V] (f32) of each row's last live token, the one position
    the engine samples."""
    validate_family_params(config, params)
    slots, width = tokens.shape
    valid = torch.arange(width, device=tokens.device)[None, :] < num_tokens[:, None]  # [S, W]
    if write_mask is not None:
        valid = valid & write_mask[:, None]
    totals = offsets + num_tokens
    # rows at a uniform stride of the flattened [S*W, H, D] tile, one
    # tensor for every layer
    q_offsets = torch.arange(slots, dtype=torch.int32, device=tokens.device) * width

    def attend(i, q, k, v, window):
        layer = {
            leaf: paged_write_rows(cache[leaf][i], value, block_tables, offsets, valid)
            for leaf, value in _new_rows(cache, k, v).items()
        }
        return _paged_attn(
            config, q, layer, block_tables, offsets, totals, window=window, kernel=kernel,
            q_offsets=q_offsets,
        )

    x = _prefill_scan(config, params, tokens, offsets, freqs, attend)
    last = (num_tokens.long() - 1).clamp(0, width - 1)
    x = x[torch.arange(slots, device=x.device), last]  # [S, hidden]
    return _logits(config, params, _norm(config, x, params["final_norm"]))


def _block_positions(lengths: torch.Tensor, valid_lens: torch.Tensor, seq: int,
                     write_mask: Optional[torch.Tensor]):
    """A verify block's rows: the offsets (``lengths - 1``), which block
    positions hold a real token (``t < valid_lens``), the totals
    (``offsets + valid_lens``) and the positions to write (real, and on a
    row of ``write_mask``)."""
    offsets = (lengths - 1).to(torch.int32)
    mask = torch.arange(seq, device=lengths.device)[None, :] < valid_lens[:, None]
    totals = offsets + valid_lens.to(torch.int32)
    writes = mask if write_mask is None else mask & write_mask[:, None]
    return offsets, totals, writes


@torch.inference_mode()
def verify_step(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,      # [S, B] the pending token + the drafted block
    lengths: torch.Tensor,     # [S] int32 cache length INCLUDING tokens[:, 0]
    valid_lens: torch.Tensor,  # [S] int32 real tokens in the block (1 +
                               # drafted; 0 = inactive row)
    freqs: torch.Tensor,
    write_mask: Optional[torch.Tensor] = None,  # [S] bool
) -> torch.Tensor:
    """Speculative verify (the JAX ``verify_step``): :func:`decode_step`
    over a [S, B] block a slot. The block sits at each slot's current
    position (``tokens[:, 0]`` is the pending token whose row a decode
    step would write, the rest drafted candidates); the KV of every real
    block position is written IN PLACE, attention runs causally over
    prefix + block (:func:`chunk_attention`, plain PyTorch, as the JAX
    package leaves it to XLA), and the logits of EVERY position [S, B, V]
    (f32) come back, for the acceptance pass. Rows past a slot's real
    tokens, and rows off ``write_mask``, keep the cache's old values, so a
    rejected suffix rolls back by a length rewind alone. Each row writes
    a window of B distinct positions (its block, clamped inside the cache
    as JAX's dropped out-of-range writes leave the end of the cache)."""
    validate_family_params(config, params)
    slots, seq = tokens.shape
    max_len = cache["k"].shape[2]
    offsets, totals, writes = _block_positions(lengths, valid_lens, seq, write_mask)
    rows = torch.arange(slots, device=tokens.device)[:, None]
    # the window [start, start + B) of each row holds its block's
    # positions that fit; block position t lands at window index
    # t + shift, and a window index keeps its old value unless the block
    # position mapped onto it is written
    start = offsets.long().clamp(0, max(max_len - seq, 0))
    window = start[:, None] + torch.arange(seq, device=tokens.device)[None, :]  # [S, B]
    source = window - offsets.long()[:, None]  # the block position at each window index
    written = (source >= 0) & (source < seq) & torch.gather(writes, 1, source.clamp(0, seq - 1))

    def attend(i, q, k, v, window_size):
        layer = {}
        for leaf, value in _new_rows(cache, k, v).items():
            stored = cache[leaf][i]  # [S, T, KVH(, D)] view
            placed = torch.gather(value.to(stored.dtype), 1, source.clamp(0, seq - 1).view(
                slots, seq, *([1] * (value.dim() - 2))).expand_as(value))
            keep = written.view(slots, seq, *([1] * (value.dim() - 2)))
            stored[rows, window] = torch.where(keep, placed, stored[rows, window])
            layer[leaf] = stored
        return _chunk_attn(config, q, layer, offsets, totals, window=window_size)

    x = _prefill_scan(config, params, tokens, offsets, freqs, attend)
    return _logits(config, params, _norm(config, x, params["final_norm"]))


@torch.inference_mode()
def paged_verify_step(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],   # paged pool
    tokens: torch.Tensor,             # [S, B] the block a slot
    lengths: torch.Tensor,            # [S] int32 length INCLUDING tokens[:, 0]
    valid_lens: torch.Tensor,         # [S] int32 real tokens (0 = inactive)
    block_tables: torch.Tensor,       # [S, M] int32
    freqs: torch.Tensor,
    write_mask: Optional[torch.Tensor] = None,  # [S] bool
    kernel: str = "fused",            # paged attention: fused | reference
) -> torch.Tensor:
    """Paged twin of :func:`verify_step` (the JAX ``paged_verify_step``):
    the block's KV scatters into table-addressed blocks (IN PLACE; masked
    and overflow rows go to the null block), and attention is the ragged
    kernel's prefill-at-offset form at Tq = B (B3, or B6 over int8 pools;
    its launches count in their own class on the card,
    ``ops/launches.py``). Blocks were reserved worst-case at admission,
    so verify never allocates and rollback is a length rewind. Returns
    the logits [S, B, V] (f32) of every position."""
    validate_family_params(config, params)
    offsets, totals, writes = _block_positions(lengths, valid_lens, tokens.shape[1], write_mask)
    # an inactive row (length 0) attends over nothing: start and total 0
    starts = offsets.clamp(min=0)
    totals = torch.maximum(totals, starts)

    def attend(i, q, k, v, window):
        layer = {
            leaf: paged_write_rows(cache[leaf][i], value, block_tables, offsets, writes)
            for leaf, value in _new_rows(cache, k, v).items()
        }
        return _paged_attn(
            config, q, layer, block_tables, starts, totals, window=window, kernel=kernel,
            verify=True,
        )

    x = _prefill_scan(config, params, tokens, starts, freqs, attend)
    return _logits(config, params, _norm(config, x, params["final_norm"]))


# ---------------------------------------------------------------------- #
# the differentiable forward (training and scoring)
# ---------------------------------------------------------------------- #
# the stacked leaves a layer reads, when the family has them
LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "bq", "bk", "bv", "wo", "post_attn_norm",
                "mlp_norm", "post_mlp_norm", "w_gate", "w_up", "w_down", "router")


def unstack_layers(params: Dict[str, Any]) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Each stacked layer leaf as a tuple of its layers, by one
    ``unbind`` per leaf: ``layers[name][i]`` is layer i's view, and the
    backward of all of them is one ``stack``. Indexing ``params[name][i]``
    under autograd would instead give one ``select_backward`` per layer,
    each a zero tensor the size of the whole leaf."""
    return {name: params[name].unbind(0) for name in LAYER_LEAVES if name in params}


def _train_layer(config, layers, i, x, mask, freqs, positions, window, dropless):
    """Layer i of :func:`apply_layers`: the JAX ``layer_fn`` body over
    ``x`` [B, T, H], attention through the plain ``prefill_attention`` →
    (x, the layer's MoE aux loss or None). Under tp the normed
    activations enter the rank's heads and intermediate columns through
    ``collectives.enter`` and the partial sums of ``wo`` and ``w_down``
    leave through ``collectives.reduce_sum``; the MoE MLP sums its shares
    itself."""
    batch, seq = x.shape[:2]
    hd = config.dims_per_head
    group = _tp(config)
    normed = _norm(config, x, layers["attn_norm"][i])
    if group is not None:
        normed = collectives.enter(normed, group)
    q, k, v = _project_qkv(normed, layers, i)
    q = apply_rope(q.reshape(batch, seq, config.num_heads, hd), freqs, positions)
    k = apply_rope(k.reshape(batch, seq, config.num_kv_heads, hd), freqs, positions)
    v = v.reshape(batch, seq, config.num_kv_heads, hd)
    attn = prefill_attention(q, k, v, mask=mask, **_family(config, window))
    attn = _row_product(config, attn.reshape(batch, seq, -1), layers["wo"][i])
    if "post_attn_norm" in layers:
        attn = _norm(config, attn, layers["post_attn_norm"][i])
    x = x + attn
    normed = _norm(config, x, layers["mlp_norm"][i])
    if group is None or config.num_experts:
        delta, aux = _mlp_block(config, normed, layers, i, valid=mask, dropless=dropless)
    else:
        partial = _mlp_block(config, collectives.enter(normed, group), layers, i,
                             out_dtype=torch.float32)[0]
        delta, aux = collectives.reduce_sum(partial, group).to(normed.dtype), None
    if "post_mlp_norm" in layers:
        delta = _norm(config, delta, layers["post_mlp_norm"][i])
    return x + delta, aux


def apply_layers(
    config: LlamaConfig,
    layers: Dict[str, Tuple[torch.Tensor, ...]],  # from unstack_layers
    x: torch.Tensor,                 # [B, T, H] activations
    mask: Optional[torch.Tensor],    # [B, T] valid-token mask or None
    freqs: torch.Tensor,
    remat: bool = False,
    dropless: bool = False,
    layer_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop over activations → (x, the sum of the layers' MoE
    aux losses, 0 for the dense MLP). ``layers`` may be a contiguous
    slice of the stack, a pipeline stage's, whose first layer is layer
    ``layer_offset`` of the model: Gemma-2's sliding and full windows
    alternate by the global index. Attention is the plain
    ``prefill_attention``, the formulation the JAX package differentiates
    (its kernels have no VJP); the MoE MLP runs in the capacity regime
    with ``mask`` as its valid tokens, or the exact one with
    ``dropless``. ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations: the JAX trainer's ``jax.checkpoint`` over the whole
    loss, with the same gradient and another peak."""
    batch, seq = x.shape[:2]
    positions = torch.arange(seq, device=x.device)[None, :].expand(batch, seq)
    # positions past the RoPE table clamp to its last row, as JAX's gather does
    positions = positions.clamp(max=freqs.shape[1] - 1)
    count = len(layers["wq"])
    windows = layer_windows(config)
    windows = windows[layer_offset:layer_offset + count] if windows else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(count):
        args = (config, layers, i, x, mask, freqs, positions, windows[i] if windows else None,
                dropless)
        if remat:
            x, layer_aux = torch.utils.checkpoint.checkpoint(_train_layer, *args, use_reentrant=False)
        else:
            x, layer_aux = _train_layer(*args)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def forward(
    config: LlamaConfig,
    params: Dict[str, torch.Tensor],
    tokens: torch.Tensor,                 # [B, T]
    mask: Optional[torch.Tensor] = None,  # [B, T] valid-token mask
    freqs: Optional[torch.Tensor] = None,
    with_aux: bool = False,
    remat: bool = False,
    dropless: bool = False,
    layers: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
):
    """Cache-free full-sequence forward → logits [B, T, V] in f32, with
    autograd (the training and scoring path; serving uses
    :func:`prefill` and :func:`decode_step`). With ``with_aux`` also the
    mean MoE load-balancing loss over the layers, 0 for the dense model.
    ``dropless`` selects the exact MoE regime (scoring a dropless-trained
    checkpoint); training keeps the capacity regime, as JAX's does.
    ``layers``: the layer leaves by name, each a sequence of its layers
    (default :func:`unstack_layers` of ``params``; a sharded trainer
    passes views that gather each layer's shards as it runs)."""
    validate_family_params(config, params)
    if freqs is None:
        freqs = model_freqs(config, device=tokens.device)
    x = _embed(config, params, tokens)
    x, aux = apply_layers(config, unstack_layers(params) if layers is None else layers, x, mask,
                          freqs, remat=remat, dropless=dropless)
    logits = _logits(config, params, _norm(config, x, params["final_norm"]))
    if with_aux:
        return logits, aux / max(config.num_layers, 1)
    return logits
