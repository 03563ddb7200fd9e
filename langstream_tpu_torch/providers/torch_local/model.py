"""Llama-family decoder in PyTorch over a stacked-parameter dict.

Port of ``langstream_tpu/providers/jax_local/model.py`` for the dense
serving path. Parameters are a dict of tensors with the per-layer weights
stacked on a leading layer axis, in the JAX package's ``[in, out]``
layout, so ``x @ W`` is what its ``qeinsum("...h,hd->...d")`` computed and
parameters carry across unchanged (see ``convert.py``). The ``lax.scan``
over layers is a Python loop.

Attention goes through the kernel wrappers in ``ops/``: on the card they
launch the hand-written CUDA kernels, on the CPU they run the plain
versions. The matrix products outside attention stay ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from langstream_tpu_torch.ops.decode_kernel import flash_decode_attention
from langstream_tpu_torch.ops.flash_attention import flash_prefill_attention
from langstream_tpu_torch.ops.norms import rms_norm
from langstream_tpu_torch.ops.rope import apply_rope, rope_frequencies

_NOT_PORTED = (
    "is not ported to langstream_tpu_torch yet (see ROADMAP.md, Queue A)"
)


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
    # Mixture-of-experts (Mixtral family). 0 = dense SwiGLU MLP; the port
    # raises on > 0 (MoE is not ported yet).
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
        clean = {k.replace("-", "_"): v for k, v in config.items()}
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


def _require_dense(config: LlamaConfig) -> None:
    if config.num_experts:
        raise NotImplementedError(f"the MoE MLP (num_experts > 0) {_NOT_PORTED}")


def init_params(
    config: LlamaConfig, seed: int = 0, device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """Random-init (scaled normal) parameters with stacked layers, drawn
    on ``device`` from ``seed``. The numbers are not ``jax.random``'s;
    parity tests carry the JAX params across with ``convert.py``."""
    _require_dense(config)
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

    params = {
        "embedding": normal((v, h), scale),
        "wq": normal((layers, h, nh * hd), scale),
        "wk": normal((layers, h, nkv * hd), scale),
        "wv": normal((layers, h, nkv * hd), scale),
        "wo": normal((layers, nh * hd, h), deep),
        "w_gate": normal((layers, h, f), scale),
        "w_up": normal((layers, h, f), scale),
        "w_down": normal((layers, f, h), deep),
        "attn_norm": norm_init((layers, h)),
        "mlp_norm": norm_init((layers, h)),
        "final_norm": norm_init((h,)),
    }
    if config.post_norms:
        params["post_attn_norm"] = norm_init((layers, h))
        params["post_mlp_norm"] = norm_init((layers, h))
    if config.qkv_bias:
        for name, width in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            params[name] = torch.zeros((layers, width), dtype=torch.float32, device=device)
    if not config.tie_embeddings:
        params["lm_head"] = normal((h, v), scale)
    return params


def init_cache(
    config: LlamaConfig,
    batch: int,
    max_len: Optional[int] = None,
    kv_quant: bool = False,
    device: torch.device | str = "cpu",
) -> Dict[str, torch.Tensor]:
    """Dense KV cache: [layers, batch, max_len, kv_heads, head_dim]."""
    if kv_quant:
        raise NotImplementedError(f"the int8 KV cache {_NOT_PORTED}")
    max_len = max_len or config.max_seq_len
    shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.dims_per_head)
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
    }


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
    post_norms config would otherwise run silently without them)."""
    required = []
    if config.qkv_bias:
        required += ["bq", "bk", "bv"]
    if config.post_norms:
        required += ["post_attn_norm", "post_mlp_norm"]
    if not config.tie_embeddings:
        required += ["lm_head"]
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


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ (w if w.dtype == x.dtype else w.to(x.dtype))


def _project_qkv(normed, params, i):
    """q/k/v projections with optional biases (Qwen-2); flat
    [..., H*D] / [..., KVH*D] — callers reshape to heads."""
    q = _matmul(normed, params["wq"][i])
    k = _matmul(normed, params["wk"][i])
    v = _matmul(normed, params["wv"][i])
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
    x = params["embedding"][ids].to(config.dtype)
    if config.scale_embedding:
        x = x * torch.tensor(math.sqrt(config.hidden_size), dtype=x.dtype)
    return x


def _mlp_block(config: LlamaConfig, normed: torch.Tensor, params, i) -> torch.Tensor:
    """Dense gated MLP (SwiGLU, or GeGLU for Gemma) on normed activations."""
    gate = _matmul(normed, params["w_gate"][i])
    up = _matmul(normed, params["w_up"][i])
    if config.act == "gelu_tanh":
        activated = F.gelu(gate, approximate="tanh")
    else:
        activated = F.silu(gate)
    return _matmul(activated * up, params["w_down"][i])


def _logits(config: LlamaConfig, params, x: torch.Tensor) -> torch.Tensor:
    if config.tie_embeddings:
        logits = (x @ params["embedding"].T.to(x.dtype)).float()
    else:
        logits = _matmul(x, params["lm_head"]).float()
    cap = config.final_logit_softcap
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    return logits


def _prefill_attn(config, q, k, v, lengths, window=None):
    """Prefill attention through the flash wrapper: the CUDA kernel when
    the tensors are on the card, the plain version on the CPU."""
    return flash_prefill_attention(
        q, k, v, lengths=lengths, softcap=config.attn_logit_softcap,
        window=window, scale=_attn_scale(config),
    )


def _decode_attn(config, q, kc, vc, lengths, window=None):
    """Decode attention through the flash-decode wrapper: the CUDA kernel
    when the tensors are on the card, the plain version on the CPU."""
    return flash_decode_attention(
        q, kc, vc, lengths, softcap=config.attn_logit_softcap,
        window=window, scale=_attn_scale(config),
    )


def _layer_tail(config, params, i, x, attn):
    """Output projection, residuals, the MLP block and the optional
    sandwich norms — shared by prefill and decode."""
    attn = _matmul(attn, params["wo"][i])
    if "post_attn_norm" in params:
        attn = _norm(config, attn, params["post_attn_norm"][i])
    x = x + attn
    normed = _norm(config, x, params["mlp_norm"][i])
    delta = _mlp_block(config, normed, params, i)
    if "post_mlp_norm" in params:
        delta = _norm(config, delta, params["post_mlp_norm"][i])
    return x + delta


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
    the cache at ``slot_ids`` (IN PLACE: the cache tensors are updated,
    not copied), and return the logits of each prompt's last real token
    [B, V] in f32. Rows past T keep their old contents; no live length
    ever reads them before a decode step rewrites them."""
    _require_dense(config)
    validate_family_params(config, params)
    batch, seq = tokens.shape
    hd = config.dims_per_head
    positions = torch.arange(seq, device=tokens.device)[None, :].expand(batch, seq)
    slot_ids = slot_ids.long()
    windows = layer_windows(config)
    x = _embed(config, params, tokens)  # [B, T, hidden]
    for i in range(config.num_layers):
        normed = _norm(config, x, params["attn_norm"][i])
        q, k, v = _project_qkv(normed, params, i)
        q = apply_rope(q.reshape(batch, seq, config.num_heads, hd), freqs, positions)
        k = apply_rope(k.reshape(batch, seq, config.num_kv_heads, hd), freqs, positions)
        v = v.reshape(batch, seq, config.num_kv_heads, hd)
        cache["k"][i, slot_ids, :seq] = k.to(cache["k"].dtype)
        cache["v"][i, slot_ids, :seq] = v.to(cache["v"].dtype)
        attn = _prefill_attn(
            config, q, k, v, lengths, window=windows[i] if windows else None
        )
        x = _layer_tail(config, params, i, x, attn.reshape(batch, seq, -1))
    last = x[torch.arange(batch, device=x.device), lengths.long() - 1]  # [B, hidden]
    return _logits(config, params, _norm(config, last, params["final_norm"]))


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
    _require_dense(config)
    validate_family_params(config, params)
    slots = tokens.shape[0]
    hd = config.dims_per_head
    positions = lengths.long() - 1  # -1 (empty slot) wraps; its write is masked
    rows = torch.arange(slots, device=tokens.device)
    if write_mask is None:
        write_mask = torch.ones(slots, dtype=torch.bool, device=tokens.device)
    keep = write_mask[:, None, None]
    windows = layer_windows(config)
    x = _embed(config, params, tokens)  # [S, hidden]
    for i in range(config.num_layers):
        normed = _norm(config, x, params["attn_norm"][i])
        q, k, v = _project_qkv(normed, params, i)
        q = apply_rope(q.reshape(slots, 1, config.num_heads, hd), freqs, positions[:, None])[:, 0]
        k = apply_rope(k.reshape(slots, 1, config.num_kv_heads, hd), freqs, positions[:, None])[:, 0]
        v = v.reshape(slots, config.num_kv_heads, hd)
        kc, vc = cache["k"][i], cache["v"][i]  # [S, T, KVH, D] views
        kc[rows, positions] = torch.where(keep, k.to(kc.dtype), kc[rows, positions])
        vc[rows, positions] = torch.where(keep, v.to(vc.dtype), vc[rows, positions])
        attn = _decode_attn(
            config, q, kc, vc, lengths, window=windows[i] if windows else None
        )
        x = _layer_tail(config, params, i, x, attn.reshape(slots, -1))
    return _logits(config, params, _norm(config, x, params["final_norm"]))


def prefill_at_offset(*args, **kwargs):
    """Warm-session suffix prefill (JAX ``model.prefill_at_offset``)."""
    raise NotImplementedError(f"prefill_at_offset {_NOT_PORTED}")


def verify_step(*args, **kwargs):
    """Speculative-decode verify pass (JAX ``model.verify_step``)."""
    raise NotImplementedError(f"verify_step {_NOT_PORTED}")
