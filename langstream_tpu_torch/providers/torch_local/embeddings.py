"""Text embeddings on the card: a BERT-style bidirectional encoder in
PyTorch.

Port of ``langstream_tpu/providers/jax_local/embeddings.py``: token and
learned position embeddings, N post-norm transformer layers with
bidirectional attention, masked mean pooling, L2 normalisation (the
sentence-transformers recipe of all-MiniLM class models). Weights load
from a local HuggingFace BERT checkpoint (``weights.load_hf_bert``);
random ones serve tests and the smoke.

Every step follows the JAX encoder to the bit it can: the tanh
approximation of GELU (``jax.nn.gelu``'s default), the population
variance in f32, the ``-1e30`` attention mask in f32 (an all-padding row
comes out as zeros, never NaN), positions sliced at the length bucket,
pooling in f32. The encoder is f32 and must not run its matmuls in TF32:
nothing in the port turns TF32 on.

:class:`TorchEmbedder` buckets lengths and rows as ``JaxEmbedder`` does,
so the card sees a few fixed shapes. On the card it runs on a CUDA
stream of its own, one call at a time, and waits on an event of that
stream, never on the device: an engine beside it may be capturing CUDA
graphs on its own stream meanwhile.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from langstream_tpu_torch.device import resolve_device

# the leaves of the stacked param dict, in the JAX encoder's layer order
LAYER_LEAVES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "attn_norm_w", "attn_norm_b",
                "w_in", "b_in", "w_out", "b_out", "mlp_norm_w", "mlp_norm_b")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 6
    num_heads: int = 12
    max_positions: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @classmethod
    def minilm_l6(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        return cls(vocab_size=300, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=4, max_positions=64)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "EncoderConfig":
        """A preset (``minilm-l6``, ``tiny``) or explicit dims, dashes or
        underscores; unknown keys are ignored. ``dtype`` takes a torch
        dtype or its name."""
        known = {f.name for f in dataclasses.fields(cls)}
        clean = {k.replace("-", "_"): v for k, v in config.items()}
        preset = clean.pop("preset", None)
        if preset == "minilm-l6":
            return cls.minilm_l6()
        if preset == "tiny":
            return cls.tiny()
        if isinstance(clean.get("dtype"), str):
            clean["dtype"] = getattr(torch, clean["dtype"])
        return cls(**{k: v for k, v in clean.items() if k in known})

    def param_shapes(self) -> Dict[str, tuple]:
        """The shape of every leaf of the stacked param dict."""
        h, f, L = self.hidden_size, self.intermediate_size, self.num_layers
        shapes = {"tok_emb": (self.vocab_size, h), "pos_emb": (self.max_positions, h),
                  "emb_norm_w": (h,), "emb_norm_b": (h,)}
        for leaf in LAYER_LEAVES:
            if leaf.startswith("w"):
                shapes[leaf] = (L, h, f) if leaf == "w_in" else (L, f, h) if leaf == "w_out" else (L, h, h)
            else:
                shapes[leaf] = (L, f) if leaf == "b_in" else (L, h)
        return shapes


def init_encoder_params(config: EncoderConfig, seed: int = 0,
                        device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Random weights (normal, scale 0.02; biases 0, norms 1), drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``. The same
    leaves and shapes as the JAX ``init_encoder_params``, not its draws."""
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    dt = config.dtype

    def normal(shape):
        drawn = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (drawn * 0.02).to(dt)

    params = {}
    for name, shape in config.param_shapes().items():
        if name.endswith("_w"):
            params[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif name.endswith("_b") and "norm" in name:
            params[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif name.startswith("b"):
            params[name] = torch.zeros(shape, dtype=dt, device=device)
        else:
            params[name] = normal(shape)
    return params


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32 with the population variance, cast back to
    ``x.dtype`` (the JAX ``_layer_norm``)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(x.dtype)


def encode(
    config: EncoderConfig,
    params: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # [B, T] integer ids
    mask: torch.Tensor,    # [B, T] bool
) -> torch.Tensor:
    """Forward pass → L2-normalised mean-pooled embeddings [B, H], f32."""
    batch, seq = tokens.shape
    heads = config.num_heads
    hd = config.hidden_size // heads
    x = params["tok_emb"][tokens.long()] + params["pos_emb"][:seq][None]
    x = _layer_norm(x, params["emb_norm_w"], params["emb_norm_b"], config.norm_eps)
    x = x.to(config.dtype)
    keep = mask[:, None, None, :].bool()
    for layer in range(config.num_layers):
        (wq, bq, wk, bk, wv, bv, wo, bo, anw, anb,
         w_in, b_in, w_out, b_out, mnw, mnb) = (params[leaf][layer] for leaf in LAYER_LEAVES)
        q = (x @ wq + bq).view(batch, seq, heads, hd)
        k = (x @ wk + bk).view(batch, seq, heads, hd)
        v = (x @ wv + bv).view(batch, seq, heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
        scores = scores.masked_fill(~keep, -1e30)
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(batch, seq, -1)
        attn = attn @ wo + bo
        x = _layer_norm(x + attn, anw, anb, config.norm_eps)
        mlp = F.gelu(x @ w_in + b_in, approximate="tanh")
        mlp = mlp @ w_out + b_out
        x = _layer_norm(x + mlp, mnw, mnb, config.norm_eps)
    # masked mean pooling + L2 normalise, in f32
    weights = mask.float()[..., None]
    pooled = (x.float() * weights).sum(1) / weights.sum(1).clamp_min(1e-9)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp_min(1e-9)


def _next_pow2(value: int, floor: int = 1) -> int:
    size = floor
    while size < value:
        size *= 2
    return size


class TorchEmbedder:
    """Bucketed-length batch embedding front-end (``JaxEmbedder``): a
    batch is padded to ``min(next_pow2(longest, floor=16), max_length)``
    tokens and to a power of two of rows (padding rows all masked, their
    vectors zeros and dropped), so ragged traffic meets log2 shapes."""

    def __init__(
        self,
        config: EncoderConfig,
        params: Dict[str, torch.Tensor],
        tokenizer,
        max_length: int = 256,
        device: Any = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.params = {name: leaf.to(self.device) for name, leaf in params.items()}
        self.tokenizer = tokenizer
        self.max_length = min(max_length, config.max_positions)
        self._lock = threading.Lock()
        self._stream = None
        if self.device.type == "cuda":
            # the embedder's own stream, ordered after whatever wrote the
            # params on the caller's stream
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def batch(self, texts: List[str]):
        """(tokens, mask) as int32 / bool numpy arrays of the padded
        (rows, bucket) shape the encoder runs for ``texts``."""
        token_lists = [self.tokenizer.encode(text)[: self.max_length] for text in texts]
        longest = max((len(t) for t in token_lists), default=1)
        bucket = min(_next_pow2(longest, floor=16), self.max_length)
        padded_rows = _next_pow2(max(1, len(texts)))
        tokens = np.zeros((padded_rows, bucket), dtype=np.int32)
        mask = np.zeros((padded_rows, bucket), dtype=bool)
        for i, ids in enumerate(token_lists):
            ids = ids[:bucket]
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        return tokens, mask

    def encode_batch(self, tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """The encoder over one padded batch; the vectors on the host
        (all padded rows)."""
        with self._lock:
            if self._stream is None:
                return encode(self.config, self.params, torch.from_numpy(tokens),
                              torch.from_numpy(mask))
            with torch.cuda.stream(self._stream):
                out = encode(self.config, self.params,
                             torch.from_numpy(tokens).to(self.device, non_blocking=True),
                             torch.from_numpy(mask).to(self.device, non_blocking=True))
                done = torch.cuda.Event()
                done.record(self._stream)
                done.synchronize()
                # nothing else is queued on the stream: the copy is all it waits for
                return out.cpu()

    def embed(self, texts: List[str]) -> List[List[float]]:
        tokens, mask = self.batch(texts)
        return self.encode_batch(tokens, mask)[: len(texts)].tolist()
