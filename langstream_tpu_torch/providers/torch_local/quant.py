"""Weight-only int8 weights for serving.

Port of ``langstream_tpu/providers/jax_local/quant.py``. The large matmul
weights are stored as int8 with one f32 scale per output channel, taken
over the contraction (input) axis: half the bytes of bf16 weights.

:func:`qmatmul` keeps the reference's arithmetic: it contracts against
``q.to(x.dtype)`` and multiplies the output by ``scale.to(x.dtype)``. A
per-output-channel scale commutes with the contraction, so the scale is
an elementwise op on activations, not on the weight. Eager PyTorch fuses
nothing, so ``q.to(x.dtype)`` writes a model-dtype copy of the weight on
every call and the product reads it back; the JAX package relies on XLA
to fuse that cast into the dot instead.

:class:`QTensor` slices its layer axis with ``w[i]``, ``q`` and ``scale``
together, so the model indexes a stacked int8 weight the way it indexes
a stacked model-dtype one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class QTensor:
    """An int8 weight: ``q`` int8 in the weight's shape, ``scale`` f32 in
    the weight's shape minus the contraction (second-to-last) axis."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, index) -> "QTensor":
        """One layer of a stacked weight ([L, in, out] → [in, out]): the
        leading axis of ``q`` and ``scale`` sliced together."""
        if self.q.dim() < 3:
            raise IndexError("only a stacked QTensor ([L, in, out]) is indexed by layer")
        return QTensor(self.q[index], self.scale[index])

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def to(self, device: Any) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))


def quantize(w: torch.Tensor, contract_axis: int = -2) -> QTensor:
    """Symmetric per-channel int8: the scale is the abs-max over the
    contraction axis over 127, floored at 1e-8; values round half to
    even. For a stacked weight [L, in, out], scale is [L, out]."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=contract_axis, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.squeeze(contract_axis))


def dq(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """Dequantize-or-cast: a QTensor → its weight in ``dtype``, a plain
    tensor → cast."""
    if isinstance(w, QTensor):
        return w.q.to(dtype) * w.scale.unsqueeze(-2).to(dtype)
    return w if w.dtype == dtype else w.to(dtype)


def qmatmul(x: torch.Tensor, w: Any, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` against an optionally quantized weight, the scale applied
    to the output: the JAX ``qeinsum`` for the model's one contraction
    (``"...h,hd->...d"``, x's last axis against w's second-to-last).
    ``out_dtype`` (f32 under tensor parallelism, for a row-sharded
    weight's partial sums) keeps the product's f32 accumulation unrounded:
    cuBLAS writes it in that dtype on the card; elsewhere the product runs
    in it."""
    if out_dtype is None or out_dtype == x.dtype:
        if isinstance(w, QTensor):
            return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
        return x @ (w if w.dtype == x.dtype else w.to(x.dtype))
    weight = w.q if isinstance(w, QTensor) else w
    if x.is_cuda:
        flat = _WideProduct.apply(x.reshape(-1, x.shape[-1]), weight.to(x.dtype), out_dtype)
        out = flat.reshape(*x.shape[:-1], flat.shape[-1])
    else:
        out = x.to(out_dtype) @ weight.to(out_dtype)
    return out * w.scale.to(out_dtype) if isinstance(w, QTensor) else out


class _WideProduct(torch.autograd.Function):
    """``torch.mm`` with a wider output dtype, which has no derivative of
    its own: the backward takes the gradient in the operands' dtype, as
    the product in that dtype would."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.to(x.dtype)
        return grad @ w.T, x.T @ grad, None


# the dense family's matmul weights; embedding and norms stay in their
# dtype (a lookup and elementwise ops)
QUANTIZED_PARAMS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def quantize_params(params: Dict[str, Any], num_experts: int = 0) -> Dict[str, Any]:
    """Quantize the large matmul weights of a stacked param dict.
    Idempotent: leaves already quantized pass through. MoE expert
    weights stay as they are, as in the JAX package."""
    out = dict(params)
    moe_names = {"w_gate", "w_up", "w_down"} if num_experts else set()
    for name in QUANTIZED_PARAMS:
        if name in out and name not in moe_names and not isinstance(out[name], QTensor):
            out[name] = quantize(out[name])
    return out


def quantize_logical_axes(axes: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """A logical-axes dict over quantized params, the JAX package's
    ``quantize_logical_axes``: an int8 leaf's axes become a
    :class:`QTensor` of axes, ``q`` the weight's and ``scale`` the
    weight's without the contraction axis, so that a column-sharded
    weight's scale (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``,
    ``lm_head``) splits with it and a row-sharded one's (``wo``,
    ``w_down``) stays whole."""
    from langstream_tpu_torch.parallel.mesh import L

    out = dict(axes)
    for name, value in params.items():
        if isinstance(value, QTensor) and name in out:
            names = out[name].names
            out[name] = QTensor(q=L(*names), scale=L(*(names[:-2] + (names[-1],))))
    return out


def init_quantized_params(
    config, seed: int = 0, direct: Optional[bool] = None, device: Any = "cpu", keep=None,
) -> Dict[str, Any]:
    """Random int8 weights drawn directly on ``device`` from a generator
    seeded with ``seed``: the model-dtype weights are never made, so
    Llama-3-8B takes ~8.5 GB instead of 16 GB of bf16 first. ``direct=None``
    picks by size: small models go through ``init_params`` and
    :func:`quantize_params`. The numbers are not ``jax.random``'s.
    ``keep(name, leaf)`` is applied to each leaf once it is quantized (a
    tp rank keeps its shard, as ``model.init_params`` does)."""
    from langstream_tpu_torch.providers.torch_local import model as model_lib

    if direct is None:
        direct = config.num_params() >= 5e8 and not config.num_experts
    if not direct or config.num_experts:
        moe_names = {"w_gate", "w_up", "w_down"} if config.num_experts else set()

        def quantized(name, leaf):
            if name in QUANTIZED_PARAMS and name not in moe_names:
                leaf = quantize(leaf)
            return keep(name, leaf) if keep is not None else leaf

        return model_lib.init_params(config, seed=seed, device=device, keep=quantized)
    generator = torch.Generator(device=device).manual_seed(seed)
    h = config.hidden_size
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.dims_per_head
    f, v, layers = config.intermediate_size, config.vocab_size, config.num_layers
    scale = 1.0 / math.sqrt(h) / 127.0

    def q_init(shape):
        q = torch.randint(-127, 128, shape, generator=generator, dtype=torch.int8, device=device)
        return QTensor(q=q, scale=torch.full(shape[:-2] + shape[-1:], scale, device=device))

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    norm_fill = 0.0 if config.norm_plus_one else 1.0
    out: Dict[str, Any] = {}

    def put(name, leaf):
        out[name] = keep(name, leaf) if keep is not None else leaf

    embedding = torch.empty((v, h), dtype=config.dtype, device=device)
    put("embedding", embedding.normal_(0.0, 1.0 / math.sqrt(h), generator=generator))
    put("wq", q_init((layers, h, nh * hd)))
    put("wk", q_init((layers, h, nkv * hd)))
    put("wv", q_init((layers, h, nkv * hd)))
    put("wo", q_init((layers, nh * hd, h)))
    put("w_gate", q_init((layers, h, f)))
    put("w_up", q_init((layers, h, f)))
    put("w_down", q_init((layers, f, h)))
    put("attn_norm", full((layers, h), norm_fill))
    put("mlp_norm", full((layers, h), norm_fill))
    put("final_norm", full((h,), norm_fill))
    if config.post_norms:
        put("post_attn_norm", full((layers, h), norm_fill))
        put("post_mlp_norm", full((layers, h), norm_fill))
    if config.qkv_bias:
        for name, width in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            put(name, full((layers, width), 0.0))
    if not config.tie_embeddings:
        put("lm_head", q_init((h, v)))
    return out


# the fields whose values change what a draw holds (the JAX package's
# list): runtime knobs such as ``use_flash`` stay out, so runs that differ
# only in them share an entry
_CACHE_SIG_FIELDS = (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "head_dim", "num_experts",
    "num_experts_per_tok", "tie_embeddings", "post_norms",
    "qkv_bias", "norm_plus_one", "scale_embedding", "act", "dtype",
)
_CACHE_STALE_S = 300.0


def weights_cache_key(config, seed: int) -> str:
    """The JAX package's key: readable dims, the norm convention, a SHA-1
    digest of the weight-relevant fields, and the seed. Shape-identical
    configs whose draws differ (a norm-convention flip fills norms with 0
    instead of 1; sandwich norms, qkv biases, a tied head) never share an
    entry."""
    import hashlib

    known = {f.name for f in dataclasses.fields(type(config))}
    signature = "|".join(f"{name}={getattr(config, name)!r}"
                         for name in _CACHE_SIG_FIELDS if name in known)
    convention = "".join(tag for tag, on in (
        ("z1", config.norm_plus_one), ("pn", config.post_norms),
        ("qb", config.qkv_bias), ("te", config.tie_embeddings)) if on) or "std"
    digest = hashlib.sha1(signature.encode()).hexdigest()[:10]
    return (f"int8_{config.num_layers}L_{config.hidden_size}h_{config.num_params()}p_"
            f"{convention}_{digest}_s{seed}")


def _leaves(params: Dict[str, Any]):
    """(name, part, tensor) of each stored leaf: a QTensor is two."""
    for name, value in params.items():
        if isinstance(value, QTensor):
            yield name, "q", value.q
            yield name, "scale", value.scale
        else:
            yield name, "", value


def _storable(tensor: torch.Tensor):
    """A host numpy array of ``tensor``; bf16 rides as its uint16 bits."""
    host = tensor.detach().cpu()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view("uint16")
    return host.numpy()


def _load_cached(path: str, device: Any) -> Dict[str, Any]:
    import json

    import numpy as np

    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["manifest"]).decode())
        parts: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, (name, part, dtype, shape) in enumerate(manifest):
            raw = data[f"a{i}"]
            if dtype == "torch.bfloat16":
                tensor = torch.from_numpy(raw.view("int16")).view(torch.bfloat16)
            else:
                tensor = torch.from_numpy(raw)
            if str(tensor.dtype) != dtype or list(tensor.shape) != shape:
                raise ValueError(f"leaf {name}{'.' + part if part else ''} does not match its "
                                 "manifest")
            parts.setdefault(name, {})[part] = tensor.to(device)
    out: Dict[str, Any] = {}
    for name, leaf in parts.items():
        out[name] = QTensor(q=leaf["q"], scale=leaf["scale"]) if "q" in leaf else leaf[""]
    return out


def init_quantized_params_cached(config, seed: int = 0, cache_dir: Optional[str] = None,
                                 device: Any = "cpu", keep=None) -> Dict[str, Any]:
    """:func:`init_quantized_params` with an opt-in cache on disk, the JAX
    package's ``init_quantized_params_cached``: off unless ``cache_dir``
    or ``$LS_WEIGHTS_CACHE_DIR`` names a directory, and then a retry
    loads the draw instead of drawing and quantizing again. Off, or with
    ``keep`` (a tp rank keeps only its shard, and a shard is not cached),
    it is the plain draw on ``device``.

    An entry is ``<key>.npz`` (:func:`weights_cache_key`): one array per
    leaf (a QTensor's ``q`` and ``scale`` apart; bf16 as uint16 bits)
    and a manifest of each leaf's name, part, dtype and shape. Its format
    is the port's own: the port draws with a torch generator, so its
    entries are not the JAX package's. Writes are atomic (a temporary
    file, then ``os.replace``); temporary files older than 5 minutes,
    left by a killed writer, are swept; an entry that cannot be used is
    deleted and the weights drawn again. The loaded leaves go to
    ``device``."""
    import json
    import logging
    import os
    import time

    import numpy as np

    cache_dir = cache_dir or os.environ.get("LS_WEIGHTS_CACHE_DIR", "")
    if not cache_dir or keep is not None:
        return init_quantized_params(config, seed=seed, device=device, keep=keep)
    os.makedirs(cache_dir, exist_ok=True)
    now = time.time()
    for name in os.listdir(cache_dir):
        if ".tmp" in name:
            stale = os.path.join(cache_dir, name)
            try:
                if now - os.path.getmtime(stale) > _CACHE_STALE_S:
                    os.unlink(stale)
            except OSError:
                pass
    path = os.path.join(cache_dir, weights_cache_key(config, seed) + ".npz")
    if os.path.exists(path):
        try:
            return _load_cached(path, device)
        except Exception as error:  # noqa: BLE001 — a torn or stale entry is drawn again
            try:
                os.unlink(path)
            except OSError:
                pass
            logging.getLogger(__name__).warning(
                "weights cache %s unusable (%r); drawing the weights again", path, error)
    params = init_quantized_params(config, seed=seed, device=device)
    manifest, arrays = [], {}
    for i, (name, part, tensor) in enumerate(_leaves(params)):
        manifest.append([name, part, str(tensor.dtype), list(tensor.shape)])
        arrays[f"a{i}"] = _storable(tensor)
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(), np.uint8).copy()
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return params
