"""Carry the JAX package's parameters and KV caches into the port.

The JAX stacked-layer param dict (``model.init_params``) holds arrays in
the ``[in, out]`` layout the port keeps, so each leaf crosses as it is.
numpy arrays of JAX bf16 carry the ``ml_dtypes.bfloat16`` dtype, which
``torch.from_numpy`` rejects: they go through float32, which holds every
bf16 value exactly, and come back to bf16 on the torch side.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from langstream_tpu_torch.providers.torch_local.model import (
    LlamaConfig,
    validate_family_params,
)

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


def tensor_from_numpy(array: Any, device: torch.device | str = "cpu") -> torch.Tensor:
    array = np.asarray(array)
    name = array.dtype.name
    if name not in _TORCH_DTYPES:
        raise TypeError(f"cannot carry a {name} array across")
    if name == "bfloat16":
        array = array.astype(np.float32)  # exact: bf16 ⊂ f32
    # a copy: JAX hands out read-only buffers
    return torch.tensor(array).to(device=device, dtype=_TORCH_DTYPES[name])


def params_from_jax(
    np_params: Dict[str, Any],
    config: LlamaConfig,
    device: torch.device | str = "cpu",
) -> Dict[str, torch.Tensor]:
    """JAX params (numpy arrays, or anything ``np.asarray`` takes) → the
    port's param dict on ``device``, each leaf in its own dtype. Int8
    weight-only leaves (the JAX ``QTensor``) are not ported yet."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in np_params.items():
        if hasattr(leaf, "scale") and hasattr(leaf, "q"):
            raise NotImplementedError(
                "int8 weight-only params are not ported yet (see ROADMAP.md)"
            )
        out[name] = tensor_from_numpy(leaf, device)
    validate_family_params(config, out)
    return out


def cache_from_jax(
    np_cache: Dict[str, Any], device: torch.device | str = "cpu"
) -> Dict[str, torch.Tensor]:
    """A JAX KV cache (numpy arrays, or anything ``np.asarray`` takes) →
    the port's cache dict on ``device``. Both layouts cross as they are:
    the dense ``[L, S, T, KVH, D]`` cache and the paged ``[L, N, Bs, KVH,
    D]`` pool have the same shapes on both sides, and so does the int8
    cache (int8 values, f32 ``k_scale``/``v_scale`` without the head dim)."""
    return {name: tensor_from_numpy(leaf, device) for name, leaf in np_cache.items()}
