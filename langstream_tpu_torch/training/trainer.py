"""Next-token training on the Llama model definition, on one card.

Port of ``langstream_tpu/training/trainer.py`` for a mesh of size 1: the
JAX train step, one jitted ``value_and_grad`` and optax update over a
``dp × fsdp × tp`` mesh, becomes a forward and backward in autograd and
an optimizer step that updates the parameters in place.

- The loss is :func:`loss_fn`: the causal cross-entropy over the
  differentiable ``model.forward``, whose attention is the plain
  ``prefill_attention``, the formulation JAX differentiates; a MoE model
  (Mixtral) adds ``moe_aux_weight`` times the router's load-balancing
  loss, its MLP in the capacity regime, as JAX's trains.
- The optimizer is JAX's chain, ``optax.clip_by_global_norm(grad_clip)``
  then ``optax.adamw(lr, b1, b2, weight_decay)`` with eps 1e-8 and no
  mask (the decay reaches every leaf, norms included). The clip is
  optax's rule, written out (:func:`clip_by_global_norm_`):
  ``clip_grad_norm_`` divides by ``norm + 1e-6`` and scales below the
  max too. ``torch.optim.AdamW`` computes optax's update: its decay
  multiplies by ``1 - lr·wd`` before the Adam step where optax adds
  ``wd·p`` to the update, both from the old parameter. ``mu`` and ``nu``
  keep the parameters' dtype, as optax's do.
- ``remat`` recomputes each layer in the backward
  (``torch.utils.checkpoint``); JAX wraps the whole loss in
  ``jax.checkpoint(..., nothing_saveable)``. The gradient is the same,
  the peak memory is not.
- A mesh with any axis above 1, pp and ep included, raises (ROADMAP.md,
  A10), so ``TrainConfig`` has no ``num_microbatches`` (A11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import torch

from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.ops.losses import causal_ce_loss
from langstream_tpu_torch.parallel.mesh import MeshConfig, require_single_card
from langstream_tpu_torch.providers.torch_local import model as model_lib

ADAM_EPS = 1e-8  # optax.adamw's default


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True
    # MoE load-balancing loss weight (ignored for dense models)
    moe_aux_weight: float = 0.01


def loss_fn(config, params, tokens, mask, freqs, remat: bool = False,
            moe_aux_weight: float = 0.01) -> torch.Tensor:
    """Causal next-token cross-entropy, mean over valid positions, plus
    ``moe_aux_weight`` times the router's load-balancing loss for a MoE
    model (a dense model's aux loss is 0)."""
    logits, aux = model_lib.forward(config, params, tokens, mask=mask, freqs=freqs,
                                    with_aux=True, remat=remat)
    return causal_ce_loss(logits, tokens, mask) + moe_aux_weight * aux


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with the global norm (f32
    sums of squares over every leaf) at or above ``max_norm``, each
    gradient becomes ``(g / norm) * max_norm``; below it, each stays as it
    is. Returns the norm. No host sync."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g.float().square()) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, (g / norm.to(g.dtype)) * max_norm, g))
    return norm


class Trainer:
    def __init__(
        self,
        model_config: model_lib.LlamaConfig,
        params: Dict[str, torch.Tensor],
        *,
        mesh_config: Optional[MeshConfig] = None,
        train_config: Optional[TrainConfig] = None,
        device: Any = "cuda",
    ) -> None:
        require_single_card(mesh_config)
        model_lib.validate_family_params(model_config, params)
        self.model_config = model_config
        self.train_config = train_config or TrainConfig()
        self.device = resolve_device(device)
        # the trainer's own leaves: the step updates them in place
        self.params = {
            name: leaf.detach().to(self.device, copy=True).requires_grad_()
            for name, leaf in params.items()
        }
        self.freqs = model_lib.model_freqs(model_config, device=self.device)
        tc = self.train_config
        self.optimizer = torch.optim.AdamW(
            list(self.params.values()), lr=tc.learning_rate, betas=(tc.b1, tc.b2),
            eps=ADAM_EPS, weight_decay=tc.weight_decay,
        )
        self.step = 0

    def train_step(self, tokens, mask) -> float:
        """Run one step; tokens/mask are host arrays [B, T]."""
        tokens = torch.as_tensor(tokens, dtype=torch.int32).to(self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool).to(self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(self.model_config, self.params, tokens, mask, self.freqs,
                       remat=self.train_config.remat,
                       moe_aux_weight=self.train_config.moe_aux_weight)
        loss.backward()
        clip_by_global_norm_((p.grad for p in self.params.values()),
                             self.train_config.grad_clip)
        self.optimizer.step()
        self.step += 1
        return float(loss.detach())

    # ------------------------------------------------------------------ #
    # optimizer state by parameter name, in optax's terms
    # ------------------------------------------------------------------ #
    @property
    def opt_state(self) -> Dict[str, Any]:
        """AdamW's state as ``{"count": steps taken, "mu": {name:
        exp_avg}, "nu": {name: exp_avg_sq}}`` (the tensors themselves, not
        copies; empty dicts before the first step)."""
        state = {"count": 0, "mu": {}, "nu": {}}
        for name, param in self.params.items():
            slot = self.optimizer.state.get(param)
            if slot:
                state["count"] = int(slot["step"])
                state["mu"][name] = slot["exp_avg"]
                state["nu"][name] = slot["exp_avg_sq"]
        return state

    def _load_opt_state(self, opt_state: Dict[str, Any]) -> None:
        self.optimizer.state.clear()
        mu, nu = opt_state.get("mu", {}), opt_state.get("nu", {})
        for name, param in self.params.items():
            if name not in mu:
                continue
            self.optimizer.state[param] = {
                "step": torch.tensor(float(opt_state["count"]), dtype=torch.float32),
                "exp_avg": _placed(mu[name], param, f"mu/{name}"),
                "exp_avg_sq": _placed(nu[name], param, f"nu/{name}"),
            }

    # ------------------------------------------------------------------ #
    # checkpoint / resume
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, manager, *, wait: bool = False) -> None:
        """Save (params, opt_state, step) through a
        ``training.checkpoint.CheckpointManager``: every tensor is on the
        host when this returns, the files are written behind it."""
        from langstream_tpu_torch.training.checkpoint import config_meta

        manager.save(
            self.step, self.params, self.opt_state,
            meta={"model_config": config_meta(self.model_config)},
        )
        if wait:
            manager.wait()

    def restore_checkpoint(self, manager, step=None) -> int:
        """Restore params/opt_state/step in place (the same tensors, so
        the optimizer keeps them). Returns the restored step."""
        restored = manager.restore(step)
        with torch.no_grad():
            for name, param in self.params.items():
                param.copy_(_placed(restored["params"][name], param, name))
        if restored.get("opt_state") is not None:
            self._load_opt_state(restored["opt_state"])
        self.step = restored["step"]
        return self.step


def _placed(tensor: torch.Tensor, like: torch.Tensor, name: str) -> torch.Tensor:
    """``tensor`` on ``like``'s device, after checking it has ``like``'s
    shape and dtype (a copy would cast silently)."""
    if tensor.shape != like.shape or tensor.dtype != like.dtype:
        raise ValueError(f"{name}: checkpoint holds {tensor.dtype} {list(tensor.shape)}, the "
                         f"trainer {like.dtype} {list(like.shape)}")
    return tensor.to(like.device)
