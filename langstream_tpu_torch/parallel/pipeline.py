"""Pipeline parallelism: the GPipe schedule over the ``pp`` axis.

Port of ``langstream_tpu/parallel/pipeline.py``. The stacked layer leaves
split their leading (layer) axis over ``pp``, so each rank holds a
contiguous *stage* of ``num_layers / pp`` layers. JAX runs the schedule
inside ``shard_map`` as a scan over ticks, rotating activations with
``ppermute``, and differentiates through it. The port runs one process
per rank, so the schedule is written out:

- the forward, GPipe's: stage 0 embeds microbatch m and runs its layers,
  sends the activations to stage 1 (``collectives.send``), which receives
  them (``collectives.recv``), runs its layers, and so on; every stage
  takes the microbatches in order, all forwards first;
- the backward, all of it after the forwards, microbatch by microbatch
  in the same order: the last stage takes the final norm, the head and
  the microbatch's share of the loss and runs its backward, then sends
  the gradient of its input activations back to the stage before, which
  runs its own backward from it, and so on down to the embedding.

Each rank's sends and receives come in the same order as its peer's, so
no collective waits on another. The embedding, final norm and head are
replicated, as in JAX, but used only where they run: the embedding on the
first stage and the head on the last (a tied embedding on both), so the
trainer sums their gradients over ``pp``. A MoE stage's aux loss enters
the loss divided by ``layers × microbatches × dp`` (JAX's ``:174-179``).
The microbatches' rows split over ``dp`` as JAX's ``P(None, "dp")`` splits
them: each dp rank runs its own pipeline on its rows of every microbatch,
and its routing groups are those rows'.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from langstream_tpu_torch.parallel import collectives


def _stage_inputs(config, tokens, mask, mesh, num_microbatches):
    """(this dp rank's rows of each microbatch: tokens and mask [M, rows,
    T], the dp group, the pp group) after JAX's divisibility checks."""
    pp_group, dp_group = mesh.axis("pp"), mesh.axis("dp")
    if config.num_layers % pp_group.size:
        raise ValueError(f"pp={pp_group.size} must divide num_layers={config.num_layers}")
    batch, seq = tokens.shape
    if batch % num_microbatches:
        raise ValueError(f"microbatches={num_microbatches} must divide batch={batch}")
    mb = batch // num_microbatches
    if mb % dp_group.size:
        raise ValueError(f"dp={dp_group.size} must divide the microbatch size {mb} "
                         f"(batch {batch} / microbatches {num_microbatches})")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    rows = mb // dp_group.size
    own = slice(dp_group.rank * rows, (dp_group.rank + 1) * rows)
    tokens = tokens.reshape(num_microbatches, mb, seq)[:, own]
    mask = mask.reshape(num_microbatches, mb, seq)[:, own]
    return tokens, mask, dp_group, pp_group


def pipeline_apply(stage_fn, inputs: Sequence[Any], like: torch.Tensor, group, *,
                   grad: bool = True) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """GPipe's forward over ``group`` (the pp axis): microbatch m enters
    stage 0 as ``inputs[m]()`` (a callable: its graph is its own), each
    stage runs ``stage_fn(x, m) -> (y, aux)`` and sends y on. Returns
    each microbatch's (stage input, output, aux) on this stage: the input
    a leaf requiring grad past stage 0 (with ``grad``), the output valid
    for the next stage's use, the last stage's the pipeline's."""
    stage, last = group.rank, group.size - 1
    kept = []
    for m in range(len(inputs)):
        if stage == 0:
            x = inputs[m]()
        else:
            x = collectives.recv(group, like, stage - 1).requires_grad_(grad)
        y, aux = stage_fn(x, m)
        if stage < last:
            collectives.send(group, y.detach(), stage + 1)
        kept.append((x, y, aux))
    return kept


def _run_stages(config, params, layers, tokens, mask, freqs, mesh, num_microbatches, remat,
                grad: bool):
    from langstream_tpu_torch.providers.torch_local import model as model_lib

    tokens, mask, dp_group, pp_group = _stage_inputs(config, tokens, mask, mesh, num_microbatches)
    if layers is None:
        layers = model_lib.unstack_layers(params)
    offset = pp_group.rank * (config.num_layers // pp_group.size)
    rows, seq = tokens.shape[1:]
    like = torch.empty((rows, seq, config.hidden_size), dtype=config.dtype, device=tokens.device)

    def stage_fn(x, m):
        return model_lib.apply_layers(config, layers, x, mask[m], freqs, remat=remat,
                                      layer_offset=offset)

    inputs = [lambda m=m: model_lib._embed(config, params, tokens[m]) for m in range(num_microbatches)]
    kept = pipeline_apply(stage_fn, inputs, like, pp_group, grad=grad)
    return kept, tokens, mask, dp_group, pp_group


def _head(config, params, y):
    from langstream_tpu_torch.providers.torch_local import model as model_lib

    return model_lib._logits(config, params, model_lib._norm(config, y, params["final_norm"]))


@torch.no_grad()
def pipelined_logits(config, params, tokens: torch.Tensor, mask: Optional[torch.Tensor],
                     freqs: torch.Tensor, mesh, num_microbatches: int, with_aux: bool = False):
    """The full model's forward with the layer stack pipelined over
    ``pp`` (``mesh``: this rank's ``parallel.mesh.MeshGroup``; ``params``
    the stage's layers and the replicated leaves; ``tokens``/``mask`` the
    global batch on every rank) → logits [B, T, V] f32 on every rank, as
    JAX's returns them replicated; with ``with_aux`` also the mean MoE
    aux loss. No autograd: the loss's gradient is
    :func:`pipelined_loss_fn`'s."""
    kept, _, _, dp_group, pp_group = _run_stages(config, params, None, tokens, mask, freqs, mesh,
                                                 num_microbatches, remat=False, grad=False)
    last = pp_group.rank == pp_group.size - 1
    outs = torch.stack([_head(config, params, y) if last else
                        torch.zeros(y.shape[:-1] + (config.vocab_size,), device=y.device)
                        for _, y, _ in kept])  # [M, rows, T, V]
    outs = collectives.all_reduce_sum(pp_group, outs)
    outs = collectives.all_gather_cat(dp_group, outs, 1)
    logits = outs.reshape(tokens.shape[0], tokens.shape[1], -1)
    if not with_aux:
        return logits
    aux = sum(a for _, _, a in kept)
    aux = collectives.all_reduce_sum(dp_group, collectives.all_reduce_sum(pp_group, aux))
    return logits, aux / max(config.num_layers * num_microbatches * dp_group.size, 1)


def pipelined_loss_fn(config, params, tokens: torch.Tensor, mask: Optional[torch.Tensor],
                      freqs: torch.Tensor, mesh, num_microbatches: int,
                      moe_aux_weight: float = 0.0, remat: bool = False,
                      layers: Optional[Dict[str, Sequence[torch.Tensor]]] = None) -> torch.Tensor:
    """The causal cross-entropy over the pipelined forward plus, for a MoE
    model, ``moe_aux_weight`` times the mean aux loss (JAX's
    ``pipelined_loss_fn``), as the GPipe schedule computes it: the forward
    and then the backward of every microbatch, so this rank's parameters
    hold their gradient in ``.grad`` when it returns (the replicated
    leaves only this stage's part, for the trainer to sum over pp and
    dp). Returns the global loss, detached, on every rank."""
    from langstream_tpu_torch.ops.losses import causal_nll_sum

    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    count = torch.clamp_min(mask[:, 1:].float().sum(), 1.0)
    kept, tokens_mb, mask_mb, dp_group, pp_group = _run_stages(
        config, params, layers, tokens, mask, freqs, mesh, num_microbatches, remat, grad=True)
    stage, last = pp_group.rank, pp_group.size - 1
    aux_scale = (moe_aux_weight / max(config.num_layers * num_microbatches * dp_group.size, 1)
                 if config.num_experts else 0.0)
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for m, (x, y, aux) in enumerate(kept):
        part = aux_scale * aux
        if stage == last:
            # the microbatch's summed NLL over the global count of targets
            nll, _ = causal_nll_sum(_head(config, params, y), tokens_mb[m], mask_mb[m])
            part = part + nll / count
            outputs, grads = [part], [None]
        else:
            outputs, grads = [y], [collectives.recv(pp_group, y, stage + 1)]
            if part.requires_grad:
                outputs.append(part)
                grads.append(torch.ones_like(part))
        torch.autograd.backward(outputs, grads)
        if stage > 0:
            collectives.send(pp_group, x.grad, stage - 1)
        total = total + part.detach()
    return collectives.all_reduce_sum(dp_group, collectives.all_reduce_sum(pp_group, total))
