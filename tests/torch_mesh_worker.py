"""Rank programs for the port's training-mesh CPU tests
(``tests/test_torch_mesh_training.py``, ``tests/test_torch_pp.py``,
``tests/test_torch_sp.py``).

Each test file starts one pool of :data:`POOL` ranks as processes over
gloo with ``langstream_tpu_torch.parallel.launch`` (``spawn_ranks(...,
ranks=range(POOL))``), each running one function of this module as
``FUNCTION(rank, world, device, payload)``. A case on a mesh of ``n``
ranks runs on the pool's first ``n`` (:func:`case_world`: a
``torch.distributed`` world of its own, over a file store); the others
go on to the next case. Rank 0 saves each case's outputs to a file the
test reads back. The module imports the port only, never JAX: the test
process holds the JAX references. The inputs come from
:func:`train_batch` and :func:`attention_inputs`, which both sides
import.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from langstream_tpu_torch.parallel.mesh import MeshConfig, build_mesh, mesh_coords
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.providers.torch_local.convert import params_from_jax

torch.set_num_threads(1)

POOL = 4
TIMEOUT_S = 150
BATCH, SEQ = 4, 16


def preset(name: str, layers: int = 0, sliding_window: int = 0) -> model.LlamaConfig:
    """A tiny preset in f32, cut to ``layers`` and given a
    ``sliding_window`` where those are set (the settings of
    ``tests/test_pipeline.py``)."""
    config = dataclasses.replace(getattr(model.LlamaConfig, name)(), dtype=torch.float32)
    if layers:
        config = dataclasses.replace(config, num_layers=layers)
    if sliding_window:
        config = dataclasses.replace(config, sliding_window=sliding_window)
    return config


def train_batch(vocab: int, seed: int = 7):
    """The global batch [BATCH, SEQ] from ``seed``, row 1 right-padded to
    10 tokens: the ranks' masks differ."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(BATCH, SEQ)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), dtype=bool)
    mask[1, 10:] = False
    return tokens, mask


def attention_inputs(batch, seq, heads, kv_heads, dim, seed):
    """q, k, v and the output's cotangent, f32, from ``seed``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, seq, heads, dim)).astype(np.float32)
    k = rng.standard_normal((batch, seq, kv_heads, dim)).astype(np.float32)
    v = rng.standard_normal((batch, seq, kv_heads, dim)).astype(np.float32)
    cotangent = rng.standard_normal((batch, seq, heads, dim)).astype(np.float32)
    return q, k, v, cotangent


def load_params(path: str, config: model.LlamaConfig) -> Dict[str, torch.Tensor]:
    with np.load(path) as stored:
        return params_from_jax(dict(stored), config)


@contextlib.contextmanager
def case_world(rank: int, size: int, store: str):
    """A world of the pool's first ``size`` ranks for one case (yields
    False on the ranks outside it, which skip the case)."""
    if rank >= size:
        yield False
        return
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        yield True
    finally:
        dist.destroy_process_group()


def run_pool(rank: int, payload: Dict[str, Any], fn) -> None:
    """Each case of ``payload["cases"]`` through ``fn(rank, case,
    payload) -> outputs`` in its own world; rank 0 saves each case's
    outputs as ``<out>.<case name>.npz`` (an ``error`` entry where the
    case raised, with its message). The pool's own world (started by
    ``parallel.launch``) is left for the cases'; a rank that has run its
    cases exits without waiting for the others."""
    out = payload["out"]
    dist.destroy_process_group()
    for index, case in enumerate(payload["cases"]):
        with case_world(rank, case["size"], f"{out}.store{index}") as member:
            if not member:
                continue
            try:
                saved = fn(rank, case, payload)
            except Exception as exc:  # reported to the test, which names it
                saved = {"error": np.array(f"{type(exc).__name__}: {exc}\n"
                                           f"{traceback.format_exc()}")}
            if rank == 0:
                np.savez(f"{out}.{case['name']}.npz", **saved)


def start_pool(function: str, cases, payload: Dict[str, Any], root: str, repo: str):
    """Start the pool on ``function`` of this module over ``cases`` (the
    test side): returns (the children, ``wait(name)``, which waits for
    the pool once and returns one case's saved outputs)."""
    from langstream_tpu_torch.parallel import launch
    from langstream_tpu_torch.runtime.multihost import free_port

    out = os.path.join(root, "out")
    children = launch.spawn_ranks(
        f"torch_mesh_worker:{function}", {**payload, "cases": cases, "out": out},
        ["cpu"] * POOL, f"127.0.0.1:{free_port()}", timeout_s=TIMEOUT_S, ranks=range(POOL),
        path=[os.path.join(repo, "tests")], cwd=repo)
    codes = []

    def wait(name: str) -> Dict[str, np.ndarray]:
        if not codes:
            codes.append(launch.stop_ranks(children, timeout_s=8 * TIMEOUT_S))
        assert codes[0] == [0] * POOL, codes[0]
        saved = dict(np.load(f"{out}.{name}.npz"))
        assert "error" not in saved, str(saved["error"])
        return saved

    return children, wait


def mesh_of(case) -> MeshConfig:
    return MeshConfig(**case["mesh"])


# ---------------------------------------------------------------------- #
# the trainer on a mesh
# ---------------------------------------------------------------------- #
def _replicas_differ(trainer) -> list:
    """The leaves whose slices differ between two ranks that hold the
    same one (the same coordinates on the leaf's split axes)."""
    differ = []
    world = trainer.mesh_config.size
    for name, param in trainer.params.items():
        parts = [torch.empty_like(param.detach()) for _ in range(world)]
        dist.all_gather(parts, param.detach().contiguous())
        axes = [axis for _, axis in trainer._splits[name]]
        seen = {}
        for other, part in enumerate(parts):
            coords = mesh_coords(trainer.mesh_config, other)
            key = tuple(coords[axis] for axis in axes)
            if key in seen and not torch.equal(seen[key], part):
                differ.append(name)
                break
            seen.setdefault(key, part)
    return differ


def _train_config(case):
    from langstream_tpu_torch.training import trainer as trainer_lib

    return trainer_lib.TrainConfig(**case["train"])


def train_case(rank: int, case: Dict[str, Any], payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """One mesh case: three steps of the Trainer on ``case["mesh"]``
    from the JAX-drawn params → the losses, the first step's gradient and
    the params after three steps (gathered full), and the leaves whose
    replicas differ; with ``checkpoint``, the state saved after step 3
    and step 4's loss; with ``restore``, a trainer on this mesh restored
    from that checkpoint: its params and its next loss."""
    from langstream_tpu_torch.training import checkpoint as checkpoint_lib
    from langstream_tpu_torch.training import trainer as trainer_lib

    config = preset(case["preset"], case.get("layers", 0), case.get("sliding_window", 0))
    params = load_params(payload["params"][case["params"]], config)
    mesh = mesh_of(case)
    trainer = trainer_lib.Trainer(config, params, mesh_config=mesh if mesh.size > 1 else None,
                                  train_config=_train_config(case), device="cpu")
    tokens, mask = train_batch(config.vocab_size)
    saved: Dict[str, np.ndarray] = {}
    if case.get("restore"):
        manager = checkpoint_lib.CheckpointManager(case["restore"])
        step = trainer.restore_checkpoint(manager)
        full = trainer.gathered({name: p.detach() for name, p in trainer.params.items()})
        saved.update({f"params/{name}": leaf.numpy() for name, leaf in full.items()})
        saved["losses"] = np.array([trainer.train_step(tokens, mask)])
        saved["step"] = np.array(step)
        return saved
    losses = [trainer.train_step(tokens, mask)]
    grads = trainer.gathered({name: p.grad for name, p in trainer.params.items()})
    saved.update({f"grads/{name}": leaf.numpy() for name, leaf in grads.items()})
    losses += [trainer.train_step(tokens, mask) for _ in range(2)]
    full = trainer.gathered({name: p.detach() for name, p in trainer.params.items()})
    saved.update({f"params/{name}": leaf.numpy() for name, leaf in full.items()})
    saved["differ"] = np.array(json.dumps(_replicas_differ(trainer)))
    saved["count"] = np.array(trainer.opt_state["count"])
    if case.get("checkpoint"):
        manager = checkpoint_lib.CheckpointManager(case["checkpoint"])
        trainer.save_checkpoint(manager, wait=True)
        losses.append(trainer.train_step(tokens, mask))
    saved["losses"] = np.array(losses)
    return saved


def mesh_cases(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    run_pool(rank, payload, train_case)


# ---------------------------------------------------------------------- #
# the pipeline
# ---------------------------------------------------------------------- #
def pipeline_case(rank: int, case: Dict[str, Any], payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``pipelined_logits`` (with the aux loss) and the gradient of
    ``pipelined_loss_fn`` on ``case["mesh"]`` over the tokens of
    ``tests/test_pipeline.py``: the logits, the aux, the loss and each
    leaf's full gradient (summed over pp and dp as the trainer sums it)."""
    from langstream_tpu_torch.parallel.pipeline import pipelined_logits, pipelined_loss_fn
    from langstream_tpu_torch.training import trainer as trainer_lib

    config = preset(case["preset"], case.get("layers", 0), case.get("sliding_window", 0))
    params = load_params(payload["params"][case["params"]], config)
    trainer = trainer_lib.Trainer(config, params, mesh_config=mesh_of(case), device="cpu")
    tokens = torch.arange(32, dtype=torch.int32).reshape(4, 8) % config.vocab_size
    mask = torch.ones((4, 8), dtype=torch.bool)
    freqs = model.model_freqs(config)
    logits, aux = pipelined_logits(config, trainer.params, tokens, mask, freqs, trainer.group,
                                   case["microbatches"], with_aux=True)
    loss = pipelined_loss_fn(config, trainer.params, tokens, mask, freqs, trainer.group,
                             case["microbatches"], moe_aux_weight=case.get("aux_weight", 0.0))
    trainer._sync_grads()
    grads = trainer.gathered({name: p.grad for name, p in trainer.params.items()})
    saved = {f"grads/{name}": leaf.numpy() for name, leaf in grads.items()}
    saved.update(logits=logits.numpy(), aux=aux.numpy(), loss=loss.numpy())
    return saved


def pp_cases(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    run_pool(rank, payload, pipeline_case)


# ---------------------------------------------------------------------- #
# sequence parallelism
# ---------------------------------------------------------------------- #
def attention_case(rank: int, case: Dict[str, Any], payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``ring_attention_sharded`` or ``ulysses_attention_sharded`` over an
    sp group of ``case["size"]`` ranks: the output and the gradients of
    ``sum(out * cotangent)`` by q, k and v (every rank's; rank 0's
    saved, with whether the others' equal it)."""
    from langstream_tpu_torch.parallel.ring import ring_attention_sharded
    from langstream_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    group = build_mesh(MeshConfig(sp=case["size"]), "cpu").axis("sp")
    q, k, v, cotangent = (torch.from_numpy(a).requires_grad_(i < 3) for i, a in enumerate(
        attention_inputs(*case["shape"], seed=case["seed"])))
    mask = None
    if case.get("lengths"):
        mask = torch.arange(q.shape[1])[None, :] < torch.tensor(case["lengths"])[:, None]
    if case["kind"] == "ring":
        out = ring_attention_sharded(q, k, v, group, mask=mask, causal=case.get("causal", True))
    else:
        out = ulysses_attention_sharded(q, k, v, group, mask=mask)
    (out * cotangent).sum().backward()
    saved = {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
             "dv": v.grad.numpy()}
    equal = True
    for name, value in saved.items():
        parts = [torch.empty_like(torch.from_numpy(value)) for _ in range(group.size)]
        dist.all_gather(parts, torch.from_numpy(value))
        equal &= all(torch.equal(part, parts[0]) for part in parts)
    saved["equal"] = np.array(equal)
    return saved


def sp_cases(rank: int, world: int, device: str, payload: Dict[str, Any]) -> None:
    run_pool(rank, payload, attention_case)
