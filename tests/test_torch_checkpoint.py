"""The port's checkpoints, mirroring the single-card tests of
``tests/test_checkpoint.py``, on the CPU:

- a trainer's save restored into a fresh trainer: its tensors the saved
  ones bit for bit, the next loss the original's at rtol 1e-4;
- retention and ``save_interval_steps``: each ``save``'s answer and
  ``all_steps()`` equal to the JAX package's orbax ``CheckpointManager``
  over the same step sequence, and the directories on disk the port's
  steps;
- tensors updated in place after ``save`` returns are not in the
  checkpoint;
- the provider and ``serve --checkpoint`` serve a trainer's save
  directory (``final_norm`` the trainer's), also beside a leftover
  temporary directory, which ``latest_step`` ignores too;
- ``save_model`` → ``load_model`` → ``DecodeEngine`` serves 4 tokens;
- a directory written by the JAX package's orbax manager still raises
  before a tensor is read.
"""

import concurrent.futures
import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.providers.jax_local import model as jax_model
from langstream_tpu.training import checkpoint as jax_checkpoint
from langstream_tpu_torch.cli.main import build_parser, start_server
from langstream_tpu_torch.providers.torch_local import engine, model, weights
from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService
from langstream_tpu_torch.training.checkpoint import (
    CheckpointManager,
    committed_steps,
    load_model,
    save_model,
)
from langstream_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(2)


def _data(config, batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, config.vocab_size, size=(batch, seq)).astype(np.int32)
    return tokens, np.ones((batch, seq), dtype=bool)


def _trainer(seed=0, lr=1e-3):
    config = model.LlamaConfig.tiny()
    return Trainer(config, model.init_params(config, seed=seed),
                   train_config=TrainConfig(learning_rate=lr), device="cpu")


def _snapshot(trainer):
    state = trainer.opt_state
    return ({k: v.detach().clone() for k, v in trainer.params.items()},
            {k: v.clone() for k, v in state["mu"].items()},
            {k: v.clone() for k, v in state["nu"].items()})


def _assert_state(trainer, snapshot):
    params, mu, nu = snapshot
    state = trainer.opt_state
    for name in params:
        assert torch.equal(trainer.params[name].detach(), params[name]), name
        assert torch.equal(state["mu"][name], mu[name]) and torch.equal(state["nu"][name], nu[name])


def test_trainer_save_restore_roundtrip(tmp_path):
    trainer = _trainer()
    tokens, mask = _data(trainer.model_config)
    for _ in range(3):
        trainer.train_step(tokens, mask)
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    trainer.save_checkpoint(manager, wait=True)
    snapshot = _snapshot(trainer)
    loss_next = trainer.train_step(tokens, mask)

    fresh = _trainer(seed=99)
    manager2 = CheckpointManager(str(tmp_path / "ckpt"))
    assert fresh.restore_checkpoint(manager2) == 3
    assert fresh.opt_state["count"] == 3
    _assert_state(fresh, snapshot)
    np.testing.assert_allclose(fresh.train_step(tokens, mask), loss_next, rtol=1e-4)
    manager.close()
    manager2.close()


@pytest.mark.parametrize("max_to_keep,interval,steps", [
    (2, 1, [1, 2, 3, 4]),
    (2, 2, [0, 1, 2, 3, 5, 6, 7, 8, 10]),
    (None, 3, [1, 2, 3, 4, 6, 9, 10]),
    (1, 1, [5, 3, 5, 7]),
], ids=["keep2", "interval2", "keep_all", "not_past_latest"])
def test_retention_and_interval_match_orbax(tmp_path, max_to_keep, interval, steps):
    jparams = {"w": jnp.ones((3,), dtype=jnp.float32)}
    tparams = {"w": torch.ones(3)}
    jax_manager = jax_checkpoint.CheckpointManager(
        str(tmp_path / "jax"), max_to_keep=max_to_keep, save_interval_steps=interval)
    manager = CheckpointManager(str(tmp_path / "port"), max_to_keep=max_to_keep,
                                save_interval_steps=interval)
    for step in steps:
        assert manager.save(step, tparams) == jax_manager.save(step, jparams), step
        assert manager.all_steps() == jax_manager.all_steps(), step
    manager.wait()
    jax_manager.wait()
    assert manager.all_steps() == jax_manager.all_steps()
    assert manager.latest_step() == jax_manager.latest_step()
    assert committed_steps(manager.directory) == manager.all_steps()
    assert CheckpointManager(manager.directory).all_steps() == manager.all_steps()
    manager.close()
    jax_manager.close()


def test_tensors_updated_after_save_are_not_in_the_checkpoint(tmp_path):
    trainer = _trainer()
    tokens, mask = _data(trainer.model_config)
    trainer.train_step(tokens, mask)
    snapshot = _snapshot(trainer)
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    trainer.save_checkpoint(manager)  # no wait: the write runs behind
    trainer.train_step(tokens, mask)  # updates params, mu and nu in place
    with torch.no_grad():
        for leaf in trainer.params.values():
            leaf.add_(1.0)
    manager.wait()
    fresh = _trainer(seed=5)
    assert fresh.restore_checkpoint(CheckpointManager(manager.directory)) == 1
    _assert_state(fresh, snapshot)


@pytest.mark.parametrize("route", ["provider", "leftover_tmp", "serve"])
def test_provider_loads_trainer_checkpoint_dir(tmp_path, route):
    """The provider, and ``serve --checkpoint`` through it, serve a
    trainer's save directory, also beside a save cut off before its
    rename."""
    trainer = _trainer()
    tokens, mask = _data(trainer.model_config)
    trainer.train_step(tokens, mask)
    trainer.train_step(tokens, mask)
    run = tmp_path / "run"
    manager = CheckpointManager(str(run))
    trainer.save_checkpoint(manager, wait=True)
    manager.close()
    if route == "leftover_tmp":
        # a save cut off before its rename: a later step, half written
        os.makedirs(run / "3.tmp-0123abcd" / "params")
        (run / "3.tmp-0123abcd" / "params" / "model.safetensors").write_bytes(b"\xff" * 64)
        assert CheckpointManager(str(run)).latest_step() == 2

    if route == "serve":
        args = build_parser().parse_args([
            "serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
            "--checkpoint", str(run), "--max-slots", "2", "--max-seq-len", "64",
        ])
        svc, api = start_server(args)
    else:
        svc, api = TorchCompletionsService({
            "checkpoint": str(run),
            "tokenizer": {"type": "byte"},
            "engine": {"max-slots": 2, "max-seq-len": 64},
        }, device="cpu"), None
    try:
        assert svc.engine.config == trainer.model_config
        assert torch.equal(svc.engine.params["final_norm"], trainer.params["final_norm"].detach())
        if api is not None:
            request = urllib.request.Request(
                f"http://127.0.0.1:{api.port}/v1/completions",
                data=json.dumps({"prompt": "once upon", "max_tokens": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=120) as reply:
                assert json.loads(reply.read())["usage"]["completion_tokens"] == 4
    finally:
        if api is not None:
            api.stop()
        svc.close()


def test_weights_export_and_engine_load(tmp_path):
    config = model.LlamaConfig.llama3_1b()
    config = model.LlamaConfig.from_dict({
        "preset": "tiny", "rope_scaling": list(config.rope_scaling), "dtype": "bfloat16"})
    params = model.init_params(config, seed=0)
    save_model(str(tmp_path / "model"), config, params)

    loaded_config, loaded_params = load_model(str(tmp_path / "model"), device="cpu")
    assert loaded_config == config  # rope scaling and dtype included
    assert set(loaded_params) == set(params)
    for name, leaf in params.items():
        assert loaded_params[name].dtype == leaf.dtype and torch.equal(loaded_params[name], leaf)

    eng = engine.DecodeEngine(loaded_config, loaded_params, device="cpu", max_slots=2,
                              max_seq_len=64, prefill_buckets=[16])
    eng.start()
    try:
        future = concurrent.futures.Future()
        eng.submit(engine.GenerationRequest(
            prompt_tokens=[1, 2, 3], sampling=engine.SamplingParams(max_new_tokens=4),
            future=future))
        assert len(future.result(timeout=300).tokens) == 4
    finally:
        eng.stop()


def test_jax_orbax_directory_still_raises(tmp_path):
    config = jax_model.LlamaConfig.tiny()
    path = str(tmp_path / "orbax")
    jax_checkpoint.save_model(path, config, jax_model.init_params(config, seed=0))
    with pytest.raises(NotImplementedError, match="orbax.*A11"):
        weights.load_checkpoint(path, device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        TorchCompletionsService({"checkpoint": path}, device="cpu")
    with pytest.raises(FileNotFoundError, match="not a step directory"):
        load_model(path, device="cpu")
