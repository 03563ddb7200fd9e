"""PyTorch/CUDA port of the ``langstream_tpu`` inference stack.

The package mirrors ``langstream_tpu``'s layout (``ops/`` and
``providers/torch_local/`` beside ``ops/`` and ``providers/jax_local/``)
and imports nothing from it: the JAX package is the reference the port is
tested against. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

- ``ops``: the attention kernels (``csrc/*.cu``) and their plain
  versions, norms, RoPE, the training loss.
- ``providers.torch_local``: the model (serving calls and the
  differentiable forward), the engine, the loaders, the provider.
- ``training``: the single-card trainer (AdamW) and its checkpoints.
- ``parallel``: the mesh's configuration only (one card).
- ``runtime``, ``serving``, ``cli``, ``api``, ``agents``, ``fleet``:
  recovery and accounting, the OpenAI server, ``serve``, the service
  interfaces, the vector store, the KV handoff's wire schema.
- ``compiler``, ``model``, ``topics``, ``gateway``, ``agents``,
  ``runtime``, ``utils``, ``native``: LangStream apps (``apps run``, or
  one process a role: ``broker``, ``application-setup``,
  ``agent-runner``): the app model, planner and typed configuration
  check, the brokers (``memory``, ``tpulog`` over the native log store,
  ``kafka``), the gateway, every agent type, plugins and assets.
"""
