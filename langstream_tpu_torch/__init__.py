"""PyTorch/CUDA port of the ``langstream_tpu`` inference stack.

The package mirrors ``langstream_tpu``'s layout (``ops/`` and
``providers/torch_local/`` beside ``ops/`` and ``providers/jax_local/``)
and imports nothing from it: the JAX package is the reference the port is
tested against. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
