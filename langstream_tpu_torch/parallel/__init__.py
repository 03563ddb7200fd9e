"""Parallelism: the mesh and its tensor-parallel group over torch.distributed
(``mesh.py``), and the ranks of one host (``launch.py``). Serving shards over
tp only (ROADMAP.md, A10 and A11)."""
