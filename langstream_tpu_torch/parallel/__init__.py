"""Parallelism: only the mesh's configuration is ported (ROADMAP.md, A10)."""
