"""Parallelism: data parallelism over processes (``parallel/mesh.py``).
Import from the submodule."""
