"""Dependency-free checkpointing of the port, in the JAX package's format
(`repro.checkpoint`): a checkpoint written by either package restores in
the other."""
from .store import latest_step, load_pytree, restore, save, save_pytree

__all__ = ["save", "restore", "save_pytree", "load_pytree", "latest_step"]
