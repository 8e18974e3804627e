"""Optimisers the port keeps its own copy of (it does not depend on optax)."""
from . import lbfgs

__all__ = ["lbfgs"]
