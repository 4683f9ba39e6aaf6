"""Host-side utilities of the port (numpy only)."""

from . import init_pool

__all__ = ["init_pool"]
