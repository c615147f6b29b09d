from . import filesystem

__all__ = ["filesystem"]
