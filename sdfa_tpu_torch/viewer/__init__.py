from . import frame

__all__ = ["frame"]
