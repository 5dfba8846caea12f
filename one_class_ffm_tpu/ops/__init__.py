from .sparse_ops import project, scatter

__all__ = ["project", "scatter"]
