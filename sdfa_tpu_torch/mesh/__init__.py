from .io import FLAME_COUNTS, read_ply, synthetic_template, write_ply

__all__ = ["FLAME_COUNTS", "read_ply", "synthetic_template", "write_ply"]
