from .io import (FLAME_COUNTS, read_mesh, read_obj, read_ply, synthetic_template, write_obj,
                 write_ply)

__all__ = ["FLAME_COUNTS", "read_mesh", "read_obj", "read_ply", "synthetic_template",
           "write_obj", "write_ply"]
