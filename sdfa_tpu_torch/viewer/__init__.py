from . import frame, render, video
from .frame import frame_to_mesh, frames_to_meshes, get_solver, set_template_mesh
from .render import render_mesh
from .video import export_mesh_frames, render_video

__all__ = ["export_mesh_frames", "frame", "frame_to_mesh", "frames_to_meshes", "get_solver",
           "render", "render_mesh", "render_video", "set_template_mesh", "video"]
