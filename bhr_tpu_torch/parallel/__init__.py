"""Rendering over a grid of devices: row bands over 'sp', frames over 'dp'
(PyTorch port of bhr_tpu/parallel/)."""

from .mesh import Mesh, make_mesh, render_animation_sharded, render_frame_sharded, shard_image

__all__ = ["Mesh", "make_mesh", "render_animation_sharded", "render_frame_sharded", "shard_image"]
