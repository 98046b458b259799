"""Mesh layout of the port (ray_tpu/parallel/mesh.py's AXIS_ORDER and
MeshSpec, and a device mesh without a process group)."""

from .mesh import AXIS_ORDER, Mesh, MeshSpec, build_mesh, default_devices

__all__ = ["AXIS_ORDER", "Mesh", "MeshSpec", "build_mesh", "default_devices"]
