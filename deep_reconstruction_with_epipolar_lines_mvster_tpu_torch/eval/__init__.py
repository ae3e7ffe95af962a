from .depthgen import generate_depth_maps
from .fusion import (
    FusionConfig,
    backproject_to_world,
    check_geometric_consistency,
    filter_ref_view,
    fused_world_points,
    reproject,
)
from .ply import read_ply, write_ply, write_ply_ascii_colored
from .scene_filter import filter_scene, fuse_view

__all__ = [
    "FusionConfig",
    "backproject_to_world",
    "check_geometric_consistency",
    "filter_ref_view",
    "filter_scene",
    "fuse_view",
    "fused_world_points",
    "generate_depth_maps",
    "read_ply",
    "reproject",
    "write_ply",
    "write_ply_ascii_colored",
]
