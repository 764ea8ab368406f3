from .scenes import (
    ibl_mesh_scene,
    random_scene,
    stage10_camera,
    stage3_scene,
    stage4_scene,
    stage6_scene,
    stage7_scene,
    stage8_scene,
)

__all__ = [
    "ibl_mesh_scene",
    "random_scene",
    "stage10_camera",
    "stage3_scene",
    "stage4_scene",
    "stage6_scene",
    "stage7_scene",
    "stage8_scene",
]
