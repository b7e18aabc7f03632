"""Host-side procedural map compiler (numpy), the port's own copy of the
PG compiler.

Maps are generated on the host per seed and compiled into a fixed-size
array pack; `core.structs.Scene.from_pack` moves the pack to the device.
"""
from metadrive_ped_torch.mapgen.scene import compile_scene, build_scene_pack

__all__ = ["compile_scene", "build_scene_pack"]
