"""Host C++ of the port, loaded with ctypes: the top-down map rasterizer
(td_raster.cpp). It is built with g++ at first use
(`core.cuda_build.host_library`) and raises when it cannot be built: there
is no numpy fallback.
"""
import ctypes

import numpy as np

from metadrive_ped_torch.core import cuda_build


def _library():
    lib = cuda_build.host_library("td_raster")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32 = ctypes.c_float
    lib.rasterize_polylines.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32, f32, f32,
                                        f32p, i32p, ctypes.c_int, f32p, f32]
    lib.rasterize_polylines.restype = None
    return lib


def rasterize_polylines(grid, origin, res, polylines, widths, value=1.0):
    """Stamp thick polylines (capsule strokes) into ``grid`` [H, W] float32,
    in place, max-combined with ``value``.

    origin: world (x, y) of pixel (0, 0); res: metres per pixel;
    polylines: list of [n_i, 2] world points; widths: the full stroke width
    (m) of each polyline.
    """
    if not polylines:
        return grid
    if grid.dtype != np.float32 or grid.ndim != 2 or not grid.flags["C_CONTIGUOUS"]:
        raise ValueError("grid must be a C-contiguous [H, W] float32 array")
    if len(widths) != len(polylines):
        raise ValueError("one width per polyline")
    pts = np.concatenate([np.asarray(p, np.float32).reshape(-1, 2) for p in polylines])
    starts = np.zeros(len(polylines) + 1, np.int32)
    np.cumsum([len(p) for p in polylines], out=starts[1:])
    widths = np.ascontiguousarray(widths, np.float32)
    H, W = grid.shape
    _library().rasterize_polylines(
        grid, H, W, np.float32(origin[0]), np.float32(origin[1]), np.float32(res),
        np.ascontiguousarray(pts.reshape(-1)), starts, len(polylines), widths, np.float32(value))
    return grid
