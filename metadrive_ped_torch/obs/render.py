"""Host-side rendering: env.render("topdown" / "rgb_array" / "dashboard").

Reference: metadrive/obs/top_down_renderer.py (interactive pygame BEV) and
BaseEnv.render. Here a frame is a pure function of the baked map textures
and the current state: the top-down view composes the map layers with
rotated-box stamps of every object; "rgb_array" is a frame of the ray-cast
camera (ops/camera.py). Each returns a numpy uint8 RGB array of one env,
copied from the device: `render` is not on the stepping path.
"""
import numpy as np

from metadrive_ped_torch.core.structs import tree_map
from metadrive_ped_torch.obs.top_down import BAKE_RES
from metadrive_ped_torch.ops import camera, participants

# palette (top_down_obs_impl.py colours, approximately)
COLOR_BG = np.array([245, 245, 245], np.uint8)
COLOR_ROAD = np.array([128, 128, 128], np.uint8)
COLOR_LINE = np.array([255, 255, 255], np.uint8)
COLOR_EGO = np.array([30, 160, 60], np.uint8)
COLOR_NPC = np.array([40, 80, 220], np.uint8)
COLOR_OBJ = np.array([235, 160, 40], np.uint8)
COLOR_PED = np.array([220, 40, 60], np.uint8)


def _np(t):
    return t.detach().cpu().numpy()


def _stamp_box(img, cx, cy, heading, length, width, color, ppm):
    """Fill a rotated rectangle into img (row 0 = +y top)."""
    H, W, _ = img.shape
    hl, hw = length * ppm / 2, width * ppm / 2
    r = int(np.ceil(np.hypot(hl, hw)))
    x0, x1 = int(cx - r), int(cx + r) + 1
    y0, y1 = int(cy - r), int(cy + r) + 1
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, W), min(y1, H)
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    dx = xs - cx
    dy = cy - ys  # screen y grows downward
    ch, sh = np.cos(heading), np.sin(heading)
    u = dx * ch + dy * sh
    v = -dx * sh + dy * ch
    mask = (np.abs(u) <= hl) & (np.abs(v) <= hw)
    img[y0:y1, x0:x1][mask] = color


def render_topdown(env, env_index=0, size=512, window_m=100.0):
    """RGB top-down frame [size, size, 3] centred on the ego of one env."""
    textures, origins = env._map_textures()
    state = env._state
    sidx = int(state.sidx[env_index])
    tex = _np(textures[sidx])
    origin = _np(origins[sidx])
    ego_pos = _np(state.ego.pos[env_index])

    # crop the static layers around the ego
    half_px = int(window_m / 2 / BAKE_RES)
    cx = int((ego_pos[0] - origin[0]) / BAKE_RES)
    cy = int((ego_pos[1] - origin[1]) / BAKE_RES)
    Ht, Wt = tex.shape[1], tex.shape[2]
    img_t = np.zeros((2 * half_px, 2 * half_px, 3), np.uint8)
    img_t[:] = COLOR_BG
    sy0, sy1 = max(cy - half_px, 0), min(cy + half_px, Ht)
    sx0, sx1 = max(cx - half_px, 0), min(cx + half_px, Wt)
    dy0 = sy0 - (cy - half_px)
    dx0 = sx0 - (cx - half_px)
    road = tex[0, sy0:sy1, sx0:sx1] > 0
    line = tex[1, sy0:sy1, sx0:sx1] > 0
    patch = img_t[dy0:dy0 + road.shape[0], dx0:dx0 + road.shape[1]]
    patch[road] = COLOR_ROAD
    patch[line] = COLOR_LINE
    # flip so +y (world) points up on screen
    img_t = img_t[::-1].copy()

    ppm = 1.0 / BAKE_RES

    def world_to_px(p):
        return (p[0] - ego_pos[0]) * ppm + half_px, half_px - (p[1] - ego_pos[1]) * ppm

    def stamp_all(pos, heading, length, width, active, color):
        for i in range(pos.shape[0]):
            if active[i]:
                x, y = world_to_px(pos[i])
                _stamp_box(img_t, x, y, float(heading[i]), float(length[i]), float(width[i]),
                           color, ppm)

    npc, pack = state.npc, env._pack
    stamp_all(_np(npc.pos[env_index]), _np(npc.heading[env_index]),
              _np(npc.params.length[env_index]), _np(npc.params.width[env_index]),
              _np(npc.active[env_index]), COLOR_NPC)
    stamp_all(pack["obj_pos"][sidx], pack["obj_heading"][sidx], pack["obj_len"][sidx],
              pack["obj_wid"][sidx], pack["obj_valid"][sidx], COLOR_OBJ)
    ped_pos, ped_heading = participants.ped_world_pose(env.scene, state.sidx, state.ped)
    stamp_all(_np(ped_pos[env_index]), _np(ped_heading[env_index]), pack["ped_len"][sidx],
              pack["ped_wid"][sidx], _np(state.ped.active[env_index]), COLOR_PED)
    ex, ey = world_to_px(ego_pos)
    _stamp_box(img_t, ex, ey, float(state.ego.heading[env_index]),
               float(state.ego.params.length[env_index]),
               float(state.ego.params.width[env_index]), COLOR_EGO, ppm)

    # nearest-neighbour resize to the requested size
    if img_t.shape[0] != size:
        idx = (np.arange(size) * img_t.shape[0] / size).astype(int)
        img_t = img_t[idx][:, idx]
    return img_t


def render_rgb_array(env, env_index=0, width=256, height=144):
    """Camera RGB frame [height, width, 3] uint8 of one env."""
    state = env._state
    targets, _ = env._lidar_targets(state)
    cam = env.config["camera"]
    rows = slice(env_index, env_index + 1)
    frame = camera.render(
        env.scene, state.sidx[rows], tree_map(lambda x: x[rows], state.ego),
        [x[rows] for x in targets], env._target_slices,
        env.scene.obj_kind[state.sidx[rows].long()], width=width, height=height,
        fov_deg=cam["fov"], pitch_deg=cam["pitch"], cam_height=cam["height"],
        max_dist=cam["max_dist"], modalities=("rgb",))["rgb"][0]
    return (_np(frame) * 255).astype(np.uint8)


def render_dashboard(env, env_index=0, width=320, height=80):
    """Dashboard panel [height, width, 3] uint8 with steering, throttle,
    brake and speed bars (reference: component/sensors/dashboard.py, a
    GUI-only panel; here an array to place beside env.render frames).
    MAX_SPEED = 120 km/h is the reference's gauge scale (dashboard.py:22)."""
    MAX_SPEED = 120.0
    ego = env._state.ego
    steering = float(ego.steering[env_index])
    throttle = float(ego.throttle[env_index])
    speed = float(ego.speed[env_index]) * 3.6

    img = np.full((height, width, 3), 40, np.uint8)
    rows = [
        ((steering + 1) / 2, np.array([90, 170, 250], np.uint8)),
        (max(throttle, 0.0), np.array([90, 220, 120], np.uint8)),
        (max(-throttle, 0.0), np.array([240, 90, 90], np.uint8)),
        (min(max(speed, 0.0) / MAX_SPEED, 1.0), np.array([250, 210, 90], np.uint8)),
    ]
    bar_h = height // len(rows)
    pad = max(bar_h // 4, 2)
    x0 = width // 8
    for i, (frac, color) in enumerate(rows):
        y0 = i * bar_h + pad
        y1 = (i + 1) * bar_h - pad
        img[y0:y1, x0:width - 4] = 70                      # track
        img[y0:y1, x0:x0 + int((width - 4 - x0) * frac)] = color
        if i == 0:  # centre tick of the signed steering bar
            mid = x0 + (width - 4 - x0) // 2
            img[y0:y1, mid:mid + 2] = 255
    return img
