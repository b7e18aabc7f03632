"""Each op of metadrive_ped_torch against its JAX function, on the same
numpy inputs, at atol 1e-5 unless a test says otherwise.

Inputs are either random (numpy seeds) or a realistic mid-episode state:
the port's env runs some steps and its state is handed to the JAX package
as numpy arrays, so both sides evaluate the op on identical data. The
larger JAX references run under jax.jit (one compile instead of one per
primitive)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_tree, np_tree, t, to_np

import chip_smoke
from metadrive_ped_torch import MetaDriveEnv as TorchEnv
from metadrive_ped_torch.constants import SEG_BROKEN_LINE, SEG_WHITE_LINE, SEG_YELLOW_LINE
from metadrive_ped_torch.core.convert import state_from_numpy, state_to_numpy
from metadrive_ped_torch.core.structs import Scene as TorchScene
from metadrive_ped_torch.mapgen import build_scene_pack as torch_build_pack
from metadrive_ped_torch.obs import state_obs as t_obs
from metadrive_ped_torch.ops import collision as t_col
from metadrive_ped_torch.ops import dynamics as t_dyn
from metadrive_ped_torch.ops import gather as t_gather
from metadrive_ped_torch.ops import idm as t_idm
from metadrive_ped_torch.ops import lane_geom as t_lg
from metadrive_ped_torch.ops import localization as t_loc
from metadrive_ped_torch.ops import participants as t_part
from metadrive_ped_torch.ops import ray_segment as t_rs
from metadrive_ped_torch.ops import raycast as t_ray
from metadrive_ped_tpu import MetaDriveEnv as JaxEnv
from metadrive_ped_tpu.core.structs import SimState as JaxSimState
from metadrive_ped_tpu.envs.base import make_vehicle_params as jax_vehicle_params
from metadrive_ped_tpu.obs import state_obs as j_obs
from metadrive_ped_tpu.ops import collision as j_col
from metadrive_ped_tpu.ops import dynamics as j_dyn
from metadrive_ped_tpu.ops import gather as j_gather
from metadrive_ped_tpu.ops import idm as j_idm
from metadrive_ped_tpu.ops import lane_geom as j_lg
from metadrive_ped_tpu.ops import localization as j_loc
from metadrive_ped_tpu.ops import participants as j_part
from metadrive_ped_tpu.ops import raycast as j_ray
from metadrive_ped_tpu.ops.pallas_raycast import ray_segment_fraction_pallas

ATOL = 1e-5

j_localize = jax.jit(j_loc.localize)
j_navi_info = jax.jit(j_loc.navi_info)
j_step_npcs = jax.jit(j_idm.step_npcs, static_argnames="respawn_mode")
j_lane_gaps = jax.jit(j_idm._lane_gaps)
j_surrounding = jax.jit(j_obs.surrounding_vehicles_info, static_argnums=(2, 3))
j_lidar_cloud = jax.jit(j_ray.lidar_cloud, static_argnums=(2, 3), static_argnames="circle_slice")
j_side_cloud = jax.jit(j_ray.side_detector_cloud, static_argnums=(2, 3))
j_ray_obb = jax.jit(j_ray.ray_obb_fraction, static_argnums=(2,))
j_boundary = jax.jit(j_loc.boundary_distances)
j_heading_diff = jax.jit(j_loc.heading_diff_ref)
j_arrive = jax.jit(j_loc.arrive_destination)
j_route_road_at = jax.jit(j_loc.route_road_at)
j_overlap = jax.jit(j_col.obb_obb_overlap)
j_mtv = jax.jit(j_col.obb_obb_mtv)
j_segment_flags = jax.jit(j_col.vehicle_segment_flags, static_argnums=(9,))
j_step_vehicle = jax.jit(j_dyn.step_vehicle, static_argnames=("substeps", "enable_reverse"))


def close(ours, ref, atol=ATOL):
    ref = np.asarray(ref)
    ours = to_np(ours)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def close_dict(ours, ref, atol=ATOL):
    assert set(ours) == set(ref)
    for k in ref:
        close(ours[k], ref[k], atol)


# ---------------------------------------------------------------- worlds
WORLD_CFGS = {
    # the main path: traffic, side and lane-line detectors
    "traffic": dict(num_envs=12, map=3, num_scenarios=4, traffic_density=0.2,
                    vehicle_config=dict(side_detector=dict(num_lasers=16),
                                        lane_line_detector=dict(num_lasers=8),
                                        lidar=dict(num_lasers=36, num_others=3))),
    # cylinder bodies (cones, warnings, walkers) and respawning traffic
    "cylinders": dict(num_envs=8, map=4, num_scenarios=3, traffic_density=0.1,
                      accident_prob=0.8, pedestrian_density=0.5, traffic_mode="respawn",
                      vehicle_config=dict(lidar=dict(num_lasers=36))),
}


class World:
    """The port's env stepped into mid-episode with every NPC released, and
    the JAX package's scene and state built from the same pack and that
    state (the port's rollout is cheap on the CPU; the JAX env is only
    constructed, never compiled)."""

    def __init__(self, cfg, steps=15, seed=0):
        self.jenv = JaxEnv(cfg)
        self.tenv = TorchEnv(cfg, device="cpu")
        self.tenv.reset(seed=seed)
        rng = np.random.RandomState(seed)
        E = self.tenv.num_envs
        for _ in range(steps):
            a = np.clip(rng.normal([0.0, 0.8], [0.2, 0.3], (E, 2)), -1, 1).astype(np.float32)
            self.tenv.step(a)
        tree = state_to_numpy(self.tenv._state)
        tree["npc"]["released"] = np.ones_like(tree["npc"]["released"])
        self.tstate = state_from_numpy(tree, "cpu")
        self.jstate = jax_tree(JaxSimState, tree)
        self.jscene, self.tscene = self.jenv.scene, self.tenv.scene


_WORLDS = {}


def get_world(name):
    if name not in _WORLDS:
        _WORLDS[name] = World(WORLD_CFGS[name])
    return _WORLDS[name]


@pytest.fixture(scope="module", params=sorted(WORLD_CFGS))
def world(request):
    return get_world(request.param)


@pytest.fixture(scope="module")
def traffic_world():
    return get_world("traffic")


@pytest.fixture(scope="module")
def cylinder_world():
    return get_world("cylinders")


# ------------------------------------------------------------ gather.py
@pytest.mark.parametrize("S,K", [(3, 50), (2, 3000)])  # flat one-hot and per-env JAX paths
def test_table_lookup(S, K):
    rng = np.random.RandomState(S)
    table = rng.normal(size=(S, K, 4)).astype(np.float32)
    sidx = rng.randint(0, S, 40).astype(np.int32)
    idx = rng.randint(0, K, (40, 3)).astype(np.int32)
    close(t_gather.table_lookup(t(table), t(sidx), t(idx)),
          j_gather.table_lookup(jnp.asarray(table), jnp.asarray(sidx), jnp.asarray(idx)))
    close(t_gather.table_lookup(t(table), t(sidx), t(idx[:, 0])),
          j_gather.table_lookup(jnp.asarray(table), jnp.asarray(sidx), jnp.asarray(idx[:, 0])))


@pytest.mark.parametrize("S,K", [(3, 50), (2, 3000)])
def test_table_lookup_missing_id_is_zero_row(S, K):
    """A missing neighbour lane is -1 (ops/idm.py:222-226): the row is zero
    (gather.py:21-22), not torch's wrap-around to the last row.

    The JAX package's flat one-hot path (S*K <= 4096) looks up row
    sidx*K + id, so there an id outside [0, K) reads a neighbouring
    scenario's row unless it lands below row 0 (ROADMAP.md queue 3); the
    comparison with JAX covers the ids where its two paths agree."""
    rng = np.random.RandomState(0)
    table = rng.normal(size=(S, K, 4)).astype(np.float32)
    idx = np.array([-1, 0, -7, K - 1, K, K + 3], np.int32)
    for s in range(S):
        sidx = np.full(idx.shape, s, np.int32)
        ours = to_np(t_gather.table_lookup(t(table), t(sidx), t(idx)))
        np.testing.assert_array_equal(ours[[0, 2, 4, 5]], 0.0)
        np.testing.assert_array_equal(ours[[1, 3]], table[s, [0, K - 1]])
        ref = np.asarray(j_gather.table_lookup(jnp.asarray(table), jnp.asarray(sidx), jnp.asarray(idx)))
        agree = [1, 3] + ([0, 2] if s == 0 else []) if S * K <= 4096 else list(range(len(idx)))
        np.testing.assert_array_equal(ours[agree], ref[agree])


def test_onehot_pick_and_vector_lookup_out_of_range():
    rng = np.random.RandomState(1)
    vals = rng.normal(size=(6, 5)).astype(np.float32)
    ivals = rng.randint(-9, 9, (6, 5)).astype(np.int32)
    idx = np.array([0, 4, -1, 5, 2, 99], np.int32)
    close(t_gather.onehot_pick(t(vals), t(idx)), j_gather.onehot_pick(jnp.asarray(vals), jnp.asarray(idx)))
    close(t_gather.onehot_pick(t(ivals), t(idx)), j_gather.onehot_pick(jnp.asarray(ivals), jnp.asarray(idx)))
    vec = rng.normal(size=(5, 7)).astype(np.float32)
    close(t_gather.vector_lookup(t(vec), t(idx)), j_gather.vector_lookup(jnp.asarray(vec), jnp.asarray(idx)))
    close(t_gather.vector_lookup(t(vec[:, 0]), t(idx)),
          j_gather.vector_lookup(jnp.asarray(vec[:, 0]), jnp.asarray(idx)))
    assert to_np(t_gather.onehot_pick(t(vals), t(idx)))[2] == 0.0


def test_nearest_k_first_index_on_ties():
    dist = np.array([[3.0, 1.0, 1.0, 2.0, np.inf],
                     [5.0, 5.0, 5.0, 5.0, 5.0],
                     [np.inf] * 5,
                     [2.0, np.inf, 2.0, 1.0, 1.0]], np.float32)
    sel, found = t_gather.nearest_k_onehot(t(dist), 3)
    jsel, jfound = j_gather.nearest_k_onehot(jnp.asarray(dist), 3)
    close(sel, jsel)
    close(found, jfound)
    np.testing.assert_array_equal(to_np(sel)[0].argmax(-1), [1, 2, 3])
    np.testing.assert_array_equal(to_np(sel)[1].argmax(-1), [0, 1, 2])


# ---------------------------------------------------------- lane_geom.py
def test_lane_geometry_on_compiled_lanes(world):
    js, ts = world.jscene, world.tscene
    S, L = np.asarray(js.lane_kind).shape
    rng = np.random.RandomState(2)
    n = 64
    sidx = rng.randint(0, S, n).astype(np.int32)
    lid = rng.randint(0, L, n).astype(np.int32)
    g_t, g_j = t_lg.gather_lane(ts, t(sidx), t(lid)), j_lg.gather_lane(js, jnp.asarray(sidx), jnp.asarray(lid))
    close_dict(g_t, g_j)
    length = np.asarray(g_j["length"])
    long = (rng.uniform(-0.2, 1.2, n) * length).astype(np.float32)
    lat = rng.uniform(-4, 4, n).astype(np.float32)
    close(t_lg.position(g_t, t(long), t(lat)), j_lg.position(g_j, jnp.asarray(long), jnp.asarray(lat)))
    close(t_lg.heading_theta_at(g_t, t(long)), j_lg.heading_theta_at(g_j, jnp.asarray(long)))
    pos = np.asarray(j_lg.position(g_j, jnp.asarray(long), jnp.asarray(lat)))
    lc_t = t_lg.local_coordinates(g_t, t(pos))
    lc_j = j_lg.local_coordinates(g_j, jnp.asarray(pos))
    # meters on maps a few hundred metres across: a float32 ulp there is
    # 1.5e-5, so one extra rounding is allowed beside atol
    for a, b in zip(lc_t, lc_j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6, atol=ATOL)
    close(t_lg.on_lane(g_t, t(long), t(lat)), j_lg.on_lane(g_j, jnp.asarray(long), jnp.asarray(lat)))
    close(t_lg.l1_distance(g_t, t(long), t(lat)), j_lg.l1_distance(g_j, jnp.asarray(long), jnp.asarray(lat)))


def test_gather_with_neighbors_and_roads(world):
    js, ts = world.jscene, world.tscene
    S, L = np.asarray(js.lane_kind).shape
    R = np.asarray(js.road_lane0).shape[1]
    rng = np.random.RandomState(3)
    sidx = rng.randint(0, S, 10).astype(np.int32)
    lid = rng.randint(0, L, (10, 4)).astype(np.int32)
    for a, b in zip(t_lg.gather_lane_with_neighbors(ts, t(sidx)[:, None], t(lid)),
                    j_lg.gather_lane_with_neighbors(js, jnp.asarray(sidx)[:, None], jnp.asarray(lid))):
        close_dict(a, b)
    rid = rng.randint(0, R, 10).astype(np.int32)
    close_dict(t_lg.gather_road(ts, t(sidx), t(rid)), j_lg.gather_road(js, jnp.asarray(sidx), jnp.asarray(rid)))
    close_dict(t_lg.gather_all_lanes(ts, t(sidx)), j_lg.gather_all_lanes(js, jnp.asarray(sidx)))


# ----------------------------------------------------------- dynamics.py
# steering x throttle grid incl. braking through zero and reversing
# (the cases of tests/test_dynamics.py)
DYN_GRID = [(s, th, v0) for s in (-1.0, -0.3, 0.0, 0.6) for th in (1.0, 0.4, 0.0, -0.5, -1.0)
            for v0 in (0.0, 0.3, 8.0, -2.0)]


@pytest.mark.parametrize("enable_reverse", [False, True])
def test_step_vehicle(enable_reverse):
    n = len(DYN_GRID)
    s, th, v0 = (np.array(c, np.float32) for c in zip(*DYN_GRID))
    cls = np.arange(n, dtype=np.int32) % 5
    jp = jax_vehicle_params(cls)
    tp = t_dyn_params(cls)
    rng = np.random.RandomState(4)
    pos = rng.normal(size=(n, 2)).astype(np.float32)
    heading = rng.uniform(-3, 3, n).astype(np.float32)
    beta = np.zeros(n, np.float32)
    j = (jnp.asarray(pos), jnp.asarray(heading), jnp.asarray(v0), jnp.asarray(beta))
    o = (t(pos), t(heading), t(v0), t(beta))
    for _ in range(40):  # 200 substeps
        j = j_step_vehicle(*j, jnp.asarray(s), jnp.asarray(th), jp, substeps=5,
                               enable_reverse=enable_reverse)
        o = t_dyn.step_vehicle(*o, t(s), t(th), tp, substeps=5, enable_reverse=enable_reverse)
        for a, b in zip(o, j):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5, atol=ATOL)
    speed = to_np(o[2])
    if enable_reverse:
        assert (speed[(th < 0)] < 0).any()          # reverses
    else:
        assert (speed[(th < 0) & (v0 > 0)] == 0).all()  # brakes to a stop, no further


def t_dyn_params(cls):
    from metadrive_ped_torch.envs.base import _TBL_MAT, make_vehicle_params
    return make_vehicle_params(t(_TBL_MAT), t(cls))


def test_vehicle_params_table():
    cls = np.array([0, 1, 2, 3, 4, 4, -1, 5], np.int32)
    close_dict(t_dyn_params(cls).__dict__, jax_vehicle_params(cls).__dict__)


# ------------------------------------------------------------ raycast.py
def _random_rays(seed, E, R):
    rng = np.random.RandomState(seed)
    origin = rng.uniform(-5, 5, (E, 2)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, E).astype(np.float32)
    return rng, origin, heading, np.asarray(j_ray._fan_dirs(jnp.asarray(heading), R))


def test_fan_dirs():
    heading = np.random.RandomState(5).uniform(-10, 10, 9).astype(np.float32)
    for R, off in ((240, 0.0), (160, np.pi / 2), (12, np.pi / 2)):
        for a, b in zip(t_ray._fan_dirs(t(heading), R, off), j_ray._fan_dirs(jnp.asarray(heading), R, off)):
            close(a, b)


def test_ray_obb_fraction():
    rng, origin, _, dirs = _random_rays(6, 7, 60)
    N = 9
    c = rng.uniform(-30, 30, (7, N, 2)).astype(np.float32)
    h = rng.uniform(-3, 3, (7, N)).astype(np.float32)
    ln = rng.uniform(1, 6, (7, N)).astype(np.float32)
    wd = rng.uniform(0.5, 3, (7, N)).astype(np.float32)
    act = rng.rand(7, N) > 0.2
    close(t_ray.ray_obb_fraction(t(origin), (t(dirs[0]), t(dirs[1])), 50.0, t(c), t(h), t(ln), t(wd), t(act)),
          j_ray_obb(jnp.asarray(origin), None, 50.0, jnp.asarray(c), jnp.asarray(h),
                                 jnp.asarray(ln), jnp.asarray(wd), jnp.asarray(act),
                                 dirs=(jnp.asarray(dirs[0]), jnp.asarray(dirs[1]))))


def test_ray_circle_fraction():
    """Circles within 15 m: the discriminant b^2 - (|rel|^2 - r^2) loses
    digits to cancellation at 50 m range in float32 (ROADMAP.md queue 3),
    so the op is held to 1e-5 where it is well conditioned."""
    rng, origin, _, dirs = _random_rays(7, 7, 60)
    N = 6
    c = (origin[:, None, :] + rng.uniform(-15, 15, (7, N, 2))).astype(np.float32)
    r = rng.uniform(0.2, 1.5, (7, N)).astype(np.float32)
    act = rng.rand(7, N) > 0.2
    close(t_ray.ray_circle_fraction(t(origin), (t(dirs[0]), t(dirs[1])), 50.0, t(c), t(r), t(act)),
          j_ray.ray_circle_fraction(jnp.asarray(origin), None, 50.0, jnp.asarray(c), jnp.asarray(r),
                                    jnp.asarray(act), dirs=(jnp.asarray(dirs[0]), jnp.asarray(dirs[1]))))


def test_lidar_cloud_with_cylinders(cylinder_world):
    w = cylinder_world
    (jt, jk), (tt, tr) = w.jenv._lidar_targets(w.jstate), w.tenv._lidar_targets(w.tstate)
    assert jk["radius"] is not None and tr is not None
    close(tr, jk["radius"])
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6, atol=ATOL)
    ego_j, ego_t = w.jstate.ego, w.tstate.ego
    ours = t_ray.lidar_cloud(ego_t.pos, ego_t.heading, 36, 50.0, *tt, radius=tr,
                             circle_slice=jk["circle_slice"])
    ref = j_lidar_cloud(ego_j.pos, ego_j.heading, 36, 50.0, *jt, radius=jk["radius"],
                        circle_slice=jk["circle_slice"])
    close(ours, ref)


def _segment_case(seed, E, R, B):
    rng = np.random.RandomState(seed)
    origin = rng.uniform(-5, 5, (E, 2)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, (E, R)).astype(np.float32)
    p0 = rng.uniform(-30, 30, (E, B, 2)).astype(np.float32)
    p1 = (p0 + rng.uniform(-10, 10, (E, B, 2))).astype(np.float32)
    valid = rng.rand(E, B) > 0.2
    return origin, angles, p0, p1, valid


def test_ray_segment_fraction_against_xla_and_pallas():
    """The plain version the CUDA kernel is held against matches both the
    XLA op and the Pallas kernel (interpret mode, as
    tests/test_lane_geom.py:75-93 runs it), with E=11 and B=53 so that
    neither lands on a tile."""
    origin, angles, p0, p1, valid = _segment_case(7, 11, 12, 53)
    ours = t_rs.ray_segment_fraction(t(origin), t(angles), 50.0, t(p0), t(p1), t(valid))
    j = [jnp.asarray(a) for a in (origin, angles, p0, p1, valid)]
    close(ours, j_ray.ray_segment_fraction(j[0], j[1], 50.0, j[2], j[3], j[4]))
    close(ours, ray_segment_fraction_pallas(j[0], j[1], 50.0, j[2], j[3], j[4]))
    assert (to_np(ours) < 1.0).any() and (to_np(ours) == 1.0).any()


def test_ray_segment_sweep_on_cpu_is_the_plain_version():
    """The detector-cloud entry on CPU tensors is its plain version and
    counts no launch."""
    args = chip_smoke.to_device(chip_smoke.random_line_case(5, 3, 9, 7, 4, seed=8), "cpu")
    before = t_rs.launches
    ours, plain = t_rs.detector_clouds(*args), t_rs.detector_clouds_plain(*args)
    for a, b in zip(ours, plain):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert t_rs.launches == before


def _jax_line_masks(jsc, sidx_j):
    typ, valid = jsc.seg_type[sidx_j], jsc.seg_valid[sidx_j]
    cont = ((typ == SEG_YELLOW_LINE) | (typ == SEG_WHITE_LINE)) & valid
    return cont, cont | ((typ == SEG_BROKEN_LINE) & valid)


def _detector_clouds_vs_jax(w, Rs, Rl):
    """The port's detector clouds over its line table against JAX's
    side_detector_cloud over the per-env segments and masks."""
    jsc, tsc = w.jscene, w.tscene
    sidx_j = w.jstate.sidx
    jp0, jp1 = jsc.seg_points(sidx_j)
    cont, anyline = _jax_line_masks(jsc, sidx_j)
    table, counts = t_rs.build_line_table(tsc, include_broken=True)
    ours = t_ray.detector_clouds(w.tstate.ego.pos, w.tstate.ego.heading, w.tstate.sidx,
                                 (Rs, 50.0), (Rl, 20.0), table, counts)
    for cloud, R, dist, mask in zip(ours, (Rs, Rl), (50.0, 20.0), (cont, anyline)):
        assert tuple(cloud.shape) == (w.tstate.sidx.shape[0], R)
        if R:
            close(cloud, j_side_cloud(w.jstate.ego.pos, w.jstate.ego.heading, R, dist, jp0, jp1, mask))
            assert (to_np(cloud) < 1.0).any()
    return ours


def test_side_detector_cloud(traffic_world):
    """Both detector clouds of the main path's wiring (side 16 rays at 50 m
    over the continuous lines, lane-line 8 at 20 m over all lines)."""
    tp0, _ = traffic_world.tscene.seg_points(traffic_world.tstate.sidx)
    close(tp0, traffic_world.jscene.seg_points(traffic_world.jstate.sidx)[0])
    _detector_clouds_vs_jax(traffic_world, 16, 8)


@pytest.mark.parametrize("Rs,Rl", [(0, 8), (16, 0)])
def test_detector_clouds_one_detector_off(traffic_world, Rs, Rl):
    _detector_clouds_vs_jax(traffic_world, Rs, Rl)


def _line_table_scene(name):
    if name == "map3_broken_lines":
        cfg = dict(map_config=dict(config=3, lane_width=3.5, lane_num=3, exit_length=50.0),
                   traffic_density=0.05, include_broken_line_segs=True)
        return TorchScene.from_pack(torch_build_pack([5, 6], cfg), "cpu")
    return get_world(name).tscene


@pytest.mark.parametrize("name,include_broken", [("traffic", True), ("traffic", False),
                                                 ("cylinders", True), ("map3_broken_lines", True)])
def test_build_line_table(name, include_broken):
    """The table's rows are bit for bit the (a, s) of `seg_points` of the
    valid continuous lines, then the valid broken lines, in pack order;
    counts are (n_cont, n_any) and the padding is zero."""
    scene = _line_table_scene(name)
    table, counts = t_rs.build_line_table(scene, include_broken)
    S = scene.num_scenarios
    p0, p1 = (to_np(a) for a in scene.seg_points(torch.arange(S)))
    typ, valid = to_np(scene.seg_type), to_np(scene.seg_valid)
    table, counts = to_np(table), to_np(counts)
    assert table.dtype == np.float32 and counts.dtype == np.int32
    n_any_all = []
    for si in range(S):
        cont = np.flatnonzero(valid[si] & np.isin(typ[si], (SEG_YELLOW_LINE, SEG_WHITE_LINE)))
        broken = np.flatnonzero(valid[si] & (typ[si] == SEG_BROKEN_LINE)) if include_broken \
            else np.zeros(0, np.int64)
        idx = np.concatenate([cont, broken])
        expect = np.concatenate([p0[si, idx], p1[si, idx] - p0[si, idx]], axis=-1)
        np.testing.assert_array_equal(counts[si], [len(cont), len(idx)])
        np.testing.assert_array_equal(table[si, :len(idx)], expect)
        assert (table[si, len(idx):] == 0).all()
        n_any_all.append(len(idx))
    assert table.shape == (S, max(1, max(n_any_all)), 4)
    assert (counts[:, 0] > 0).all()
    if name != "cylinders" and include_broken:
        assert (counts[:, 1] > counts[:, 0]).any()      # broken lines are in the table


def _jax_table_clouds(args):
    """JAX's ray_segment_fraction over per-env p0 = a, p1 = a + s of a line
    table case (exact where the case's s = fl(p1 - p0))."""
    origin, sidx, side, lane, side_dist, lane_dist, table, counts = args
    rows, c = table[sidx], counts[sidx]
    j = np.arange(table.shape[1])[None, :]
    p0 = rows[..., :2]
    p1 = (p0 + rows[..., 2:]).astype(np.float32)
    np.testing.assert_array_equal(p1 - p0, rows[..., 2:])
    out = []
    for (dx, dy), dist, mask in ((side, side_dist, j < c[:, :1]), (lane, lane_dist, j < c[:, 1:])):
        out.append(np.asarray(j_ray.ray_segment_fraction(
            jnp.asarray(origin), None, dist, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask),
            dirs=(jnp.asarray(dx), jnp.asarray(dy)))) if dx.shape[1] else np.zeros(dx.shape, np.float32))
    return out


LINE_CASES_CPU = {
    # the card's cases at CPU size: rows over one shared-memory tile (512),
    # n_cont = 0, Rs = 0, Rl = 0, Rl over one warp's 16, and exact
    # boundary geometry at full size. XLA on the CPU flushes subnormals to
    # zero, so the envs with a subnormal offset are held against the plain
    # version on the card and by test_kernel_cull_is_exact, not against JAX.
    "ragged": lambda: chip_smoke.random_line_case(9, 3, 600, 20, 5, seed=11),
    "n_cont_0_n_any_1": lambda: chip_smoke.random_line_case(256, 64, 1, 24, 12, seed=12,
                                                            counts=[[0, 1]] * 64),
    "Rs_0": lambda: chip_smoke.random_line_case(6, 2, 70, 0, 12, seed=13),
    "Rl_0": lambda: chip_smoke.random_line_case(6, 2, 70, 24, 0, seed=14),
    "Rl_40": lambda: chip_smoke.random_line_case(6, 2, 70, 24, 40, seed=15),
    "adversarial": lambda: chip_smoke.adversarial_line_case(subnormal=False),
}


@pytest.mark.parametrize("case", sorted(LINE_CASES_CPU))
def test_detector_clouds_cases_against_jax(case):
    """The plain detector clouds over a line table match JAX's
    ray_segment_fraction over the same segments, hit for hit."""
    args = LINE_CASES_CPU[case]()
    ours = t_rs.detector_clouds(*chip_smoke.to_device(args, "cpu"))
    for cloud, ref in zip(ours, _jax_table_clouds(args)):
        close(cloud, ref)
        np.testing.assert_array_equal(to_np(cloud) < 1, ref < 1)


def _kernel_pair_model(dx, dy, ax, ay, sx, sy, ox, oy):
    """numpy float32 model of csrc/ray_segment.cu::pair, each operation
    rounded as the kernel rounds it: (kept by the cull, the kernel's hit,
    the plain version's hit)."""
    f = np.float32
    with np.errstate(all="ignore"):
        rel_x, rel_y = ax - ox, ay - oy
        nt = rel_x * sy - rel_y * sx
        denom = dx * sy - dy * sx
        g = np.where(np.abs(denom) < f(1e-9), f(1e-9), denom)
        nu = rel_x * dy - rel_y * dx
        m = np.where(np.signbit(g), f(-2.0 ** 126), f(2.0 ** 126))
        ag, num = np.maximum(np.abs(denom), f(1e-9)), nu * m
        assert (ag == np.abs(g)).all()
        kept = (nt * m > -ag) & (num > -ag) & (np.abs(nu) <= ag * f(1 + 2.0 ** -22))
        t, u = nt / g, nu / g
        plain = (t >= 0) & (u >= 0) & (u <= 1)
        sure_u = (num >= 0) & (np.abs(nu) <= ag * f(1 - 2.0 ** -22))
        kernel = kept & np.where(sure_u, t >= 0, plain)
    return kept, kernel, plain


def _pairs_of(args):
    """Every (ray, valid row) pair of a line-table case, flattened."""
    origin, sidx, side, lane, _, _, table, counts = args
    out = []
    for (dx, dy), col in ((side, 0), (lane, 1)):
        rows, n = table[sidx], counts[sidx, col]
        valid = np.arange(table.shape[1])[None, :] < n[:, None]           # [E,B]
        e, b = np.nonzero(valid)
        R = dx.shape[1]
        e, b, r = np.repeat(e, R), np.repeat(b, R), np.tile(np.arange(R), len(e))
        out.append((dx[e, r], dy[e, r], *rows[e, b].T, origin[e, 0], origin[e, 1]))
    return [np.concatenate(parts) for parts in zip(*out)]


def _near_boundary_pairs(n, seed):
    """Rays aimed at segment ends (u within an ulp of 0 or 1), origins a
    subnormal step from a segment start (t, u near +-0) and rays nearly
    parallel to the segment (|d x s| near the 1e-9 guard)."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    o = f32(rng.uniform(-20, 20, (n, 2)))
    a = f32(o + rng.uniform(-30, 30, (n, 2)))
    s = f32(rng.uniform(-10, 10, (n, 2)))
    target = np.where(rng.rand(n, 1) < 0.5, a, f32(a + s))
    d = f32(target - o)
    d = f32(d / np.linalg.norm(d, axis=1, keepdims=True))
    pairs = [(d[:, 0], d[:, 1], a[:, 0], a[:, 1], s[:, 0], s[:, 1], o[:, 0], o[:, 1])]
    tiny = f32(rng.randint(-3, 4, (n, 2)) * np.float32(1e-45))
    pairs.append((d[:, 0], d[:, 1], tiny[:, 0], tiny[:, 1], s[:, 0], s[:, 1], 0 * o[:, 0], 0 * o[:, 1]))
    par = f32(d * rng.choice([-3.0, 1.0, 4.0], (n, 1))
              + f32(rng.choice([-1, 1], (n, 1)) * rng.choice([3e-10, 1e-9, 2e-9], (n, 1)))
              * f32(np.stack([-d[:, 1], d[:, 0]], 1)))
    pairs.append((d[:, 0], d[:, 1], a[:, 0], a[:, 1], par[:, 0], par[:, 1], o[:, 0], o[:, 1]))
    return [np.concatenate(parts).astype(np.float32) for parts in zip(*pairs)]


@pytest.mark.parametrize("source", ["random", "near_boundary", "adversarial", "main_path_like"])
def test_kernel_cull_is_exact(source):
    """The kernel's cull and hit test, modelled in numpy float32: a culled
    pair is always a miss of the plain version, and the kernel's hit is the
    plain version's hit on every pair, ties at u = 0, u = 1, t = 0 and the
    1e-9 guard included. On random geometry the cull removes most pairs."""
    if source == "near_boundary":
        pairs = _near_boundary_pairs(20000, seed=21)
    elif source == "adversarial":
        pairs = _pairs_of(chip_smoke.adversarial_line_case())
    else:
        pairs = _pairs_of(chip_smoke.random_line_case(
            64, 4, 300, 160, 12, seed=22 if source == "random" else 23,
            counts=None if source == "random" else [[100, 300]] * 4))
    kept, kernel, plain = _kernel_pair_model(*pairs)
    assert not (plain & ~kept).any()
    np.testing.assert_array_equal(kernel, plain)
    assert plain.any()
    if source in ("random", "main_path_like"):
        assert kept.mean() < 0.25


@pytest.mark.parametrize("distance", [50.0, 1.0, 3.0, 7.3, 1e-3, 1e30, 3e-38])
def test_npc_lidar_min_of_t_then_one_scaling_is_the_plain_chains(distance):
    """csrc/npc_lidar.cu keeps the least t of the boxes a ray hits and
    scales it once: clamp(fl(min t * m), 0, 1) with m = fl(1 / distance), 1
    where nothing is hit. The plain chain takes the least of
    where(hit, clamp(fl(t * m), 0, 1), 1). Every hit has t >= 0 and
    t -> clamp(fl(t * m), 0, 1) is monotone, so the two agree: here on
    every kind of t >= 0 (random float32 bit patterns, 0 and +inf
    included), rows with no hit among them."""
    g = torch.Generator().manual_seed(18)
    t = torch.randint(0, 0x7F800001, (4096, 14), generator=g, dtype=torch.int32)
    t = t.view(torch.float32)
    t[:, 0], t[:, 1] = 0.0, torch.inf
    hit = torch.rand(4096, 14, generator=g) < 0.5
    hit[:64] = False
    m = torch.tensor(1.0 / distance, dtype=torch.float32)
    plain = torch.where(hit, torch.clamp(t * m, 0.0, 1.0), 1.0).amin(-1)
    once = torch.clamp(torch.where(hit, t, torch.inf).amin(-1) * m, 0.0, 1.0)
    assert torch.equal(once, plain)
    assert bool((plain[:64] == 1).all()) and bool((plain < 1).any())


def test_npc_lidar_plain_on_the_edge_geometry():
    """The plain version on chip_smoke.edge_npc_case, the geometry the card
    tests hold the kernel to: a ray along a box's edge, an origin inside a
    box, a corner graze at t = 0, a box of zero length, every body
    inactive, NaN and infinite inputs."""
    from metadrive_ped_torch.ops import npc_lidar as t_nl
    plain = t_nl.npc_lidar(*chip_smoke.npc_to_device(chip_smoke.edge_npc_case(), "cpu"))
    assert plain.shape == (6, 3, 16) and not bool(torch.isnan(plain).any())
    assert abs(float(plain[0, 0, 0]) - 8 / 50) < 1e-7   # along the box's edge
    assert plain[1, 0].lt(1).all()                    # inside: every ray exits
    assert plain[2, 0, 0] == 0.0                      # the corner graze, t = 0
    assert abs(float(plain[3, 0, 0]) - 5 / 50) < 1e-7   # the zero-length box
    assert bool((plain[4] == 1).all()) and bool((plain[5, 1:] == 1).all())
    assert bool((plain[5, 0] < 1).any())              # the infinite ego


# ---------------------------------------------------------- collision.py
def _boxes(seed, n, m):
    rng = np.random.RandomState(seed)
    c1 = rng.uniform(-3, 3, (n, 1, 2)).astype(np.float32)
    h1 = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    c2 = rng.uniform(-6, 6, (n, m, 2)).astype(np.float32)
    h2 = rng.uniform(-3, 3, (n, m)).astype(np.float32)
    dims = [rng.uniform(1, 5, s).astype(np.float32) for s in ((n, 1), (n, 1), (n, m), (n, m))]
    return rng, (c1, h1, dims[0], dims[1], c2, h2, dims[2], dims[3])


def test_obb_overlaps_and_mtv():
    rng, args = _boxes(9, 40, 5)
    j = [jnp.asarray(a) for a in args]
    o = [t(a) for a in args]
    close(t_col.obb_obb_overlap(*o), j_overlap(*j))
    for a, b in zip(t_col.obb_obb_mtv(*o), j_mtv(*j)):
        close(a, b)
    r = rng.uniform(0.2, 1.0, (40, 5)).astype(np.float32)
    close(t_col.obb_circle_overlap(*o[:4], o[4], t(r)), j_col.obb_circle_overlap(*j[:4], j[4], jnp.asarray(r)))


def test_obb_mtv_first_axis_on_ties():
    """Equal penetration on several axes: the first tied axis wins
    (collision.py:133-136)."""
    c1 = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]], np.float32)
    c2 = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 0.0]], np.float32)
    h = np.zeros(3, np.float32)
    size = np.full(3, 2.0, np.float32)
    args = (c1, h, size, size, c2, h, size, size)
    (d, n), (jd, jn) = t_col.obb_obb_mtv(*[t(a) for a in args]), j_col.obb_obb_mtv(*[jnp.asarray(a) for a in args])
    close(d, jd)
    close(n, jn)
    np.testing.assert_array_equal(to_np(n)[0], [-1.0, 0.0])   # x axis of box 1 before its y axis


def test_contact_speed_scale():
    rng = np.random.RandomState(10)
    speed = rng.uniform(-5, 15, 30).astype(np.float32)
    move = rng.uniform(-3, 3, 30).astype(np.float32)
    normal = rng.normal(size=(30, 4, 2)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    contact = rng.rand(30, 4) > 0.5
    close(t_col.contact_speed_scale(t(speed), t(move), t(normal), t(contact)),
          j_col.contact_speed_scale(jnp.asarray(speed), jnp.asarray(move), jnp.asarray(normal),
                                    jnp.asarray(contact)))


def test_vehicle_segment_flags(traffic_world):
    w = traffic_world
    jsc, tsc, js, ts = w.jscene, w.tscene, w.jstate, w.tstate
    s = ts.sidx.long()
    # the egos, and the egos nudged sideways onto the lines
    for shift in (0.0, 1.6, -2.4):
        jpos = js.ego.pos + shift * jnp.stack([-jnp.sin(js.ego.heading), jnp.cos(js.ego.heading)], -1)
        tpos = t(np.asarray(jpos))
        ours = t_col.vehicle_segment_flags(
            tpos, ts.ego.heading, ts.ego.params.length, ts.ego.params.width, *tsc.seg_points(ts.sidx),
            tsc.seg_type[s], tsc.seg_halfwidth[s], tsc.seg_valid[s], (0, 1, 2))
        ref = j_segment_flags(
            jpos, js.ego.heading, js.ego.params.length, js.ego.params.width, *jsc.seg_points(js.sidx),
            jsc.seg_type[js.sidx], jsc.seg_halfwidth[js.sidx], jsc.seg_valid[js.sidx], (0, 1, 2))
        close_dict(ours, ref)


# ------------------------------------------------------- localization.py
def _probe_positions(w, seed):
    """The egos' positions plus random offsets around them."""
    rng = np.random.RandomState(seed)
    pos = np.asarray(w.jstate.ego.pos)
    return (pos + rng.normal(0, 3, pos.shape)).astype(np.float32)


def test_localize_and_navigation(world):
    w = world
    js, ts, jsc, tsc = w.jstate, w.tstate, w.jscene, w.tscene
    for seed in range(2):
        pos = _probe_positions(w, seed)
        ego_j, ego_t = js.ego, ts.ego
        ours = t_loc.localize(tsc, ts.sidx, ego_t.slot, t(pos), ego_t.lane, ego_t.route_idx)
        ref = j_localize(jsc, js.sidx, ego_j.slot, jnp.asarray(pos), ego_j.lane, ego_j.route_idx)
        close_dict(ours, ref)
        args_t = (tsc, ts.sidx, ego_t.slot, ego_t.route_idx)
        args_j = (jsc, js.sidx, ego_j.slot, ego_j.route_idx)
        close(t_loc.navi_info(*args_t, t(pos), ego_t.heading),
              j_navi_info(*args_j, jnp.asarray(pos), ego_j.heading))
        for a, b in zip(t_loc.boundary_distances(*args_t, t(pos)), j_boundary(*args_j, jnp.asarray(pos))):
            close(a, b, atol=2e-5)  # metres, up to ~20 m: a float32 ulp is 1.9e-6
        close(t_loc.heading_diff_ref(*args_t, t(pos), ego_t.heading),
              j_heading_diff(*args_j, jnp.asarray(pos), ego_j.heading))
        close(t_loc.arrive_destination(tsc, ts.sidx, ego_t.slot, t(pos)),
              j_arrive(jsc, js.sidx, ego_j.slot, jnp.asarray(pos)))
        for k in range(-1, 4):
            kk = np.full(pos.shape[0], k, np.int32)
            close(t_loc.route_road_at(tsc, ts.sidx, ego_t.slot, t(kk)),
                  j_route_road_at(jsc, js.sidx, ego_j.slot, jnp.asarray(kk)))


def test_localize_takes_first_lane_on_tie(traffic_world):
    """Two lanes with the same score: the lower index wins, as jnp.argmin
    does (localization.py:69)."""
    w = traffic_world
    tsc = w.tscene
    # a scene whose lane 1 duplicates lane 0 (same road, same geometry)
    scene = tsc.replace(**{k: _dup_lane(getattr(tsc, k)) for k in (
        "lane_kind", "lane_p0", "lane_dir", "lane_radius", "lane_start_phase", "lane_arc_dir",
        "lane_width", "lane_length", "lane_angle", "lane_road", "lane_valid")})
    E = 4
    sidx = torch.zeros(E, dtype=torch.int32)
    g = t_lg.gather_all_lanes(scene, sidx)
    pos = g["p0"][:, 0] + g["dirv"][:, 0] * 2.0
    out = t_loc.localize(scene, sidx, torch.zeros(E, dtype=torch.int32), pos,
                         torch.full((E,), 7, dtype=torch.int32), torch.zeros(E, dtype=torch.int32))
    assert (to_np(out["lane"]) == 0).all()
    assert int(torch.argmin(torch.tensor([2.0, 1.0, 1.0, 3.0]))) == 1


def _dup_lane(a):
    a = a.clone()
    a[:, 1] = a[:, 0]
    return a


# ------------------------------------------------------ participants.py
def test_pedestrians(cylinder_world):
    w = cylinder_world
    assert bool(np.asarray(w.jstate.ped.active).any())
    for a, b in zip(t_part.ped_world_pose(w.tscene, w.tstate.sidx, w.tstate.ped),
                    j_part.ped_world_pose(w.jscene, w.jstate.sidx, w.jstate.ped)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6, atol=ATOL)  # metres
    ours = t_part.step_peds(w.tscene, w.tstate.sidx, w.tstate.ped, 0.1)
    ref = j_part.step_peds(w.jscene, w.jstate.sidx, w.jstate.ped, 0.1)
    close_dict(ours.__dict__, np_tree(ref))


# --------------------------------------------------------------- idm.py
def _idm_golden():
    with open(os.path.join(os.path.dirname(__file__), "goldens", "ref_idm.json")) as f:
        return json.load(f)


def test_idm_acceleration_against_reference_golden():
    """The reference-run golden (tools/ref_idm_oracle.py), with the
    tolerance tests/test_parity_reference.py holds the JAX package to."""
    g = _idm_golden()
    for c in g["acceleration"]:
        target = t_idm.NORMAL_SPEED if c["target"] == "normal" else t_idm.CREEP_SPEED
        has = c["d"] is not None
        ours = t_idm.idm_acceleration(
            torch.tensor(float(c["v"])), torch.tensor(float(c["fv"]) if has else 0.0),
            torch.tensor(float(c["d"]) if has else 1e6), torch.tensor(has), target_speed_kmh=target)
        assert abs(float(ours) - c["acc"]) < 1e-3 + 1e-5 * abs(c["acc"]), (c, float(ours))


def test_idm_steering_pid_against_reference_golden():
    from metadrive_ped_torch.ops.math_ops import wrap_to_pi
    g = _idm_golden()
    h_i = h_e = l_i = l_e = torch.tensor(0.0)
    for step in g["steering"]:
        herr = -wrap_to_pi(torch.tensor(0.0 - step["heading"]))
        sh, h_i, h_e = t_idm._pid(t_idm.HEADING_PID, herr, h_i, h_e)
        sl, l_i, l_e = t_idm._pid(t_idm.LATERAL_PID, torch.tensor(-step["lat"]), l_i, l_e)
        assert abs(float(sh + sl) - step["steering"]) < 1e-4, step


def test_idm_lane_change_against_reference_golden():
    g = _idm_golden()

    def gaps_for(objs, lane_idx, n_lanes):
        if not (0 <= lane_idx < n_lanes):
            return np.inf, 0.0, np.inf
        front, fspeed, back = np.inf, 0.0, np.inf
        for li, dx, fv in objs:
            if li != lane_idx:
                continue
            if 0 < dx < t_idm.MAX_LONG_DIST and dx < front:
                front, fspeed = dx, fv / 3.6
            if dx < 0 and -dx < t_idm.MAX_LONG_DIST and -dx < back:
                back = -dx
        return front, fspeed, back

    for c in g["lane_change"]:
        e, n = c["ego_lane"], c["n_lanes"]
        if c["drop"] is None:
            cont = lambda i: 0 <= i < n
        elif c["drop"] == "right":
            cont = lambda i: 0 <= i < n - 1
        else:
            cont = lambda i: 1 <= i < n
        f, fs, _ = gaps_for(c["objs"], e, n)
        lf, lfs, lb = gaps_for(c["objs"], e - 1, n)
        rf, rfs, rb = gaps_for(c["objs"], e + 1, n)
        x = lambda v: torch.tensor(float(v))
        b = lambda v: torch.tensor(bool(v))
        go_left, go_right, creep, acc_gap, acc_fs, _ = t_idm.lane_change_decision(
            x(c["v"]), x(f), x(fs), torch.tensor(c["timer"], dtype=torch.int32),
            succ_exists=b(cont(e)), l_exists=b(e - 1 >= 0), r_exists=b(e + 1 < n),
            l_cont=b(cont(e - 1)), r_cont=b(cont(e + 1)),
            l_front=x(lf), l_front_speed=x(lfs), l_back=x(lb),
            r_front=x(rf), r_front_speed=x(rfs), r_back=x(rb),
        )
        ours_target = e - 1 if bool(go_left) else (e + 1 if bool(go_right) else e)
        assert ours_target == c["target"], c
        assert bool(creep) == c["creep"], c
        if c["front_dist"] is None:
            assert not np.isfinite(float(acc_gap)), c
        else:
            assert abs(float(acc_gap) - c["front_dist"]) < 1e-4, c
            assert abs(float(acc_fs) * 3.6 - c["front_speed"]) < 1e-3, c


def test_lane_change_decision_random_against_jax():
    rng = np.random.RandomState(11)
    n = 500
    f32 = lambda lo, hi: np.where(rng.rand(n) < 0.3, np.inf, rng.uniform(lo, hi, n)).astype(np.float32)
    fl = lambda: rng.rand(n) > 0.5
    args = dict(
        v_kmh=rng.uniform(0, 60, n).astype(np.float32), front_gap=f32(0, 30),
        front_speed=rng.uniform(0, 15, n).astype(np.float32),
        overtake_timer=rng.randint(0, 100, n).astype(np.int32),
        succ_exists=fl(), l_exists=fl(), r_exists=fl(), l_cont=fl(), r_cont=fl(),
        l_front=f32(0, 30), l_front_speed=rng.uniform(0, 15, n).astype(np.float32), l_back=f32(0, 30),
        r_front=f32(0, 30), r_front_speed=rng.uniform(0, 15, n).astype(np.float32), r_back=f32(0, 30),
    )
    ours = t_idm.lane_change_decision(**{k: t(v) for k, v in args.items()})
    ref = j_idm.lane_change_decision(**{k: jnp.asarray(v) for k, v in args.items()})
    for a, b in zip(ours, ref):
        close(a, b)


def test_lane_gaps(traffic_world):
    w = traffic_world
    js, ts = w.jstate, w.tstate
    E, N = np.asarray(js.npc.lane).shape
    g_j, _, _ = j_lg.gather_lane_with_neighbors(w.jscene, js.sidx[:, None], js.npc.lane)
    g_t, _, _ = t_lg.gather_lane_with_neighbors(w.tscene, ts.sidx[:, None], ts.npc.lane)
    cand_j = (jnp.concatenate([js.npc.pos, js.ego.pos[:, None]], 1),
              jnp.concatenate([js.npc.speed, js.ego.speed[:, None]], 1),
              jnp.concatenate([js.npc.active, jnp.ones((E, 1), bool)], 1))
    cand_t = tuple(t(np.asarray(a)) for a in cand_j)
    not_self = np.asarray(~jnp.eye(N, N + 1, dtype=bool)[None])
    ours = t_idm._lane_gaps(g_t, ts.npc.lane >= 0, ts.npc.pos, *cand_t, t(not_self))
    ref = j_lane_gaps(g_j, js.npc.lane >= 0, js.npc.pos, *cand_j, jnp.asarray(not_self))
    for a, b in zip(ours, ref):
        close(a, b)


@pytest.mark.parametrize("respawn", [False, True])
def test_step_npcs(world, respawn):
    w = world
    js, ts = w.jstate, w.tstate
    assert bool(np.asarray(js.npc.released & js.npc.active).any())
    ours = t_idm.step_npcs(w.tscene, ts.sidx, ts.npc, ts.ego, respawn_mode=respawn)
    ref = j_step_npcs(
        w.jscene, js.sidx, js.npc, js.ego, respawn_mode=respawn)
    ref = np_tree(ref)
    ours = {f: getattr(ours, f) for f in ref}
    ours["params"] = ours["params"].__dict__
    for k in ref:
        if k == "params":
            close_dict(ours[k], ref[k])
        else:
            close(ours[k], ref[k], atol=2e-5)  # metres and m/s after 5 substeps


# ----------------------------------------------------------- state_obs.py
def test_obs_dim():
    for args in ((240, 0, 0, 0, False), (240, 4, 160, 12, False), (24, 0, 8, 6, True), (0, 2, 0, 3, True)):
        assert t_obs.obs_dim(*args) == j_obs.obs_dim(*args)


def test_surrounding_vehicles_info(world):
    w = world
    for k in (3, 40):  # fewer and more than the NPC slots
        close(t_obs.surrounding_vehicles_info(w.tstate.ego, w.tstate.npc, k, 50.0),
              j_surrounding(w.jstate.ego, w.jstate.npc, k, 50.0))


def test_observe(world):
    """The env's whole observation of a mid-episode state. The yaw-rate
    feature is computed in its well-conditioned form in the port, so it is
    compared through cos(0.1 * f), see tests/_torch_parity.py::obs_gap."""
    from _torch_parity import obs_gap, yaw_column
    w = world
    E = np.asarray(w.jstate.sidx).shape[0]
    rng = np.random.RandomState(12)
    long = rng.uniform(0, 30, E).astype(np.float32)
    lat = rng.uniform(-2, 2, E).astype(np.float32)
    ours = w.tenv._observe(w.tstate, t(long), t(lat))
    ref = jax.jit(w.jenv._observe)(w.jstate, jnp.asarray(long), jnp.asarray(lat))
    assert ours.shape == ref.shape == (E, w.tenv.observation_dim)
    vc = w.tenv.config["vehicle_config"]
    assert obs_gap(ref, ours, yaw_column(vc)) <= ATOL
