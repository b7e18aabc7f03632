"""The port's scenario path (ScenarioEnv, its pack builder, polyline ops,
episode exporter, ScenarioDescription, dataset IO and lane graph) against
the JAX package's, on the CPU.

Scenarios come from two sources: small synthetic Waymo-shape SDs
(`scenario/synthetic.py`, seeds 0-2) and episodes the JAX MetaDriveEnv
exports from map "SCS" with respawn traffic, as tests/test_scenario_env.py
records them. Packs and scenes are bit-equal; polyline ops agree to 1e-6;
the env agrees in obs and reward to 1e-4 with flags and integer info
exact, through auto-resets (the yaw-rate and lateral-offset features are
compared as tests/_torch_parity.py::obs_gap sets out)."""
import copy
import importlib.util
import itertools
import os

import numpy as np
import pytest
import torch
from _torch_parity import assert_trees_close, np_tree, obs_gap, to_np

from metadrive_ped_torch import MetaDriveEnv as TorchPG
from metadrive_ped_torch import ScenarioEnv as TorchEnv
from metadrive_ped_torch.core.convert import state_from_numpy, state_to_numpy
from metadrive_ped_torch.core.scenario_structs import ScenarioScene as TorchScene
from metadrive_ped_torch.core.scenario_structs import ScenarioSimState
from metadrive_ped_torch.mapgen import edge_network as torch_en
from metadrive_ped_torch.mapgen import scenario_scene as torch_ss
from metadrive_ped_torch.ops import polyline as TP
from metadrive_ped_torch.scenario import export_scenarios as torch_export
from metadrive_ped_torch.scenario import utils as torch_utils
from metadrive_ped_torch.scenario.description import MetaDriveType as TorchType
from metadrive_ped_torch.scenario.description import ScenarioDescription as TorchSD
from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
from metadrive_ped_tpu import MetaDriveEnv as JaxPG
from metadrive_ped_tpu.core.scenario_structs import ScenarioScene as JaxScene
from metadrive_ped_tpu.envs.scenario_env import ScenarioEnv as JaxEnv
from metadrive_ped_tpu.mapgen import edge_network as jax_en
from metadrive_ped_tpu.mapgen import scenario_scene as jax_ss
from metadrive_ped_tpu.ops import polyline as JP
from metadrive_ped_tpu.scenario import export_scenarios as jax_export
from metadrive_ped_tpu.scenario import utils as jax_utils
from metadrive_ped_tpu.scenario.description import MetaDriveType as JaxType
from metadrive_ped_tpu.scenario.description import ScenarioDescription as JaxSD

ATOL = 1e-4
STEPS = 50  # the scenarios are 40 steps long: every env truncates and auto-resets
E = 8
PG_CFG = dict(num_envs=4, map="SCS", num_scenarios=2, traffic_density=0.5,
              traffic_mode="respawn")
EXPORT_STEPS = 40


def _small_synthetic():
    return [synthetic_waymo_sd(s, T=40, n_tracks=12, lane_pts=40) for s in range(3)]


def _pg_actions():
    return np.tile([0.0, 0.7], (PG_CFG["num_envs"], 1)).astype(np.float32)


@pytest.fixture(scope="module")
def exported():
    """The same PG run exported by both packages."""
    je, te = JaxPG(PG_CFG), TorchPG(PG_CFG, device="cpu")
    je.reset(seed=0)
    te.reset(seed=0)
    return (list(jax_export(je, EXPORT_STEPS, actions=_pg_actions()).values()),
            list(torch_export(te, EXPORT_STEPS, actions=_pg_actions()).values()))


@pytest.fixture(scope="module")
def sources(exported):
    return dict(synthetic=_small_synthetic(), exported=exported[0])


# ---- packs and scenes -----------------------------------------------------

@pytest.mark.parametrize("source", ["synthetic", "exported"])
def test_pack_and_scene_bit_equal(sources, source):
    sds = sources[source]
    pj, pt = jax_ss.build_scenario_pack(sds), torch_ss.build_scenario_pack(sds)
    assert set(pj) == set(pt)
    for k in pj:
        a, b = np.asarray(pj[k]), np.asarray(pt[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    sj, st = np_tree(JaxScene.from_pack(pj)), TorchScene.from_pack(pt, "cpu")
    for k, a in sj.items():
        b = getattr(st, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    sidx = np.arange(len(sds), dtype=np.int32)[::-1].copy()
    for a, b in zip(JaxScene.from_pack(pj).seg_points(sidx),
                    st.seg_points(torch.as_tensor(sidx))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_exported_maps_carry_lines(sources):
    """The PG exports give the side detector continuous lines; the
    synthetic maps carry road edges only (no line for it to see)."""
    from metadrive_ped_torch.ops import ray_segment
    for source, has_lines in (("exported", True), ("synthetic", False)):
        scene = TorchScene.from_pack(torch_ss.build_scenario_pack(sources[source]), "cpu")
        _, counts = ray_segment.build_line_table(scene, include_broken=False)
        assert bool((counts[:, 0] > 0).all()) == has_lines, source


# ---- polyline ops ---------------------------------------------------------

def _poly_inputs(seed=0, B=64, P=9):
    """Random polylines [B,P,2] with ragged npts and junk past npts, query
    points around them, and arcs below 0, inside and past the end."""
    rng = np.random.RandomState(seed)
    steps = rng.uniform(0.5, 3.0, (B, P, 1)) * np.stack(
        [np.cos(rng.uniform(-0.6, 0.6, (B, P))), np.sin(rng.uniform(-0.6, 0.6, (B, P)))], -1)
    pts = (np.cumsum(steps, 1) + rng.uniform(-50, 50, (B, 1, 2))).astype(np.float32)
    npts = rng.randint(2, P + 1, B).astype(np.int32)
    junk = np.arange(P)[None, :] >= npts[:, None]
    pts[junk] = rng.uniform(-80, 80, (int(junk.sum()), 2))
    pos = (pts[:, 0] + rng.uniform(-8, 8, (B, 2)) * 3).astype(np.float32)
    long = rng.uniform(-5, 30, (B, 7)).astype(np.float32)
    return pts, npts, pos, long


def _close(a, b, name, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), to_np(b).astype(np.float64),
                               rtol=1e-6, atol=atol, err_msg=name)


def test_polyline_arc_position_heading():
    pts, npts, pos, long = _poly_inputs()
    j = lambda a: np.asarray(a)
    tp, tn, tl = map(torch.as_tensor, (pts, npts, long))
    s_j, s_t = JP.arc_lengths(pts, npts), TP.arc_lengths(tp, tn)
    _close(s_j, s_t, "arc_lengths")
    _close(JP.total_length(pts, npts), TP.total_length(tp, tn), "total_length")
    # broadcast batch axes, as the env's checkpoint lookup makes them
    args_j = (pts[:, None], npts[:, None], long)
    args_t = (tp[:, None], tn[:, None], tl)
    _close(JP.position(*args_j), TP.position(*args_t), "position")
    _close(JP.position(*args_j, s=j(s_j)[:, None]), TP.position(*args_t, s=s_t[:, None]),
           "position s=")
    lat = np.full_like(long, 1.5)
    _close(JP.position(*args_j, lat=lat), TP.position(*args_t, lat=torch.as_tensor(lat)),
           "position lat=")
    _close(JP.heading_at(*args_j), TP.heading_at(*args_t), "heading_at")
    bj = JP._containing_segment(pts[:, None], npts[:, None], long)[0]
    np.testing.assert_array_equal(j(bj), TP._containing_segment(tp[:, None], tn[:, None], tl)[0])


def test_polyline_local_coordinates_and_band():
    pts, npts, pos, _ = _poly_inputs(seed=1)
    tp, tn, tq = map(torch.as_tensor, (pts, npts, pos))
    for s_j, s_t in ((None, None), (JP.arc_lengths(pts, npts), TP.arc_lengths(tp, tn))):
        lj, aj = JP.local_coordinates(pts, npts, pos, s=s_j)
        lt, at = TP.local_coordinates(tp, tn, tq, s=s_t)
        _close(lj, lt, "long")
        # the lateral offset through its signed square (see obs_gap)
        aj = np.asarray(aj, np.float64)
        at = at.numpy().astype(np.float64)
        _close(aj * np.abs(aj), at * np.abs(at), "lat * |lat|", atol=1e-5)
    half = np.random.RandomState(2).uniform(0.5, 20, pts.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(JP.in_band(pts, npts, pos, half)),
        TP.in_band(tp, tn, tq, torch.as_tensor(half)).numpy())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("with_total", [False, True])
def test_polyline_uniform_pose(quantized, with_total):
    """The fixed-spacing route lookups, on float routes and on int16 routes
    dequantized with scale and origin, padded past unpts with the endpoint
    and queried below 0, inside and past the route's end."""
    rng = np.random.RandomState(3)
    B, P, spacing = 48, 12, 2.5
    unpts = rng.randint(1, P + 1, B).astype(np.int32)
    route = np.cumsum(rng.uniform(-1, 1, (B, P, 2)) + [spacing, 0], axis=1).astype(np.float32)
    route[np.arange(P)[None, :] >= unpts[:, None]] = 0.0
    route = np.where(np.arange(P)[None, :, None] >= unpts[:, None, None],
                     route[np.arange(B), np.maximum(unpts - 1, 0)][:, None], route)
    total = ((np.maximum(unpts, 1) - 1) * spacing - rng.uniform(0, 1, B)).clip(0).astype(np.float32)
    long = rng.uniform(-3, P * spacing + 5, B).astype(np.float32)
    kw_j, kw_t = {}, {}
    path = route
    if quantized:
        origin = route[:, 0].copy()
        path = np.round((route - origin[:, None]) / 0.025).astype(np.int16)
        kw_j = dict(scale=0.025, origin=origin)
        kw_t = dict(scale=0.025, origin=torch.as_tensor(origin))
    tot_j = total if with_total else None
    tot_t = torch.as_tensor(total) if with_total else None
    tpath, tu, tl = map(torch.as_tensor, (path, unpts, long))
    pj, hj = JP.uniform_pose(path, unpts, spacing, long, total=tot_j, **kw_j)
    pt, ht = TP.uniform_pose(tpath, tu, spacing, tl, total=tot_t, **kw_t)
    _close(pj, pt, "uniform_pose pos")
    _close(hj, ht, "uniform_pose heading")
    ij, fj = JP._chord_index_frac(P, unpts, spacing, long, tot_j)
    it, ft = TP._chord_index_frac(P, tu, spacing, tl, tot_t)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    _close(fj, ft, "frac")
    if with_total:
        deltas = (2, 4, 6, 8)
        pj, hj, aj = JP.uniform_pose_and_ahead(path, unpts, spacing, long, total, deltas, **kw_j)
        pt, ht, at = TP.uniform_pose_and_ahead(tpath, tu, spacing, tl, tot_t, deltas, **kw_t)
        _close(pj, pt, "and_ahead pos")
        _close(hj, ht, "and_ahead heading")
        for a, b in zip(aj, at):
            _close(a, b, "ahead point")


# ---- the env --------------------------------------------------------------

SIDE160 = dict(side_detector=dict(num_lasers=160), lane_line_detector=dict(num_lasers=12))
ENV_CASES = {
    "replay": ("exported", dict()),
    "reactive": ("synthetic", dict(reactive_traffic=True)),
    "replay_ego_side160": ("exported", dict(replay_ego=True, vehicle_config=SIDE160)),
    "side0": ("exported", dict(vehicle_config=dict(side_detector=dict(num_lasers=0)))),
    "curriculum2": ("exported", dict(curriculum_level=2, episodes_to_evaluate_curriculum=2)),
    "sequential": ("synthetic", dict(sequential_seed=True, reactive_traffic=True)),
    "strict_road": ("exported", dict(relax_out_of_road_done=False)),
}


def _actions(seed, steps, n):
    rng = np.random.RandomState(seed)
    return np.clip(rng.normal([0.0, 0.6], [0.3, 0.4], (steps, n, 2)), -1, 1).astype(np.float32)


def _columns(cfg):
    """(yaw column, lateral-offset columns) of the scenario observation."""
    side = max(cfg.get("vehicle_config", {}).get("side_detector", {}).get("num_lasers", 12), 2)
    return side + 5, (side + 6, side + 7 + 18)


def _check_step(jax_out, torch_out, cfg):
    oj, rj, tj, trj, ij = jax_out
    ot, rt, tt, trt, it = torch_out
    yaw, lat = _columns(cfg)
    assert obs_gap(oj, ot, yaw, lat) <= ATOL
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(to_np(tt), np.asarray(tj))
    np.testing.assert_array_equal(to_np(trt), np.asarray(trj))
    assert set(it) == set(ij)
    for k in ij:
        a, b = np.asarray(ij[k]), to_np(it[k])
        if k == "lateral_dist":
            a, b = a * np.abs(a), b * np.abs(b)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_env_matches_jax(sources, case):
    source, extra = ENV_CASES[case]
    cfg = dict(num_envs=E, scenario_data=sources[source], **extra)
    je, te = JaxEnv(cfg), TorchEnv(cfg, device="cpu")
    assert te.observation_dim == je.observation_dim
    (oj, ij), (ot, it) = je.reset(seed=0), te.reset(seed=0)
    yaw, lat = _columns(cfg)
    assert obs_gap(oj, ot, yaw, lat) <= ATOL
    np.testing.assert_array_equal(to_np(it["env_seed"]), np.asarray(ij["env_seed"]))
    done = 0
    for a in _actions(0, STEPS, E):
        jo, to = je.step(a), te.step(a)
        _check_step(jo, to, cfg)
        done += int(np.asarray(jo[2] | jo[3]).sum())
    assert done > 0, "the comparison should cover episode ends and auto-resets"
    assert te.data_coverage == je.data_coverage
    assert te.current_level == je.current_level
    if extra.get("reactive_traffic"):
        assert float(te._state.npc_long.max()) > 0.0


def test_env_handover_and_rollout(sources):
    """The port steps on from a JAX state handed over mid-episode, and its
    rollout equals its step loop."""
    cfg = dict(num_envs=E, scenario_data=sources["synthetic"], reactive_traffic=True)
    je, te = JaxEnv(cfg), TorchEnv(cfg, device="cpu")
    je.reset(seed=1)
    for a in _actions(1, 13, E):
        je.step(a)
    handed = np_tree(je._state)
    te2 = TorchEnv(cfg, device="cpu")
    for env in (te, te2):
        env.reset(seed=1)
        env._state = state_from_numpy(handed, "cpu", cls=ScenarioSimState)
    acts = _actions(2, 30, E)
    for a in acts:
        _check_step(je.step(a), te.step(a), cfg)
    # the same 30 steps through rollout, from the handed-over state
    it = iter(torch.as_tensor(acts))
    outs, mean_reward = te2.rollout(30, policy_fn=lambda obs, state: next(it),
                                    collect=("reward", "obs", "terminated", "truncated"))
    assert_trees_close(state_to_numpy(te._state), state_to_numpy(te2._state), atol=0)
    torch.testing.assert_close(outs["obs"][-1], te._last_obs, rtol=0, atol=0)
    assert bool((outs["terminated"] | outs["truncated"]).any())
    assert np.isfinite(mean_reward)


def test_env_step_info_surface(sources):
    """Host-side statistics of step(): coverage, difficulty, curriculum."""
    sds = copy.deepcopy(sources["exported"])
    for i, sd in enumerate(sds):
        sd["metadata"]["difficulty"] = float(i)
    cfg = dict(num_envs=4, scenario_data=sds, curriculum_level=2, sequential_seed=True,
               episodes_to_evaluate_curriculum=2, target_success_rate=0.5)
    te = TorchEnv(cfg, device="cpu")
    _, info = te.reset(seed=0)
    assert info["curriculum_level"] == 0 and te.num_scenarios == len(sds) // 2
    _, _, _, _, info = te.step(np.tile([0.0, 0.5], (4, 1)))
    np.testing.assert_array_equal(info["scenario_difficulty"].numpy(),
                                  info["env_seed"].numpy().astype(np.float32))
    assert 0.0 < info["data_coverage"] <= 1.0
    te._cur_recent.extend([True, True])
    te._curriculum_update(torch.tensor([True, False, False, False]), torch.zeros(4, dtype=bool),
                          dict(arrive_dest=torch.tensor([True, False, False, False])))
    assert te.current_level == 1 and te.num_scenarios == len(sds)
    assert int(te._state.scenario_cap[0]) == len(sds)
    assert te.get_map_features(1) == sds[1]["map_features"]
    net = te.edge_network(0)
    lanes = [k for k, v in sds[0]["map_features"].items() if "LANE" in str(v["type"])]
    assert set(net.graph) == set(lanes)


# ---- export, dataset IO, synthetic data -----------------------------------

def _assert_sd_close(a, b, atol, path=""):
    """Two SD trees equal key for key, float arrays within atol."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_sd_close(a[k], b[k], atol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_sd_close(x, y, atol, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape, path
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, str) and a.startswith("metadrive_ped_"):
        assert b.startswith("metadrive_ped_"), path  # each package names itself
    else:
        assert a == b, path


def test_export_matches_jax(exported):
    jax_sds, torch_sds = exported
    assert len(jax_sds) == len(torch_sds) == PG_CFG["num_envs"]
    for a, b in zip(jax_sds, torch_sds):
        _assert_sd_close(dict(a), dict(b), ATOL)
    assert any(len(sd["tracks"]) > 1 for sd in torch_sds), "exports should carry traffic"


def test_dataset_roundtrip_and_worker_striding(tmp_path, exported):
    sds = exported[1]
    torch_utils.save_dataset([copy.deepcopy(s) for s in sds], str(tmp_path))
    loaded = torch_utils.load_scenarios(str(tmp_path))
    assert len(loaded) == len(sds)
    np.testing.assert_array_equal(loaded[0]["tracks"]["sdc"]["state"]["position"],
                                  sds[0]["tracks"]["sdc"]["state"]["position"])
    w0 = torch_utils.load_scenarios(str(tmp_path), worker_index=0, num_workers=2)
    w1 = torch_utils.load_scenarios(str(tmp_path), worker_index=1, num_workers=2)
    assert len(w0) + len(w1) == len(sds)
    assert {sd["id"] for sd in w0}.isdisjoint({sd["id"] for sd in w1})
    summary, ids, _ = torch_utils.read_dataset_summary(str(tmp_path))
    assert ids == sorted(summary) and summary[ids[0]]["length"] == EXPORT_STEPS
    torch_utils.assert_scenario_equal({i: s for i, s in enumerate(sds)},
                                      {i: s for i, s in enumerate(loaded)})
    env = TorchEnv(dict(num_envs=2, data_directory=str(tmp_path), num_scenarios=2),
                   device="cpu")
    assert env.num_scenarios == 2
    png = tmp_path / "map.png"
    torch_utils.draw_map(sds[0]["map_features"], save_path=str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and png.stat().st_size > 1000


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dataset_io_matches_jax(tmp_path, exported, writer):
    """A dataset written by either package reads the same through both
    packages' readers, and both packages' assert_scenario_equal agree on it."""
    sds = [copy.deepcopy(s) for s in exported[0]]
    (jax_utils if writer == "jax" else torch_utils).save_dataset(sds, str(tmp_path))
    d = str(tmp_path)
    for a, b in zip(jax_utils.read_dataset_summary(d), torch_utils.read_dataset_summary(d)):
        _assert_sd_close(a, b, atol=0)
    for kw in (dict(), dict(worker_index=0, num_workers=2), dict(worker_index=1, num_workers=2),
               dict(start_index=1, num=2)):
        lj, lt = jax_utils.load_scenarios(d, **kw), torch_utils.load_scenarios(d, **kw)
        assert [s["id"] for s in lj] == [s["id"] for s in lt], kw
        for a, b in zip(lj, lt):
            _assert_sd_close(dict(a), dict(b), atol=0)
    loaded = {i: s for i, s in enumerate(torch_utils.load_scenarios(d))}
    moved = copy.deepcopy(loaded)
    for track in moved[1]["tracks"].values():
        track["state"]["position"][5:, 0] += 1.0
    for other, equal in ((dict(enumerate(sds)), True), (moved, False)):
        outcomes = [_outcome(u.assert_scenario_equal, other, loaded)[0]
                    for u in (jax_utils, torch_utils)]
        assert outcomes == ["ok" if equal else "AssertionError"] * 2


# ---- host-side map structures ---------------------------------------------

def _sanity_variants(sd):
    """The SD and broken copies of it, each missing or spoiling one thing
    sanity_check requires."""
    sdc = sd["metadata"]["sdc_id"]
    lane = next(k for k, v in sd["map_features"].items() if "LANE" in str(v["type"]))
    cuts = {
        "no_dynamic_map_states": lambda d: d.pop("dynamic_map_states"),
        "short_position": lambda d: d["tracks"][sdc]["state"].update(
            position=d["tracks"][sdc]["state"]["position"][:-1]),
        "unknown_type": lambda d: d["tracks"][sdc].update(type="SPACESHIP"),
        "lane_without_polyline": lambda d: d["map_features"][lane].pop("polyline"),
        "metadata_without_ts": lambda d: d["metadata"].pop("ts"),
        "object_id_mismatch": lambda d: d["tracks"][sdc]["metadata"].update(object_id="x"),
    }
    yield "intact", sd
    for name, cut in cuts.items():
        broken = copy.deepcopy(sd)
        cut(broken)
        yield name, broken


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the two packages must fail alike
        return (type(e).__name__, None)


@pytest.mark.parametrize("source", ["synthetic", "exported"])
def test_scenario_description_matches_jax(sources, source):
    """ScenarioDescription's checks and summaries, and MetaDriveType's
    predicates, give what the JAX package's give."""
    for sd in sources[source][:2]:
        for name, variant in _sanity_variants(sd):
            for valid_check in (False, True):
                assert (_outcome(JaxSD.sanity_check, variant, valid_check=valid_check)
                        == _outcome(TorchSD.sanity_check, variant, valid_check=valid_check)), \
                    (name, valid_check)
        _assert_sd_close(JaxSD.get_number_summary(sd), TorchSD.get_number_summary(sd), atol=0)
        assert JaxSD.sdc_moving_dist(sd) == TorchSD.sdc_moving_dist(sd)
        mj = JaxSD.update_summaries(copy.deepcopy(sd))["metadata"]
        mt = TorchSD.update_summaries(copy.deepcopy(sd))["metadata"]
        _assert_sd_close(mj, mt, atol=0)
    names = {v for k, v in vars(JaxType).items() if isinstance(v, str) and not k.startswith("_")}
    assert names == {v for k, v in vars(TorchType).items()
                     if isinstance(v, str) and not k.startswith("_")}
    for t in sorted(names) + ["lane", "", None, 3]:
        for pred in ("has_type", "is_lane", "is_vehicle", "is_participant"):
            assert getattr(JaxType, pred)(t) == getattr(TorchType, pred)(t), (pred, t)


def _route_pairs(net, n_starts, seed):
    """(start, goal) pairs: each start lane with a goal a random walk of 1-4
    exit hops away, so every BFS ends."""
    rng = np.random.RandomState(seed)
    lanes = list(net.graph)
    pairs = []
    for start in (lanes[i] for i in rng.permutation(len(lanes))[:n_starts]):
        lane, hops = start, rng.randint(1, 5)
        for _ in range(hops):
            exits = [e for e in net.graph[lane].exit_lanes if e in net.graph]
            if not exits:
                break
            lane = exits[rng.randint(len(exits))]
        pairs.append((start, lane))
    return pairs


def _assert_networks_equal(nj, nt, pairs, seed):
    rng = np.random.RandomState(seed)
    assert list(nj.graph) == list(nt.graph)
    for lid in nj.graph:
        a, b = nj.graph[lid], nt.graph[lid]
        for f in ("entry_lanes", "exit_lanes", "left_lanes", "right_lanes"):
            assert getattr(a, f) == getattr(b, f), (lid, f)
        la, lb = a.lane, b.lane
        assert (la.index, la.length, la.width) == (lb.index, lb.length, lb.width), lid
        np.testing.assert_array_equal(la.polyline, lb.polyline)
        assert la.get_bounding_box() == lb.get_bounding_box()
        for s in (-1.0, 0.0, la.length / 3, la.length, la.length + 2.0):
            for lat in (0.0, 1.5):
                np.testing.assert_array_equal(la.position(s, lat), lb.position(s, lat))
        for p in la.polyline[0] + rng.uniform(-10, 10, (3, 2)).astype(np.float32):
            assert la.local_coordinates(p) == lb.local_coordinates(p), lid
        assert ([l.index for l in nj.get_peer_lanes_from_index(lid)]
                == [l.index for l in nt.get_peer_lanes_from_index(lid)]), lid
    assert nj.get_bounding_box() == nt.get_bounding_box()
    for start, goal in pairs:
        assert nj.shortest_path(start, goal) == nt.shortest_path(start, goal), (start, goal)
        assert (list(itertools.islice(nj.bfs_paths(start, goal), 5))
                == list(itertools.islice(nt.bfs_paths(start, goal), 5))), (start, goal)
    _assert_sd_close(nj.get_map_features(), nt.get_map_features(), atol=0)
    _assert_sd_close(nj.get_map_features(interval=5.0), nt.get_map_features(interval=5.0), atol=0)


@pytest.mark.parametrize("source", ["chain", "synthetic", "exported"])
def test_edge_network_matches_jax(sources, source):
    """The lane graph of each scenario map: lanes, adjacency, routes
    (reachable goals, and every pair on the small chain map, unreachable
    ones included), peer lanes, lane geometry and the exported map
    features are those of the JAX package's network."""
    from test_edge_network import _chain_sd
    sds = [_chain_sd()] if source == "chain" else sources[source][:2]
    for i, sd in enumerate(sds):
        nj, nt = jax_en.build_edge_network(sd), torch_en.build_edge_network(sd)
        assert len(nt.graph) > 0
        pairs = (list(itertools.product(nt.graph, nt.graph)) if source == "chain"
                 else _route_pairs(nt, 12, seed=i))
        assert any(nt.shortest_path(s, g) for s, g in pairs)
        _assert_networks_equal(nj, nt, pairs, seed=i)
    # merging two networks and taking one back out
    if source != "chain":
        nets = []
        for en in (jax_en, torch_en):
            net = en.build_edge_network(sds[0]).add(en.build_edge_network(sds[1]),
                                                    no_intersect=False)
            keys = list(net.graph)
            net -= en.build_edge_network(sds[1])
            nets.append((keys, list(net.graph)))
        assert nets[0] == nets[1]


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("kwargs", [dict(seed=0), dict(seed=7),
                                    dict(seed=2, T=40, n_tracks=12, lane_pts=40)])
def test_synthetic_equals_bench(kwargs):
    ref = _load_bench()._synthetic_waymo_sd(**kwargs)
    out = synthetic_waymo_sd(**kwargs)
    _assert_sd_close(ref, out, atol=0)
