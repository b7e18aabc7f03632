"""The port's OpenDrive ingest (mapgen/opendrive.py) against the JAX
package's, on the two-road map of tests/test_opendrive.py (the port keeps
its own copy of that text, `TWO_ROAD_XODR`): the parsed roads and the
compiled road network equal, the scene pack bit-equal, and a 4-env PG env
on the map with small detectors within 1e-4 of JAX over 20 steps."""
import numpy as np
import pytest
from _torch_parity import check_run, run_pair, yaw_column
from test_opendrive import SIMPLE_XODR

from metadrive_ped_torch import MetaDriveEnv as TorchEnv
from metadrive_ped_torch.mapgen import build_scene_pack as torch_build
from metadrive_ped_torch.mapgen import opendrive as torch_od
from metadrive_ped_tpu import MetaDriveEnv as JaxEnv
from metadrive_ped_tpu.mapgen import build_scene_pack as jax_build
from metadrive_ped_tpu.mapgen import opendrive as jax_od


@pytest.fixture(scope="module")
def xodr_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("xodr") / "two_road.xodr"
    p.write_text(torch_od.TWO_ROAD_XODR)
    return str(p)


def test_two_road_text_is_the_jax_tests_map():
    assert torch_od.TWO_ROAD_XODR == SIMPLE_XODR


def test_parse_xodr_equals_jax(xodr_path):
    jroads, troads = jax_od.parse_xodr(xodr_path), torch_od.parse_xodr(xodr_path)
    assert len(jroads) == len(troads) == 2
    for a, b in zip(jroads, troads):
        assert (a.id, a.length, a.junction, a.succ, a.pred, a.lane_offset) == \
               (b.id, b.length, b.junction, b.succ, b.pred, b.lane_offset)
        assert [(g.s0, g.x, g.y, g.hdg, g.length, g.kind, g.params) for g in a.geoms] == \
               [(g.s0, g.x, g.y, g.hdg, g.length, g.kind, g.params) for g in b.geoms]
        for (s0, s1, la, ra), (t0, t1, lb, rb) in zip(a.sections, b.sections):
            assert (s0, s1) == (t0, t1)
            assert [(x.id, x.type, x.widths) for x in la + ra] == \
                   [(x.id, x.type, x.widths) for x in lb + rb]
        for s in np.linspace(0.0, a.length, 17):
            assert a.ref_line(s) == b.ref_line(s)


def test_build_network_equals_jax(xodr_path):
    (nj, sj, ij), (nt, st, it) = (jax_od.build_network_from_xodr(xodr_path),
                                  torch_od.build_network_from_xodr(xodr_path))
    assert (sj.start_node, sj.end_node) == (st.start_node, st.end_node)
    assert ij["num_roads"] == it["num_roads"] and len(ij["chains"]) == len(it["chains"])
    assert list(nj.graph) == list(nt.graph)
    for a in nj.graph:
        assert list(nj.graph[a]) == list(nt.graph[a])
        for b in nj.graph[a]:
            for lj, lt in zip(nj.graph[a][b], nt.graph[a][b], strict=True):
                assert (lj.length, lj.width, list(lj.line_types)) == \
                       (lt.length, lt.width, list(lt.line_types))
                for s in (0.0, lj.length / 2, lj.length):
                    np.testing.assert_array_equal(lj.position(s, 0.0), lt.position(s, 0.0))
    assert nj.bfs_distances(sj.start_node) == nt.bfs_distances(st.start_node)


def test_xodr_pack_bit_equal(xodr_path):
    cfg = dict(map_config=dict(xodr_file=xodr_path), traffic_density=0.2,
               include_broken_line_segs=True)
    ours, ref = torch_build([0], cfg), jax_build([0], cfg)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_opendrive_env_matches_jax(xodr_path):
    """4 envs on the xodr map (respawn traffic 0.2, side 8 and lane-line 4
    rays) for 20 steps of full throttle with a weave: obs, reward, flags,
    info and the final state through `check_run`."""
    cfg = dict(num_envs=4, num_scenarios=1, traffic_density=0.2, traffic_mode="respawn",
               map_config=dict(xodr_file=xodr_path),
               vehicle_config=dict(side_detector=dict(num_lasers=8),
                                   lane_line_detector=dict(num_lasers=4)))
    steer = 0.3 * np.sin(np.arange(20) / 3.0)
    actions = [np.tile([s, 1.0], (4, 1)).astype(np.float32) for s in steer]
    tenv = TorchEnv(cfg, device="cpu")
    run = run_pair(JaxEnv(cfg), tenv, actions)
    assert check_run(run, tenv, yaw_column(cfg["vehicle_config"])) == 0
    obs = run["steps"][-1][1][0]
    assert obs.shape == (4, tenv.observation_dim)
    assert int(tenv._state.npc.active.sum()) > 0, "IDM traffic on the xodr map"
    assert float(tenv._state.ego.speed.min()) > 1.0, "the egos drive forward"
