"""The port's copy of the PG map compiler gives the JAX package's packs, and
its `Scene.from_pack` gives the JAX package's scene, bit for bit."""
import numpy as np
import pytest
from _torch_parity import np_tree, to_np

from metadrive_ped_torch.core.convert import scene_from_pack
from metadrive_ped_torch.mapgen import build_scene_pack as torch_build
from metadrive_ped_tpu.core.structs import Scene as JaxScene
from metadrive_ped_tpu.mapgen import build_scene_pack as jax_build

PACKS = {
    "SCS": ([0, 1], dict(map_config=dict(config="SCS", lane_width=3.5, lane_num=3,
                                         exit_length=50.0), traffic_density=0.1)),
    "map3": ([0, 1, 2, 3], dict(map_config=dict(config=3, lane_width=3.5, lane_num=3,
                                                exit_length=50.0), traffic_density=0.05)),
    "map3_broken_lines": ([5, 6], dict(map_config=dict(config=3, lane_width=3.5, lane_num=3,
                                                       exit_length=50.0),
                                       traffic_density=0.05, include_broken_line_segs=True)),
}


@pytest.fixture(scope="module", params=sorted(PACKS))
def packs(request):
    seeds, cfg = PACKS[request.param]
    return torch_build(seeds, cfg), jax_build(seeds, cfg)


def test_pack_bit_equal(packs):
    ours, ref = packs
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_scene_bit_equal(packs):
    ours, ref = packs
    scene = scene_from_pack(ours, "cpu")
    jscene = np_tree(JaxScene.from_pack(ref))
    assert set(jscene) == {f for f in scene.__dataclass_fields__}
    for k, a in jscene.items():
        b = to_np(getattr(scene, k))
        assert b.dtype == a.dtype, (k, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_seg_points_equal(packs):
    import jax.numpy as jnp
    ours, ref = packs
    scene = scene_from_pack(ours, "cpu")
    jscene = JaxScene.from_pack(ref)
    sidx = np.arange(ours["lane_kind"].shape[0], dtype=np.int32)[::-1].copy()
    import torch
    p0, p1 = scene.seg_points(torch.as_tensor(sidx))
    q0, q1 = jscene.seg_points(jnp.asarray(sidx))
    np.testing.assert_array_equal(to_np(p0), np.asarray(q0))
    np.testing.assert_array_equal(to_np(p1), np.asarray(q1))


def test_opendrive_not_ported(tmp_path):
    """The OpenDrive ingest is ported: an .xodr map compiles to the JAX
    package's pack, bit for bit (tests/test_torch_opendrive.py holds the
    parser, the network and an env on it)."""
    from metadrive_ped_torch.mapgen.opendrive import TWO_ROAD_XODR
    path = tmp_path / "two_road.xodr"
    path.write_text(TWO_ROAD_XODR)
    cfg = dict(map_config=dict(xodr_file=str(path)), traffic_density=0.1)
    ours, ref = torch_build([0], cfg), jax_build([0], cfg)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
