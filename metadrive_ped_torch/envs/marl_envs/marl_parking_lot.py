"""Multi-agent parking lot scene.

Reference: metadrive/envs/marl_envs/marl_parking_lot.py — a fixed map
FirstPGBlock(1 lane) -> ParkingLot(2N spaces) -> TInterSection, where agents
either drive in from one of three entrances toward a parking space, or
drive out of a parking space toward an exit. Episodes end on yellow-line /
off-lane / sidewalk; white continuous lines may be crossed (vehicles cross
them while manoeuvring into spaces). Reverse is enabled.

The reference's ParkingLotSpawnManager reserves parking spaces as agents
target them (marl_parking_lot.py:47-95). Here routes are compiled per spawn
slot when the scene is built, so two agents can target the same space in
one episode; slot occupancy is still checked on respawn. The JAX package
does the same.
"""
from metadrive_ped_torch.envs.marl_envs.marl_env import MultiAgentMetaDrive

PARKING_SPACE_NUM = 8  # MAParkingLotConfig parking_space_num
_IN_SPAWN_ROADS = [(">>", ">>>"), ("-2T0_1_", "-2T0_0_"), ("-2T2_1_", "-2T2_0_")]
_EXIT_DESTS = ["->>", "2T0_1_", "2T2_1_"]


def _lot_roads(n, in_roads):
    """Spawn roads and per-road destination candidates of an n-space lot:
    the entrances park into a space, the spaces drive out to an entrance's
    reverse side (update_destination_for, marl_parking_lot.py:82-90)."""
    out_roads = [(f"1P{k}_5_", f"1P{k}_6_") for k in range(1, n + 1)]
    space_dests = [f"1P{k}_2_" for k in range(1, n + 1)]
    return (in_roads + out_roads,
            [space_dests] * len(in_roads) + [_EXIT_DESTS] * len(out_roads))


class MultiAgentParkingLotEnv(MultiAgentMetaDrive):
    @classmethod
    def default_config(cls):
        config = super().default_config()
        spawn_roads, dest_nodes = _lot_roads(PARKING_SPACE_NUM, _IN_SPAWN_ROADS)
        config.update(
            dict(
                num_agents=10,
                parking_space_num=PARKING_SPACE_NUM,
                map="P",  # informational; the map is custom_blocks, set in __init__
                map_config=dict(lane_width=3.5, lane_num=1, exit_length=20.0, custom_blocks=None),
                spawn_roads=spawn_roads,
                spawn_dest_nodes=dest_nodes,
                vehicle_config=dict(
                    enable_reverse=True,
                    lidar=dict(num_lasers=72, distance=40.0, num_others=0,
                               gaussian_noise=0.0, dropout_prob=0.0),
                ),
            ),
            allow_add_new_key=True,
        )
        return config

    def __init__(self, config=None, device=None):
        cfg = self.default_config()
        if config:
            cfg.update(config, allow_add_new_key=True)
        n = cfg["parking_space_num"]
        assert n % 2 == 0, "number of parking spaces must be multiples of 2"
        assert n >= 4, "minimal number of parking space is 4"
        cfg["map_config"]["custom_blocks"] = [
            dict(id="P", config=dict(one_side_vehicle_number=n // 2)),
            dict(id="T", config=dict(t_type=1, change_lane_num=0, exit_part_length=10.0)),
        ]
        if n != PARKING_SPACE_NUM:
            spawn_roads, dest_nodes = _lot_roads(n, [tuple(r) for r in cfg["spawn_roads"][:3]])
            cfg["spawn_roads"] = spawn_roads
            cfg.force_set("spawn_dest_nodes", dest_nodes)
        super().__init__(cfg, device)

    def _is_out_of_road(self, ego, state=None):
        # marl_parking_lot.py:274-277: white continuous lines are crossable
        return ego.on_yellow_line | ~ego.on_lane | ego.crash_sidewalk
