"""BIG — Block Incremental Generation (host-side).

Re-implements the reference's depth-first random block search with
backtracking (metadrive/component/algorithm/BIG.py:14-164): forward /
destruct_current / search_sibling / back FSM with MAX_TRIAL=5 re-samples per
block. The np_random draw order inside sample_block matches the reference
(type choice, socket choice, block seed) so that maps are structurally
reproducible per seed.
"""
import numpy as np

from benchmarks.reference.mapgen.blocks import (
    BLOCK_DIST_V2, BLOCK_NAME_TO_CLASS, PG_BLOCKS, FirstPGBlock
)
from benchmarks.reference.mapgen.network import NodeRoadNetwork


class NextStep:
    back = 0
    forward = 1
    search_sibling = 3
    destruct_current = 4


class BigGenerateMethod:
    BLOCK_SEQUENCE = "block_sequence"
    BLOCK_NUM = "block_num"


class BIG:
    MAX_TRIAL = 5

    def __init__(self, lane_num, lane_width, global_network, exit_length=50.0, random_seed=None):
        from benchmarks.reference.mapgen.ref_random import ref_rng
        self.np_random = ref_rng(random_seed if random_seed is not None else 0)
        self._lane_num = lane_num
        self._lane_width = lane_width
        self._global_network = global_network
        self._exit_length = exit_length
        self._block_sequence = None
        self.block_num = None
        self.blocks = [FirstPGBlock(global_network, lane_width, lane_num, length=exit_length)]
        self.next_step = NextStep.forward

        # Every type in the v2 distribution must be registered — a missing
        # class would silently skew the type-choice RNG stream and break
        # seed parity, so fail loudly instead of renormalizing.
        missing = [n for n in BLOCK_DIST_V2 if n not in BLOCK_NAME_TO_CLASS]
        assert not missing, f"unregistered distribution block types: {missing}"
        names = list(BLOCK_DIST_V2)
        self._block_names = names
        self._block_probs = np.array([BLOCK_DIST_V2[n] for n in names], dtype=np.float64)

    def generate(self, generate_method, parameter):
        if generate_method == BigGenerateMethod.BLOCK_NUM:
            self.block_num = int(parameter) + 1
        elif generate_method == BigGenerateMethod.BLOCK_SEQUENCE:
            self.block_num = len(parameter) + 1
            self._block_sequence = FirstPGBlock.ID + str(parameter)
        else:
            raise ValueError(generate_method)
        while not self._tick():
            pass
        return self._global_network

    # -- FSM (reference BIG.py:79-176) -------------------------------------
    def _tick(self):
        if len(self.blocks) >= self.block_num and self.next_step == NextStep.forward:
            return True
        if self.next_step == NextStep.forward:
            self._forward()
        elif self.next_step == NextStep.destruct_current:
            self._destruct_current()
        elif self.next_step == NextStep.search_sibling:
            self._search_sibling()
        elif self.next_step == NextStep.back:
            self._go_back()
        return False

    def sample_block(self):
        if self._block_sequence is None:
            name = self.np_random.choice(self._block_names, p=self._block_probs)
            block_type = BLOCK_NAME_TO_CLASS[str(name)]
        else:
            type_id = self._block_sequence[len(self.blocks)]
            if type_id not in PG_BLOCKS:
                raise ValueError(f"Block type '{type_id}' not implemented yet (have {list(PG_BLOCKS)})")
            block_type = PG_BLOCKS[type_id]
        socket_idx = self.np_random.choice(self.blocks[-1].get_socket_indices())
        return block_type(
            len(self.blocks),
            self.blocks[-1].get_socket(socket_idx),
            self._global_network,
            self.np_random.randint(0, 10000),
        )

    # lane-count sanity bounds (reference BIG.construct, BIG.py:122-127 +
    # blocks_prob_dist.py:2-3)
    MIN_LANE_NUM = 1
    MAX_LANE_NUM = 5

    def _construct(self, block):
        ok = block.construct()
        lane_num = max(
            len(socket.get_positive_lanes(self._global_network))
            for socket in block.get_socket_list()
        ) if block.get_socket_list() else 0
        if lane_num < self.MIN_LANE_NUM or lane_num > self.MAX_LANE_NUM:
            ok = False
        return ok

    def _forward(self):
        block = self.sample_block()
        self.blocks.append(block)
        ok = self._construct(block)
        self.next_step = NextStep.forward if ok else NextStep.destruct_current

    def _destruct_current(self):
        block = self.blocks[-1]
        block.destruct()
        self.next_step = (
            NextStep.search_sibling if block.number_of_sample_trial < self.MAX_TRIAL else NextStep.back
        )

    def _search_sibling(self):
        block = self.blocks[-1]
        if len(self.blocks) == 1:
            self.next_step = NextStep.forward
            return
        if block.number_of_sample_trial < self.MAX_TRIAL:
            ok = self._construct(block)
            self.next_step = NextStep.forward if ok else NextStep.destruct_current
        else:
            self.next_step = NextStep.back

    def _go_back(self):
        self.blocks.pop()
        last = self.blocks[-1]
        last.destruct()
        self.next_step = NextStep.search_sibling


class CityBIG(BIG):
    """City-style growth (reference: component/map/city_map.py:26-95
    CityBIG): each new block attaches to a random UNUSED socket across ALL
    existing blocks (BIG always extends the last block), with MAX_TRIAL=2.
    The socket draw sorts candidates by the reference's socket-index string
    "{block_index}{ID}-socket{i}" (pg_block.py:30-35) so the np_random.choice
    consumes the stream identically."""

    MAX_TRIAL = 2

    def sample_block(self):
        if self._block_sequence is None:
            name = self.np_random.choice(self._block_names, p=self._block_probs)
            block_type = BLOCK_NAME_TO_CLASS[str(name)]
        else:
            type_id = self._block_sequence[len(self.blocks)]
            block_type = PG_BLOCKS[type_id]
        socket_used = set(
            id(block.pre_block_socket) for block in self.blocks[1:]
            if block.pre_block_socket is not None
        )
        socket_available = []
        for b in self.blocks:
            for i, s in enumerate(b.get_socket_list()):
                if id(s) in socket_used:
                    continue
                key = f"{b.block_index}{b.ID}-socket{i}"
                socket_available.append((key, s))
        socket_available.sort(key=lambda ks: ks[0])
        pick = self.np_random.choice(len(socket_available))
        socket = socket_available[int(pick)][1]
        return block_type(
            len(self.blocks),
            socket,
            self._global_network,
            self.np_random.randint(0, 10000),
        )


def generate_city_map(seed, map_config):
    """Build a city road network (reference CityMap._generate,
    city_map.py:97-113): CityBIG growth over the standard v2 distribution."""
    network = NodeRoadNetwork()
    big = CityBIG(
        lane_num=map_config.get("lane_num", 3),
        lane_width=map_config.get("lane_width", 3.5),
        global_network=network,
        exit_length=map_config.get("exit_length", 50.0),
        random_seed=seed,
    )
    cfg = map_config.get("config", 3)
    if isinstance(cfg, str):
        big.generate(BigGenerateMethod.BLOCK_SEQUENCE, cfg)
    else:
        big.generate(BigGenerateMethod.BLOCK_NUM, int(cfg))
    return network, big.blocks


def generate_map(seed, map_config):
    """Build the road network + block list for one scenario seed.

    map_config keys mirror the reference map_config
    (metadrive/envs/metadrive_env.py:26-32): type/config/lane_width/lane_num/
    exit_length.
    """
    if map_config.get("xodr_file"):
        from benchmarks.reference.mapgen.opendrive import generate_opendrive_map
        return generate_opendrive_map(map_config)
    if map_config.get("city_map"):
        return generate_city_map(seed, map_config)
    network = NodeRoadNetwork()
    custom = map_config.get("custom_blocks")
    if custom is not None:
        # Fixed block sequence with explicit per-block configs — the path the
        # reference's custom MARL maps take (e.g. MATollGateMap._generate,
        # envs/marl_envs/marl_tollgate.py:113-162: block.construct_block with
        # an explicit config dict instead of BIG sampling).
        blocks = [
            FirstPGBlock(
                network,
                map_config.get("lane_width", 3.5),
                map_config.get("lane_num", 3),
                length=map_config.get("exit_length", 50.0),
                remove_negative_lanes=map_config.get("remove_negative_lanes", False),
                center_line_type=map_config.get("center_line_type"),
                side_line_type=map_config.get("side_line_type"),
            )
        ]
        for spec in custom:
            cls = PG_BLOCKS[spec["id"]]
            block = cls(
                len(blocks),
                blocks[-1].get_socket(spec.get("socket_idx", 0)),
                network,
                random_seed=spec.get("random_seed", 1),
            )
            block.remove_negative_lanes = spec.get(
                "remove_negative_lanes", map_config.get("remove_negative_lanes", False)
            )
            block.center_line_override = spec.get(
                "center_line_type", map_config.get("center_line_type")
            )
            block.side_line_override = spec.get(
                "side_line_type", map_config.get("side_line_type")
            )
            if spec.get("u_turn"):
                # MAIntersectionMap.enable_u_turn (marl_intersection.py:61)
                block._enable_u_turn = True
            # custom maps are hand-authored; skip the sampling-time overlap
            # rejection (the reference passes explicit configs the same way)
            ok = block.construct(spec.get("config"), check_overlap=False)
            assert ok, f"custom block {spec['id']} failed to construct"
            blocks.append(block)
        return network, blocks
    big = BIG(
        lane_num=map_config.get("lane_num", 3),
        lane_width=map_config.get("lane_width", 3.5),
        global_network=network,
        exit_length=map_config.get("exit_length", 50.0),
        random_seed=seed,
    )
    cfg = map_config.get("config", 3)
    if isinstance(cfg, str):
        big.generate(BigGenerateMethod.BLOCK_SEQUENCE, cfg)
    else:
        big.generate(BigGenerateMethod.BLOCK_NUM, int(cfg))
    return network, big.blocks
