"""Edge-based road network for raw (scenario) maps.

The reference keeps TWO road-network representations: NodeRoadNetwork for
procedural maps (lanes grouped by (from_node, to_node) roads) and
EdgeRoadNetwork for real-map scenarios
(component/road_network/edge_road_network.py:14-120), where each lane is an
edge keyed by its feature id and adjacency comes straight from the map
data's entry/exit/neighbor lists (scenario_lane.py:51-54).

This is host-side, compile-time infrastructure: route/BFS queries run in
Python over the ScenarioDescription's map_features; the hot path consumes
the compiled lane arrays (mapgen/scenario_scene.py), not this graph.
"""
from collections import namedtuple

import numpy as np

from metadrive_ped_torch.scenario.description import ScenarioDescription as SD

lane_info = namedtuple(
    "edge_lane", ["lane", "entry_lanes", "exit_lanes", "left_lanes", "right_lanes"]
)

# MetaDriveType.is_lane strings (see mapgen/scenario_scene.py _LANE_TYPES)
_LANE_TYPES = {
    "LANE_SURFACE_STREET", "LANE_SURFACE_UNSTRUCTURE", "LANE_UNKNOWN",
    "LANE_BIKE_LANE", "LANE_FREEWAY",
}


def _neighbor_id(n):
    """Neighbor entries are raw ids or dicts with id/feature_id
    (scenario datasets vary; edge_road_network.py:93 uses n['id'])."""
    if isinstance(n, dict):
        return n.get("id", n.get("feature_id"))
    return n


class ScenarioLaneRec:
    """Lightweight host-side lane: the polyline + adjacency of one lane map
    feature (the role of ScenarioLane, component/lane/scenario_lane.py:23-54,
    without a physics body)."""

    def __init__(self, feature_id, feature, default_width=6.0):
        self.index = feature_id
        pts = np.asarray(feature[SD.POLYLINE], np.float32)[:, :2]
        self.polyline = pts
        d = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        self._arc = np.concatenate([[0.0], np.cumsum(d)])
        self.length = float(self._arc[-1])
        self.width = float(feature.get("width", default_width))
        self.entry_lanes = [
            _neighbor_id(n) for n in (feature.get(SD.ENTRY) or [])
        ]
        self.exit_lanes = [
            _neighbor_id(n) for n in (feature.get(SD.EXIT) or [])
        ]
        self.left_lanes = list(feature.get(SD.LEFT_NEIGHBORS) or [])
        self.right_lanes = list(feature.get(SD.RIGHT_NEIGHBORS) or [])

    def position(self, longitudinal, lateral=0.0):
        """World point at arc length (+ right-lateral offset)."""
        s = np.clip(longitudinal, 0.0, self.length)
        i = int(np.clip(np.searchsorted(self._arc, s) - 1, 0, len(self._arc) - 2))
        span = max(self._arc[i + 1] - self._arc[i], 1e-9)
        t = (s - self._arc[i]) / span
        p = self.polyline[i] * (1 - t) + self.polyline[i + 1] * t
        if lateral:
            d = self.polyline[i + 1] - self.polyline[i]
            d = d / max(np.linalg.norm(d), 1e-9)
            p = p + lateral * np.array([d[1], -d[0]])
        return p

    def local_coordinates(self, point):
        """(long, lat) of the nearest-segment projection (lat > 0 right)."""
        p = np.asarray(point, np.float32)[:2]
        a, b = self.polyline[:-1], self.polyline[1:]
        seg = b - a
        ln2 = np.maximum((seg ** 2).sum(-1), 1e-9)
        t = np.clip(((p - a) * seg).sum(-1) / ln2, 0.0, 1.0)
        proj = a + t[:, None] * seg
        d2 = ((p - proj) ** 2).sum(-1)
        i = int(np.argmin(d2))
        long = self._arc[i] + t[i] * np.sqrt(ln2[i])
        rel = p - a[i]
        cross = seg[i, 0] * rel[1] - seg[i, 1] * rel[0]
        lat = np.sqrt(max(d2[i], 0.0))
        return float(long), float(-lat if cross > 0 else lat)

    def get_bounding_box(self):
        return (
            float(self.polyline[:, 0].max()), float(self.polyline[:, 0].min()),
            float(self.polyline[:, 1].max()), float(self.polyline[:, 1].min()),
        )


class EdgeRoadNetwork:
    """Lane-indexed graph with entry/exit/neighbor adjacency
    (edge_road_network.py:14-97 semantics)."""

    def __init__(self):
        self.graph = {}

    def add_lane(self, lane):
        assert lane.index is not None, "Lane index can not be None"
        self.graph[lane.index] = lane_info(
            lane=lane, entry_lanes=lane.entry_lanes, exit_lanes=lane.exit_lanes,
            left_lanes=lane.left_lanes, right_lanes=lane.right_lanes,
        )

    def get_lane(self, index):
        return self.graph[index].lane

    def add(self, other, no_intersect=True):
        for lid in other.graph:
            if no_intersect:
                assert lid not in self.graph, f"Intersect: {lid} exists in two networks"
            self.graph[lid] = other.graph[lid]
        return self

    def __isub__(self, other):
        for lid in other.graph:
            self.graph.pop(lid)
        return self

    def get_bounding_box(self):
        boxes = [info.lane.get_bounding_box() for info in self.graph.values()]
        xs_max, xs_min, ys_max, ys_min = zip(*boxes)
        return min(xs_min), max(xs_max), min(ys_min), max(ys_max)

    def shortest_path(self, start, goal):
        return next(self.bfs_paths(start, goal), [])

    def bfs_paths(self, start, goal):
        """BFS over exit_lanes, seeded with the start lane AND its immediate
        left/right neighbors (edge_road_network.py:72-87).

        Divergence: seed lanes whose ids are missing from the graph are
        silently dropped (``if lane in self.graph``), whereas the reference
        yields [] for an unknown lane — and then KeyErrors in its own
        neighbor expansion. On well-formed maps both agree; on
        malformed/partial data this version stays robust instead of
        reproducing the reference's crash."""
        seeds = [
            _neighbor_id(n) for n in
            self.graph[start].left_lanes + self.graph[start].right_lanes
        ] + [start]
        queue = [(lane, [lane]) for lane in seeds if lane in self.graph]
        while queue:
            lane, path = queue.pop(0)
            for nxt in set(self.graph[lane].exit_lanes):
                if nxt in path:
                    continue  # circle
                if nxt == goal:
                    yield path + [nxt]
                elif nxt in self.graph:
                    queue.append((nxt, path + [nxt]))

    def get_peer_lanes_from_index(self, lane_index):
        info = self.graph[lane_index]
        ret = [info.lane]
        for n in info.left_lanes + info.right_lanes:
            nid = _neighbor_id(n)
            if nid in self.graph:
                ret.append(self.graph[nid].lane)
        return ret

    def get_map_features(self, interval=2.0):
        """Back to SD map_features dicts (edge_road_network.py:114-120)."""
        ret = {}
        for lid, info in self.graph.items():
            n = max(int(info.lane.length // interval) + 2, 2)
            ss = np.linspace(0.0, info.lane.length, n)
            ret[lid] = {
                SD.POLYLINE: np.stack([info.lane.position(s) for s in ss]),
                "width": info.lane.width,
                SD.ENTRY: info.entry_lanes,
                SD.EXIT: info.exit_lanes,
                SD.LEFT_NEIGHBORS: info.left_lanes,
                SD.RIGHT_NEIGHBORS: info.right_lanes,
                "type": "LANE_SURFACE_STREET",
            }
        return ret


def build_edge_network(sd, default_width=6.0):
    """EdgeRoadNetwork from one ScenarioDescription's lane features."""
    net = EdgeRoadNetwork()
    for fid, feat in (sd.get(SD.MAP_FEATURES) or {}).items():
        if str(feat.get("type", "")).upper() in _LANE_TYPES:
            line = np.asarray(feat.get(SD.POLYLINE, []), np.float32)
            if line.ndim == 2 and len(line) >= 2:
                net.add_lane(ScenarioLaneRec(fid, feat, default_width))
    return net
