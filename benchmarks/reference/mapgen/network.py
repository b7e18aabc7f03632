"""Host-side node road network.

Mirrors the reference's NodeRoadNetwork
(metadrive/component/road_network/node_road_network.py): ``graph[start][end]``
is the ordered lane list of a road; roads come in +/- pairs with the
"-node" negative-direction naming convention
(metadrive/component/road_network/road.py:10-40).
"""
import math
from collections import deque


class Road:
    def __init__(self, start_node, end_node):
        self.start_node = start_node
        self.end_node = end_node

    def is_negative_road(self):
        return self.start_node.startswith("-")

    def __neg__(self):
        def flip(n):
            return n[1:] if n.startswith("-") else "-" + n
        return Road(flip(self.end_node), flip(self.start_node))

    def get_lanes(self, network):
        return network.graph[self.start_node][self.end_node]

    def key(self):
        return (self.start_node, self.end_node)

    def __eq__(self, other):
        return isinstance(other, Road) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"Road({self.start_node} -> {self.end_node})"


class NodeRoadNetwork:
    def __init__(self):
        self.graph = {}

    def add_lane(self, start_node, end_node, lane):
        lanes = self.graph.setdefault(start_node, {}).setdefault(end_node, [])
        lane.index = (start_node, end_node, len(lanes))
        lanes.append(lane)

    def add(self, other):
        """Merge another network (reference: node_road_network.py add/+=)."""
        for start, ends in other.graph.items():
            for end, lanes in ends.items():
                target = self.graph.setdefault(start, {}).setdefault(end, [])
                for lane in lanes:
                    lane.index = (start, end, len(target))
                    target.append(lane)

    def get_lane(self, index):
        return self.graph[index[0]][index[1]][index[2]]

    def has_connection(self, lane_index1, lane_index2):
        """True iff lane1's road ends where lane2's road starts."""
        return lane_index1[1] == lane_index2[0]

    def roads(self, include_negative=True):
        for start, ends in self.graph.items():
            for end in ends:
                if not include_negative and start.startswith("-"):
                    continue
                yield Road(start, end)

    def bfs_paths(self, start, goal):
        """All BFS paths start→goal node (reference: node_road_network.py:242-255)."""
        queue = deque([(start, [start])])
        while queue:
            (vertex, path) = queue.popleft()
            for nxt in set(self.graph.get(vertex, {}).keys()) - set(path):
                if nxt == goal:
                    yield path + [nxt]
                elif nxt in self.graph:
                    queue.append((nxt, path + [nxt]))

    def bfs_distances(self, start):
        """Hop count from ``start`` to every reachable node."""
        dist = {start: 0}
        queue = deque([start])
        while queue:
            v = queue.popleft()
            for nxt in self.graph.get(v, {}):
                if nxt not in dist:
                    dist[nxt] = dist[v] + 1
                    queue.append(nxt)
        return dist

    def shortest_path(self, current_lane_index, destination_node):
        """Shortest node path from the current lane's road to destination
        (reference: node_road_network.py:257-261 — first BFS result)."""
        start_node = current_lane_index[0]
        return next(self.bfs_paths(start_node, destination_node), [])

    def remove_road(self, road):
        lanes = self.graph.get(road.start_node, {}).pop(road.end_node, [])
        if road.start_node in self.graph and not self.graph[road.start_node]:
            self.graph.pop(road.start_node)
        return lanes

    def remove_all_roads(self, start_node, end_node):
        """Remove every road on every path start->end
        (reference: node_road_network.py:172-184)."""
        removed = []
        for path in list(self.bfs_paths(start_node, end_node)):
            for a, b in zip(path[:-1], path[1:]):
                removed += self.remove_road(Road(a, b))
        return removed

    def get_closest_lane_index(self, position):
        """L1-closest lane (reference GraphLookupTable.get,
        node_road_network.py:19-65 — uses |lat| + overflow distance)."""
        best, best_dist = None, math.inf
        for start, ends in self.graph.items():
            for end, lanes in ends.items():
                for lane in lanes:
                    d = lane.distance(position)
                    if d < best_dist:
                        best, best_dist = lane.index, d
        return best, best_dist
