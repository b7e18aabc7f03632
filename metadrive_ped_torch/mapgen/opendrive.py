"""OpenDrive (.xodr) ingest, on the host (numpy).

The reference vendors a full OpenDrive object model (utils/opendrive/, ~2.5k
LoC) and wraps each lane section in an OpenDriveBlock over an
OpenDriveRoadNetwork (component/opendrive_block/opendrive_block.py,
road_network/edge_road_network.py; exercised by
tests/test_functionality/test_load_carla_town.py). This module is a
self-written minimal parser + compiler that maps OpenDrive geometry onto the
package's existing scene machinery: every driving lane is sampled along
the road reference line and compiled into a chain of short straight lanes in
a NodeRoadNetwork, so localization, navigation, IDM traffic, lidar and
observations all work on OpenDrive maps unchanged.

Supported subset (documented): plan-view geometries line / arc / spiral /
poly3 / paramPoly3 (spirals and polynomials sampled numerically), lane
offset and per-lane cubic width records, left/right driving lanes, one or
more lane sections, road-level successor/predecessor links with
contactPoint="start"/"end". Junction connecting roads parse like normal
roads; junction *objects*, elevation, and signal records are ignored.
"""
import math
import xml.etree.ElementTree as ET

import numpy as np

from metadrive_ped_torch.constants import LINE_BROKEN, LINE_SIDE
from metadrive_ped_torch.mapgen.lanes import HostStraightLane
from metadrive_ped_torch.mapgen.network import NodeRoadNetwork, Road

SAMPLE_DS = 4.0  # reference-line sampling step [m]

# A two-road map: a 100 m straight linked to a 90-degree arc of radius 50 m,
# each with one left and two right driving lanes of 3.5 m. The tests and
# chip_smoke.py drive it; write it to a file and pass the path as
# map_config.xodr_file.
TWO_ROAD_XODR = """<?xml version="1.0"?>
<OpenDRIVE>
  <header revMajor="1" revMinor="4"/>
  <road name="straight" length="100.0" id="1" junction="-1">
    <link><successor elementType="road" elementId="2" contactPoint="start"/></link>
    <planView>
      <geometry s="0" x="0" y="0" hdg="0" length="100.0"><line/></geometry>
    </planView>
    <lanes>
      <laneSection s="0">
        <left>
          <lane id="1" type="driving"><width sOffset="0" a="3.5" b="0" c="0" d="0"/></lane>
        </left>
        <center><lane id="0" type="none"/></center>
        <right>
          <lane id="-1" type="driving"><width sOffset="0" a="3.5" b="0" c="0" d="0"/></lane>
          <lane id="-2" type="driving"><width sOffset="0" a="3.5" b="0" c="0" d="0"/></lane>
        </right>
      </laneSection>
    </lanes>
  </road>
  <road name="bend" length="78.54" id="2" junction="-1">
    <link><predecessor elementType="road" elementId="1" contactPoint="end"/></link>
    <planView>
      <geometry s="0" x="100" y="0" hdg="0" length="78.54"><arc curvature="0.02"/></geometry>
    </planView>
    <lanes>
      <laneSection s="0">
        <left>
          <lane id="1" type="driving"><width sOffset="0" a="3.5" b="0" c="0" d="0"/></lane>
        </left>
        <center><lane id="0" type="none"/></center>
        <right>
          <lane id="-1" type="driving"><width sOffset="0" a="3.5" b="0" c="0" d="0"/></lane>
          <lane id="-2" type="driving"><width sOffset="0" a="3.5" b="0" c="0" d="0"/></lane>
        </right>
      </laneSection>
    </lanes>
  </road>
</OpenDRIVE>
"""


# ---------------------------------------------------------------- geometry
class _Geometry:
    def __init__(self, el):
        self.s0 = float(el.get("s"))
        self.x = float(el.get("x"))
        self.y = float(el.get("y"))
        self.hdg = float(el.get("hdg"))
        self.length = float(el.get("length"))
        self.kind = None
        self.params = {}
        for child in el:
            self.kind = child.tag
            self.params = {k: float(v) for k, v in child.attrib.items()}
        if self.kind is None:
            self.kind = "line"

    def eval(self, ds):
        """(x, y, heading) at arc length ds in [0, length]."""
        h0 = self.hdg
        if self.kind == "line":
            return self.x + ds * math.cos(h0), self.y + ds * math.sin(h0), h0
        if self.kind == "arc":
            k = self.params["curvature"]
            h = h0 + k * ds
            x = self.x + (math.sin(h) - math.sin(h0)) / k
            y = self.y - (math.cos(h) - math.cos(h0)) / k
            return x, y, h
        if self.kind == "spiral":
            k0 = self.params["curvStart"]
            k1 = self.params["curvEnd"]
            kdot = (k1 - k0) / self.length
            # numeric integration (Fresnel); fine at these step sizes
            n = max(2, int(ds / 0.5))
            ss = np.linspace(0.0, ds, n)
            hs = h0 + k0 * ss + 0.5 * kdot * ss ** 2
            x = self.x + np.trapezoid(np.cos(hs), ss)
            y = self.y + np.trapezoid(np.sin(hs), ss)
            h = h0 + k0 * ds + 0.5 * kdot * ds ** 2
            return float(x), float(y), float(h)
        if self.kind in ("poly3", "paramPoly3"):
            p = self.params
            if self.kind == "poly3":
                u = ds
                v = p["a"] + p["b"] * u + p["c"] * u ** 2 + p["d"] * u ** 3
                dv = p["b"] + 2 * p["c"] * u + 3 * p["d"] * u ** 2
                du = 1.0
            else:
                t = ds / self.length if p.get("pRange", 1.0) else ds
                u = p["aU"] + p["bU"] * t + p["cU"] * t ** 2 + p["dU"] * t ** 3
                v = p["aV"] + p["bV"] * t + p["cV"] * t ** 2 + p["dV"] * t ** 3
                du = p["bU"] + 2 * p["cU"] * t + 3 * p["dU"] * t ** 2
                dv = p["bV"] + 2 * p["cV"] * t + 3 * p["dV"] * t ** 2
            ch, sh = math.cos(h0), math.sin(h0)
            x = self.x + u * ch - v * sh
            y = self.y + u * sh + v * ch
            h = h0 + math.atan2(dv, du)
            return x, y, h
        raise ValueError(f"unsupported geometry '{self.kind}'")


def _poly3_at(records, s):
    """Evaluate the active cubic record (sOffset,a,b,c,d) list at s."""
    if not records:
        return 0.0
    active = records[0]
    for r in records:
        if r[0] <= s + 1e-9:
            active = r
        else:
            break
    so, a, b, c, d = active
    ds = s - so
    return a + b * ds + c * ds ** 2 + d * ds ** 3


class _Lane:
    def __init__(self, el):
        self.id = int(el.get("id"))
        self.type = el.get("type", "none")
        self.widths = [
            (
                float(w.get("sOffset", 0.0)), float(w.get("a", 0.0)),
                float(w.get("b", 0.0)), float(w.get("c", 0.0)), float(w.get("d", 0.0))
            )
            for w in el.findall("width")
        ]

    def width_at(self, s_in_section):
        return _poly3_at(self.widths, s_in_section)


class _RoadXodr:
    def __init__(self, el):
        self.id = el.get("id")
        self.length = float(el.get("length"))
        self.junction = el.get("junction", "-1")
        self.geoms = [_Geometry(g) for g in el.findall("planView/geometry")]
        self.lane_offset = [
            (
                float(o.get("s", 0.0)), float(o.get("a", 0.0)), float(o.get("b", 0.0)),
                float(o.get("c", 0.0)), float(o.get("d", 0.0))
            )
            for o in el.findall("lanes/laneOffset")
        ]
        self.sections = []
        sec_els = el.findall("lanes/laneSection")
        for i, sec in enumerate(sec_els):
            s_start = float(sec.get("s"))
            s_end = float(sec_els[i + 1].get("s")) if i + 1 < len(sec_els) else self.length
            left = [_Lane(l) for l in sec.findall("left/lane")]
            right = [_Lane(l) for l in sec.findall("right/lane")]
            self.sections.append((s_start, s_end, left, right))
        link = el.find("link")
        self.succ = self.pred = None
        if link is not None:
            s = link.find("successor")
            if s is not None and s.get("elementType") == "road":
                self.succ = (s.get("elementId"), s.get("contactPoint", "start"))
            p = link.find("predecessor")
            if p is not None and p.get("elementType") == "road":
                self.pred = (p.get("elementId"), p.get("contactPoint", "end"))

    def ref_line(self, s):
        """(x, y, heading) on the reference line at road arc length s."""
        g = self.geoms[0]
        for cand in self.geoms:
            if cand.s0 <= s + 1e-9:
                g = cand
            else:
                break
        return g.eval(min(s - g.s0, g.length))


def parse_xodr(path):
    root = ET.parse(path).getroot()
    return [_RoadXodr(el) for el in root.findall("road")]


# ---------------------------------------------------------------- compiler
def _lane_center_t(side_lanes, lane, s_sec, offset):
    """Lateral position of a lane's center: laneOffset +/- cumulative widths.
    side_lanes must be sorted from the center outwards."""
    t = offset
    sign = 1.0 if lane.id > 0 else -1.0
    for other in side_lanes:
        if abs(other.id) < abs(lane.id):
            t += sign * other.width_at(s_sec)
    return t + sign * lane.width_at(s_sec) / 2


def build_network_from_xodr(path):
    """Compile an .xodr file into (NodeRoadNetwork, spawn_road, info).

    Every driving lane becomes a chain of straight mini-lanes; opposite
    sides get opposite travel directions. Cross-road joins share node names
    per the road link records, so route search (BFS) spans the whole map.
    """
    roads = parse_xodr(path)
    network = NodeRoadNetwork()
    node_alias = {}

    def node(rid, sec, i):
        name = f"od{rid}s{sec}_{i}_"
        return node_alias.get(name, name)

    # pre-compute chain lengths to alias junction nodes between linked roads
    n_pts = {}
    for rd in roads:
        for si, (s0, s1, left, right) in enumerate(rd.sections):
            length = s1 - s0
            n = max(2, int(round(length / SAMPLE_DS)) + 1)
            n_pts[(rd.id, si)] = n
    for rd in roads:
        last_sec = len(rd.sections) - 1
        if rd.succ is not None:
            sid, contact = rd.succ
            if any(r.id == sid for r in roads):
                end_name = f"od{rd.id}s{last_sec}_{n_pts[(rd.id, last_sec)] - 1}_"
                if contact == "start":
                    node_alias[end_name] = f"od{sid}s0_0_"
                else:
                    other = next(r for r in roads if r.id == sid)
                    osec = len(other.sections) - 1
                    node_alias[end_name] = f"od{sid}s{osec}_{n_pts[(sid, osec)] - 1}_"

    lane_dir_left = {}  # (road,sec) -> ordered left lanes (center outwards)
    chains = []  # ordered mini-lane chains, one per (road, section, lane)
    for rd in roads:
        for si, (s0, s1, left, right) in enumerate(rd.sections):
            length = s1 - s0
            n = n_pts[(rd.id, si)]
            ss = np.linspace(s0, s1, n)
            ref = [rd.ref_line(min(s, rd.length - 1e-6)) for s in ss]
            offs = [_poly3_at(rd.lane_offset, s) for s in ss]
            left_sorted = sorted(
                [l for l in left if l.type == "driving"], key=lambda l: l.id
            )
            right_sorted = sorted(
                [l for l in right if l.type == "driving"], key=lambda l: -l.id
            )
            all_left = sorted(left, key=lambda l: l.id)
            all_right = sorted(right, key=lambda l: -l.id)

            def center_pt(lane, side_all, k):
                x, y, h = ref[k]
                t = _lane_center_t(side_all, lane, ss[k] - s0, offs[k])
                nx, ny = -math.sin(h), math.cos(h)  # left normal
                return np.array([x + t * nx, y + t * ny])

            r_chains = [[] for _ in right_sorted]
            l_chains = [[] for _ in left_sorted]
            for k in range(n - 1):
                a, b = node(rd.id, si, k), node(rd.id, si, k + 1)
                # right lanes drive along +s (index 0 = closest to center)
                for idx, lane in enumerate(right_sorted):
                    w = max(lane.width_at(ss[k] - s0), 0.5)
                    p0 = center_pt(lane, all_right, k)
                    p1 = center_pt(lane, all_right, k + 1)
                    lt = [
                        LINE_BROKEN,
                        LINE_SIDE if idx == len(right_sorted) - 1 else LINE_BROKEN,
                    ]
                    hl = HostStraightLane(p0, p1, w, lt)
                    network.add_lane(a, b, hl)
                    r_chains[idx].append(hl)
                # left lanes drive against +s (their own mini road chain)
                for idx, lane in enumerate(left_sorted):
                    w = max(lane.width_at(ss[k] - s0), 0.5)
                    p0 = center_pt(lane, all_left, k + 1)
                    p1 = center_pt(lane, all_left, k)
                    lt = [
                        LINE_BROKEN,
                        LINE_SIDE if idx == len(left_sorted) - 1 else LINE_BROKEN,
                    ]
                    hl = HostStraightLane(p0, p1, w, lt)
                    network.add_lane("-" + b, "-" + a, hl)
                    l_chains[idx].append(hl)
            lane_dir_left[(rd.id, si)] = left_sorted
            chains.extend(r_chains)
            chains.extend([list(reversed(c)) for c in l_chains])

    # spawn on the first road's first right-lane chain; destination = the
    # farthest reachable node (longest shortest-path)
    first = roads[0]
    spawn_road = Road(node(first.id, 0, 0), node(first.id, 0, 1))
    info = dict(num_roads=len(roads), chains=chains)
    return network, spawn_road, info


class _XodrBlockShim:
    """Just enough Block API for the scene compiler (spawn lanes, sockets)."""

    buildings = ()

    def __init__(self, network, spawn_road, dest_node):
        self._network = network
        self._spawn_road = spawn_road
        self._dest_node = dest_node
        pos = spawn_road

        class _Socket:
            positive_road = pos
            negative_road = -pos

        self.pre_block_socket = _Socket()

    def get_intermediate_spawn_lanes(self):
        lanes = []
        for start, ends in self._network.graph.items():
            for end, road_lanes in ends.items():
                lanes.append(road_lanes)
        return lanes

    def get_socket_list(self):
        dest = self._dest_node

        class _Socket:
            class positive_road:  # noqa: N801 — structural stand-in
                end_node = dest
        return [_Socket()]


def generate_opendrive_map(map_config):
    """generate_map-compatible entry: (network, blocks) from an .xodr file."""
    network, spawn_road, info = build_network_from_xodr(map_config["xodr_file"])
    # farthest reachable node from the spawn road = default destination
    dists = network.bfs_distances(spawn_road.start_node)
    dest = max(dists, key=dists.get) if dists else spawn_road.end_node
    shim = _XodrBlockShim(network, spawn_road, dest)
    # compile_scene picks these up when the user gave no explicit spawn_roads
    shim.xodr_spawn = [(spawn_road.start_node, spawn_road.end_node)]
    shim.xodr_dests = [[dest]]
    # traffic spawns along whole lane chains (mini-lanes are shorter than
    # the 10 m vehicle gap, so per-lane candidate generation would starve)
    shim.npc_chains = info["chains"]
    return network, [shim, shim]
