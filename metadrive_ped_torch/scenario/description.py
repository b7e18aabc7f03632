"""ScenarioDescription — the nested-dict scenario data schema.

Key names and nesting mirror the reference exactly
(metadrive/scenario/scenario_description.py:124-200) so datasets produced by
either implementation interoperate: top level {tracks, version, id,
dynamic_map_states, map_features, length, metadata}; each track
{type, state{position[T,3], heading[T], velocity[T,2], valid[T], length,
width, height}, metadata}.
"""
import numpy as np


class ScenarioDescription(dict):
    TRACKS = "tracks"
    VERSION = "version"
    ID = "id"
    DYNAMIC_MAP_STATES = "dynamic_map_states"
    MAP_FEATURES = "map_features"
    LENGTH = "length"
    METADATA = "metadata"
    FIRST_LEVEL_KEYS = {TRACKS, VERSION, ID, DYNAMIC_MAP_STATES, MAP_FEATURES, LENGTH, METADATA}

    TYPE = "type"
    STATE = "state"
    STATE_DICT_KEYS = {TYPE, STATE, METADATA}

    POSITION = "position"
    HEADING = "heading"
    VELOCITY = "velocity"
    VALID = "valid"

    METADRIVE_PROCESSED = "metadrive_processed"
    COORDINATE = "coordinate"
    TIMESTEP = "ts"
    METADATA_KEYS = {METADRIVE_PROCESSED, COORDINATE, TIMESTEP}

    SDC_ID = "sdc_id"
    OBJECT_ID = "object_id"
    POLYLINE = "polyline"
    # map-feature lane adjacency (scenario_description.py:138-145) — the
    # raw-map representation EdgeRoadNetwork consumes
    POLYGON = "polygon"
    LEFT_BOUNDARIES = "left_boundaries"
    RIGHT_BOUNDARIES = "right_boundaries"
    LEFT_NEIGHBORS = "left_neighbor"
    RIGHT_NEIGHBORS = "right_neighbor"
    ENTRY = "entry_lanes"
    EXIT = "exit_lanes"

    COORDINATE_METADRIVE = "metadrive"

    class SUMMARY:
        # key names mirror the reference (scenario_description.py:169-196)
        # so summaries written here are readable by reference tooling
        OBJECT_SUMMARY = "object_summary"
        NUMBER_SUMMARY = "number_summary"
        TYPE = "type"
        OBJECT_ID = "object_id"
        TRACK_LENGTH = "track_length"
        MOVING_DIST = "moving_distance"
        VALID_LENGTH = "valid_length"
        CONTINUOUS_VALID_LENGTH = "continuous_valid_length"
        OBJECT_TYPES = "object_types"
        NUM_OBJECTS = "num_objects"
        NUM_MOVING_OBJECTS = "num_moving_objects"
        NUM_OBJECTS_EACH_TYPE = "num_objects_each_type"
        NUM_MOVING_OBJECTS_EACH_TYPE = "num_moving_objects_each_type"
        NUM_TRAFFIC_LIGHTS = "num_traffic_lights"
        NUM_TRAFFIC_LIGHT_TYPES = "num_traffic_light_types"
        NUM_TRAFFIC_LIGHTS_EACH_STEP = "num_traffic_light_each_step"
        NUM_MAP_FEATURES = "num_map_features"

    # native python / numpy types allowed anywhere in an SD (the reference
    # guards pickle portability the same way, scenario_description.py:226)
    ALLOW_TYPES = (int, float, str, np.ndarray, dict, list, tuple, type(None), bool,
                   set, np.bool_, np.integer, np.floating)

    @classmethod
    def sanity_check(cls, d, check_self_type=False, valid_check=False):
        """Full schema/shape/type validation, mirroring the reference's
        matrix (scenario_description.py:200-322): first-level keys,
        recursive type whitelist, per-track state-array temporal
        consistency + optional valid-masking check, dynamic map states,
        map-feature lane polylines, metadata keys and object_id alignment.
        """
        if check_self_type:
            assert isinstance(d, dict)
            assert not isinstance(d, ScenarioDescription)
        assert cls.FIRST_LEVEL_KEYS.issubset(d.keys()), (
            f"missing keys: {cls.FIRST_LEVEL_KEYS - set(d.keys())}"
        )
        _recursive_check_type(d, cls.ALLOW_TYPES)
        T = d[cls.LENGTH]

        assert isinstance(d[cls.TRACKS], dict)
        for obj_id, tr in d[cls.TRACKS].items():
            cls._check_object_state_dict(tr, T, obj_id, valid_check=valid_check)
            assert cls.HEADING in tr[cls.STATE], "heading is required for an object"
            assert cls.POSITION in tr[cls.STATE], "position is required for an object"
            st = tr[cls.STATE]
            assert np.asarray(st[cls.POSITION]).shape == (T, 3), obj_id
            assert np.asarray(st[cls.HEADING]).shape == (T,), obj_id
            assert np.asarray(st[cls.VELOCITY]).shape == (T, 2), obj_id
            assert np.asarray(st[cls.VALID]).shape == (T,), obj_id

        assert isinstance(d[cls.DYNAMIC_MAP_STATES], dict)
        for obj_id, tr in d[cls.DYNAMIC_MAP_STATES].items():
            cls._check_object_state_dict(tr, T, obj_id, valid_check=False)

        assert isinstance(d[cls.MAP_FEATURES], dict)
        cls._check_map_features(d[cls.MAP_FEATURES])

        md = d[cls.METADATA]
        assert isinstance(md, dict)
        assert cls.METADATA_KEYS.issubset(md.keys()), (
            f"missing metadata keys: {cls.METADATA_KEYS - set(md.keys())}"
        )
        assert np.asarray(md[cls.TIMESTEP]).shape == (T,)
        return True

    # ---- dataset summaries (scenario_description.py:342-530) -------------
    @classmethod
    def get_object_summary(cls, object_dict, object_id):
        """Per-track stats: type, moving distance over valid frames, valid
        length, and the first continuous-valid run length."""
        state = object_dict[cls.STATE]
        valid = np.asarray(state[cls.VALID]).astype(bool)
        track = np.asarray(state[cls.POSITION])[valid][..., :2]
        dist = float(np.linalg.norm(np.diff(track, axis=0), axis=-1).sum()) \
            if len(track) > 1 else 0.0
        cont = 0
        for v in valid:
            if v:
                cont += 1
            elif cont > 0:
                break
        return {
            cls.SUMMARY.TYPE: object_dict[cls.TYPE],
            cls.SUMMARY.OBJECT_ID: object_id,
            cls.SUMMARY.TRACK_LENGTH: int(len(valid)),
            cls.SUMMARY.MOVING_DIST: dist,
            cls.SUMMARY.VALID_LENGTH: int(valid.sum()),
            cls.SUMMARY.CONTINUOUS_VALID_LENGTH: int(cont),
        }

    @classmethod
    def get_number_summary(cls, d):
        """Scenario-level counts: objects (total / per type / moving),
        traffic-light states, map features."""
        S = cls.SUMMARY
        tracks = d[cls.TRACKS]
        out = {
            S.NUM_OBJECTS: len(tracks),
            S.OBJECT_TYPES: {v[cls.TYPE] for v in tracks.values()},
        }
        per_type, moving, moving_type = {}, 0, {}
        for tid, tr in tracks.items():
            t = tr[cls.TYPE]
            per_type[t] = per_type.get(t, 0) + 1
            if cls.get_object_summary(tr, tid)[S.MOVING_DIST] > 1:
                moving += 1
                moving_type[t] = moving_type.get(t, 0) + 1
        out[S.NUM_OBJECTS_EACH_TYPE] = per_type
        out[S.NUM_MOVING_OBJECTS] = moving
        out[S.NUM_MOVING_OBJECTS_EACH_TYPE] = moving_type
        light_types, light_steps = set(), {}
        for v in (d.get(cls.DYNAMIC_MAP_STATES) or {}).values():
            for st in v.get(cls.STATE, {}).get("object_state", []):
                if st is None:
                    continue
                light_types.add(st)
                light_steps[st] = light_steps.get(st, 0) + 1
        out[S.NUM_TRAFFIC_LIGHTS] = len(d.get(cls.DYNAMIC_MAP_STATES) or {})
        out[S.NUM_TRAFFIC_LIGHT_TYPES] = light_types
        out[S.NUM_TRAFFIC_LIGHTS_EACH_STEP] = light_steps
        out[S.NUM_MAP_FEATURES] = len(d.get(cls.MAP_FEATURES) or {})
        return out

    @classmethod
    def update_summaries(cls, d):
        """Write object_summary + number_summary into d['metadata'] in
        place (scenario_description.py:418-437) and return d."""
        S = cls.SUMMARY
        d[cls.METADATA][S.OBJECT_SUMMARY] = {
            tid: cls.get_object_summary(tr, tid)
            for tid, tr in d[cls.TRACKS].items()
        }
        d[cls.METADATA][S.NUMBER_SUMMARY] = cls.get_number_summary(d)
        return d

    @classmethod
    def sdc_moving_dist(cls, d):
        """Moving distance of the sdc — the standard dataset filter
        (scenario_description.py:503-524)."""
        sdc_id = str(d[cls.METADATA][cls.SDC_ID])
        return cls.get_object_summary(
            d[cls.TRACKS][sdc_id], sdc_id
        )[cls.SUMMARY.MOVING_DIST]

    @classmethod
    def _check_map_features(cls, map_features):
        """Every lane feature must carry a centerline polyline
        (scenario_description.py:260-268)."""
        for fid, feat in map_features.items():
            if MetaDriveType.is_lane(feat[cls.TYPE]):
                assert cls.POLYLINE in feat, f"no lane center line in {fid}"
                assert isinstance(feat[cls.POLYLINE], (np.ndarray, list, tuple))

    @classmethod
    def _check_object_state_dict(cls, obj_state, T, object_id, valid_check=True):
        """Per-object state dict checks (scenario_description.py:272-318)."""
        assert set(obj_state).issuperset(cls.STATE_DICT_KEYS)
        assert MetaDriveType.has_type(obj_state[cls.TYPE]), (
            f"unknown MetaDriveType: {obj_state[cls.TYPE]}"
        )
        assert isinstance(obj_state[cls.STATE], dict)
        for state_key, arr in obj_state[cls.STATE].items():
            assert isinstance(arr, (np.ndarray, list, tuple)), (object_id, state_key)
            assert len(arr) == T, (object_id, state_key, len(arr), T)
            if not isinstance(arr, np.ndarray):
                continue
            assert arr.ndim in (1, 2), (object_id, state_key, arr.ndim)
            if arr.ndim == 2:
                assert arr.shape[1] != 0, "convert 1-wide state to a 1D array"
            if valid_check and state_key == cls.VALID:
                assert np.sum(arr) >= 1, f"{object_id} never valid; remove it"
            if valid_check and cls.VALID in obj_state[cls.STATE]:
                _a = arr[..., :2] if state_key == cls.POSITION else arr
                invalid = ~np.asarray(obj_state[cls.STATE][cls.VALID], bool)
                if _a.dtype.kind == "f":
                    assert abs(np.sum(_a[invalid])) < 1e-2, (
                        f"{state_key} non-zero on invalid frames of {object_id}"
                    )
        assert isinstance(obj_state[cls.METADATA], dict)
        for k in (cls.TYPE, cls.OBJECT_ID):
            assert k in obj_state[cls.METADATA], (object_id, k)
        assert obj_state[cls.METADATA][cls.OBJECT_ID] == object_id


def _recursive_check_type(obj, allow_types, depth=0):
    assert isinstance(obj, allow_types), f"disallowed type in SD: {type(obj)}"
    assert depth < 1000, "recursion too deep (cycle?)"
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert isinstance(k, (str, int)), f"bad dict key type {type(k)}"
            _recursive_check_type(v, allow_types, depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _recursive_check_type(v, allow_types, depth + 1)


# MetaDriveType object/lane/line type strings shared with the ScenarioNet
# data format (reference: metadrive/type.py)
class MetaDriveType:
    UNSET = "UNSET"
    VEHICLE = "VEHICLE"
    PEDESTRIAN = "PEDESTRIAN"
    CYCLIST = "CYCLIST"
    OTHER = "OTHER"
    TRAFFIC_CONE = "TRAFFIC_CONE"
    TRAFFIC_BARRIER = "TRAFFIC_BARRIER"
    TRAFFIC_OBJECT = "TRAFFIC_OBJECT"
    TRAFFIC_LIGHT = "TRAFFIC_LIGHT"
    BUILDING = "BUILDING"
    LANE_SURFACE_STREET = "LANE_SURFACE_STREET"
    LANE_SURFACE_UNSTRUCTURE = "LANE_SURFACE_UNSTRUCTURE"
    LANE_UNKNOWN = "LANE_UNKNOWN"
    LANE_FREEWAY = "LANE_FREEWAY"
    LANE_BIKE_LANE = "LANE_BIKE_LANE"
    LINE_UNKNOWN = "UNKNOWN_LINE"
    LINE_BROKEN_SINGLE_WHITE = "ROAD_LINE_BROKEN_SINGLE_WHITE"
    LINE_SOLID_SINGLE_WHITE = "ROAD_LINE_SOLID_SINGLE_WHITE"
    LINE_SOLID_DOUBLE_WHITE = "ROAD_LINE_SOLID_DOUBLE_WHITE"
    LINE_BROKEN_SINGLE_YELLOW = "ROAD_LINE_BROKEN_SINGLE_YELLOW"
    LINE_BROKEN_DOUBLE_YELLOW = "ROAD_LINE_BROKEN_DOUBLE_YELLOW"
    LINE_SOLID_SINGLE_YELLOW = "ROAD_LINE_SOLID_SINGLE_YELLOW"
    LINE_SOLID_DOUBLE_YELLOW = "ROAD_LINE_SOLID_DOUBLE_YELLOW"
    LINE_PASSING_DOUBLE_YELLOW = "ROAD_LINE_PASSING_DOUBLE_YELLOW"
    BOUNDARY_LINE = "ROAD_EDGE_BOUNDARY"
    BOUNDARY_MEDIAN = "ROAD_EDGE_MEDIAN"
    BOUNDARY_SIDEWALK = "ROAD_EDGE_SIDEWALK"
    STOP_SIGN = "STOP_SIGN"
    CROSSWALK = "CROSSWALK"
    SPEED_BUMP = "SPEED_BUMP"
    DRIVEWAY = "DRIVEWAY"
    GROUND = "GROUND"

    # traffic light states (metadrive/type.py LIGHT_*)
    LIGHT_GREEN = "TRAFFIC_LIGHT_GREEN"
    LIGHT_RED = "TRAFFIC_LIGHT_RED"
    LIGHT_YELLOW = "TRAFFIC_LIGHT_YELLOW"
    LIGHT_UNKNOWN = "TRAFFIC_LIGHT_UNKNOWN"

    @classmethod
    def has_type(cls, type_string):
        return isinstance(type_string, str) and type_string in {
            v for k, v in vars(cls).items() if isinstance(v, str) and not k.startswith("_")
        }

    @classmethod
    def is_lane(cls, type_string):
        return type_string in (
            cls.LANE_SURFACE_STREET, cls.LANE_SURFACE_UNSTRUCTURE,
            cls.LANE_UNKNOWN, cls.LANE_FREEWAY, cls.LANE_BIKE_LANE,
        )

    @classmethod
    def is_vehicle(cls, type_string):
        return type_string == cls.VEHICLE

    @classmethod
    def is_participant(cls, type_string):
        return type_string in (cls.PEDESTRIAN, cls.CYCLIST)
