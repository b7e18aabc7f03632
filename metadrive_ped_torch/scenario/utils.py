"""Scenario dataset IO + scenario equality assertion.

Mirrors the reference's dataset layout (scenario/utils.py:324-397):
a directory with ``dataset_summary.pkl`` (ordered dict: filename ->
metadata), optional ``dataset_mapping.pkl`` (filename -> relative dir), and
one pickled ScenarioDescription per file.
"""
import os
import pickle

import numpy as np

from metadrive_ped_torch.scenario.description import ScenarioDescription as SD

NP_ARRAY_DECIMAL = 3
VELOCITY_DECIMAL = 1  # velocity can have larger error
MIN_LENGTH_RATIO = 0.8


def _wrap_to_pi(x):
    return (np.asarray(x) + np.pi) % (2 * np.pi) - np.pi


def assert_scenario_equal(scenarios1, scenarios2, only_compare_sdc=False,
                          check_self_type=True):
    """Assert two {id: SD} dicts describe the same episodes
    (reference: scenario/utils.py:403-500 assert_scenario_equal): both pass
    sanity_check, same ids, and per-track position/heading/velocity arrays
    agree to NP_ARRAY_DECIMAL/VELOCITY_DECIMAL over the shared prefix."""
    assert set(scenarios1.keys()) == set(scenarios2.keys())
    for sid in scenarios1.keys():
        old, new = SD(dict(scenarios1[sid])), SD(dict(scenarios2[sid]))
        SD.sanity_check(old)
        SD.sanity_check(new)
        assert old[SD.LENGTH] >= new[SD.LENGTH], (old[SD.LENGTH], new[SD.LENGTH])

        if only_compare_sdc:
            ids = [(old[SD.METADATA][SD.SDC_ID], new[SD.METADATA][SD.SDC_ID])]
        else:
            assert len(old[SD.TRACKS]) == len(new[SD.TRACKS]), "obj num mismatch"
            ids = [
                (tid, tid) for tid in old[SD.TRACKS]
                if tid in new[SD.TRACKS] and tid != new[SD.METADATA][SD.SDC_ID]
            ]
            if only_compare_sdc is False and not ids:
                ids = [(old[SD.METADATA][SD.SDC_ID], new[SD.METADATA][SD.SDC_ID])]

        for tid1, tid2 in ids:
            st1 = old[SD.TRACKS][tid1][SD.STATE]
            st2 = new[SD.TRACKS][tid2][SD.STATE]
            min_len = min(len(st1[SD.POSITION]), len(st2[SD.POSITION]))
            max_len = max(len(st1[SD.POSITION]), len(st2[SD.POSITION]))
            assert min_len / max_len > MIN_LENGTH_RATIO, (
                f"track length ratio {min_len / max_len}"
            )
            for k in st1.keys():
                if k in ("action", "throttle_brake", "steering") or k not in st2:
                    continue
                a1 = np.asarray(st1[k][:min_len], np.float64)
                a2 = np.asarray(st2[k][:min_len], np.float64)
                if k == SD.POSITION:
                    np.testing.assert_almost_equal(
                        a1[..., :2], a2[..., :2], decimal=NP_ARRAY_DECIMAL
                    )
                elif k == SD.HEADING:
                    np.testing.assert_almost_equal(
                        _wrap_to_pi(a1 - a2), np.zeros(a1.shape),
                        decimal=NP_ARRAY_DECIMAL
                    )
                elif k == SD.VELOCITY:
                    np.testing.assert_almost_equal(a1, a2, decimal=VELOCITY_DECIMAL)
            assert old[SD.TRACKS][tid1][SD.TYPE] == new[SD.TRACKS][tid2][SD.TYPE]

SUMMARY_FILE = "dataset_summary.pkl"
MAPPING_FILE = "dataset_mapping.pkl"


def read_dataset_summary(directory):
    """Returns (summary_dict, sorted_scenario_ids, mapping)."""
    with open(os.path.join(directory, SUMMARY_FILE), "rb") as f:
        summary = pickle.load(f)
    mapping_path = os.path.join(directory, MAPPING_FILE)
    if os.path.exists(mapping_path):
        with open(mapping_path, "rb") as f:
            mapping = pickle.load(f)
    else:
        mapping = {k: "" for k in summary}
    return summary, list(summary.keys()), mapping


def read_scenario_data(path):
    with open(path, "rb") as f:
        sd = pickle.load(f)
    return SD(sd)


def load_scenarios(directory, start_index=0, num=None, worker_index=0, num_workers=1):
    """Load a dataset slice with the reference's multi-worker striding
    (manager/scenario_data_manager.py:26-32):
    indices = range(start + worker_index, start + num, num_workers)."""
    summary, ids, mapping = read_dataset_summary(directory)
    num = num if num is not None else len(ids) - start_index
    indices = range(start_index + worker_index, start_index + num, num_workers)
    out = []
    for i in indices:
        fname = ids[i]
        out.append(read_scenario_data(os.path.join(directory, mapping.get(fname, ""), fname)))
    return out


def save_dataset(scenarios, directory):
    """Write ScenarioDescriptions as a loadable dataset directory."""
    os.makedirs(directory, exist_ok=True)
    summary, mapping = {}, {}
    for i, sd in enumerate(scenarios):
        fname = f"sd_{i}.pkl"
        # dataset summaries travel with each scenario's metadata
        # (scenario_description.py update_summaries; the reference writes
        # them into dataset_summary.pkl for fast filtering)
        SD.update_summaries(sd)
        with open(os.path.join(directory, fname), "wb") as f:
            pickle.dump(dict(sd), f)
        summary[fname] = dict(sd[SD.METADATA])
        summary[fname].update({"length": sd[SD.LENGTH], "id": sd[SD.ID]})
        mapping[fname] = ""
    with open(os.path.join(directory, SUMMARY_FILE), "wb") as f:
        pickle.dump(summary, f)
    with open(os.path.join(directory, MAPPING_FILE), "wb") as f:
        pickle.dump(mapping, f)
    return directory


def draw_map(map_features, show=False, save_path=None):
    """Matplotlib scatter of lane centerlines and road edges
    (scenario/utils.py:25-35 draw_map; the export-map workflow of
    tests/test_functionality/test_export_map.py). Host code: it draws the
    numpy polylines of ``map_features`` with the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6), dpi=200)
    for value in map_features.values():
        poly = np.asarray(value.get("polyline", []))
        if poly.ndim != 2 or not len(poly):
            continue
        if "LANE" in str(value.get("type", "")).upper():
            plt.scatter(poly[:, 0], poly[:, 1], s=0.1)
        else:
            plt.scatter(poly[:, 0], poly[:, 1], s=0.1, c="k")
    plt.gca().set_aspect("equal")
    if save_path:
        plt.savefig(save_path)
    if show:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)
    return fig
