"""The benchmark's test fixtures."""
import pytest

from benchmarks import harness


@pytest.fixture
def new_files(tmp_path, monkeypatch):
    """A benchmark folder under ``tmp_path`` that the harness reads in place
    of its own: every file of its data folders, linked, beside which a test
    adds new ones; and a copy of BENCHMARK.json's spec that the test may
    extend. Returns (the folder, the spec)."""
    for d in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / d).mkdir()
        for f in (harness.HERE / d).iterdir():
            if f.is_file():
                (tmp_path / d / f.name).symlink_to(f)
    spec = harness.benchmark_spec()
    monkeypatch.setattr(harness, "HERE", tmp_path)
    monkeypatch.setattr(harness, "benchmark_spec", lambda: spec)
    return tmp_path, spec
