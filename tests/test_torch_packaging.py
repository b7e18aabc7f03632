"""The port's package data: every file of metadrive_ped_torch/ that is not
Python source ships in an install. A file missing from pyproject.toml's
`[tool.setuptools.package-data]` is left out of every non-editable install,
and what reads it fails there alone (the host rasterizer's
native/td_raster.cpp, which `core/cuda_build.py::host_library` compiles at
first use, did until its glob was added)."""
import os
import subprocess
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "metadrive_ped_torch"


def _package_files():
    """The package's files as git tracks them (relative to the repo root),
    or, outside a git checkout, as they lie on disk less what .gitignore
    lists for the package (_build/, __pycache__/, *.pyc, *.so)."""
    try:
        out = subprocess.run(["git", "ls-files", PKG], cwd=ROOT, capture_output=True, text=True,
                             check=True, timeout=60).stdout.split()
        if out:
            return out
    except (OSError, subprocess.CalledProcessError):
        pass
    files = []
    for dirpath, dirnames, names in os.walk(ROOT / PKG):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        files += [str(Path(dirpath, n).relative_to(ROOT)) for n in names
                  if not n.endswith((".pyc", ".so"))]
    return files


def _shipped():
    """The files the package-data globs of pyproject.toml select, under
    every package of the port."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = set()
    for package, globs in data.items():
        if package.split(".")[0] != PKG:
            continue
        base = ROOT / package.replace(".", "/")
        for g in globs:
            shipped |= {str(p.relative_to(ROOT)) for p in base.glob(g) if p.is_file()}
    return shipped


def test_every_data_file_of_the_port_ships():
    data = [f for f in _package_files()
            if not f.endswith(".py") and not f.startswith(f"{PKG}/_build/")]
    assert f"{PKG}/native/td_raster.cpp" in data
    missing = sorted(set(data) - _shipped())
    assert not missing, f"not in pyproject.toml's package-data: {missing}"
