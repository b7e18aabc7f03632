"""Build the package's native code and load it with ctypes.

Each CUDA source ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). Each host C++ source ``native/<name>.cpp`` compiles with
``g++ -O3 -shared -fPIC`` (`host_library`); a failed build raises, there is
no fallback. Libraries go to ``metadrive_ped_torch/_build/`` (listed in
.gitignore), named by a hash of the source and flags, so a changed source
always rebuilds. Nothing is built at import: the first use builds, or
`build_all` builds every kernel at once, one nvcc process per source, all
started together.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG / "_build"

KERNELS = ("ray_segment", "trace_stamp", "npc_lidar")
# no --use_fast_math anywhere; -fmad=false keeps a*b - c*d as two rounded
# products, like the plain torch versions
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_HOST_FLAGS = ["-O3", "-shared", "-fPIC"]

_libs = {}
# name -> what ptxas reported for the kernel (registers, shared memory)
ptxas_reports = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _target(name, src=None, flags=_FLAGS):
    src = (CSRC / f"{name}.cu") if src is None else src
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _parse_ptxas(text):
    lines = [ln.strip() for ln in text.splitlines() if "ptxas info" in ln]
    report = {"lines": lines}
    for ln in lines:
        if "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            report["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                report["smem_bytes"] = int(words[words.index("smem") - 2])
    return report


def build_all(names=KERNELS):
    """Compile every named kernel that is not built yet, all nvcc processes
    at once. Returns the seconds taken; raises if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        ptxas_reports[name] = _parse_ptxas(log)
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in names:
        if name not in ptxas_reports:
            log = _target(name).with_suffix(".ptxas.txt")
            ptxas_reports[name] = _parse_ptxas(log.read_text() if log.exists() else "")
    return time.perf_counter() - t0


def library(name):
    """The loaded ctypes library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def host_library(name):
    """The loaded ctypes library of the host C++ source ``native/<name>.cpp``,
    built with g++ on first use. Raises when g++ is missing or fails."""
    key = ("host", name)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    src = NATIVE / f"{name}.cpp"
    out = _target(name, src, _HOST_FLAGS)
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: {src.name} needs a C++ compiler to build")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *_HOST_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = _libs[key] = ctypes.CDLL(str(out))
    return lib
