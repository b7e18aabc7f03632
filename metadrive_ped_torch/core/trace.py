"""The port's own spans and counters, kept in memory.

All three kinds of record are off until `enable()`:

- **Host spans**, `span(name)`: the host's `time.perf_counter_ns` at both
  ends, the enclosing open host span, and a call id that every span of one
  outermost call (`env.step`, `env.rollout`) shares. While a
  `torch.profiler` recording is open, a span also enters
  `torch.profiler.record_function(name)`, tracing on or off, so the
  profiler's host events name the program's steps. With tracing off and
  no recording, a span is one flag test and a branch.
- **Device spans**, `stage(name, device)`: a stamp at each end. On a CUDA
  device a stamp is the one-thread kernel of csrc/trace_stamp.cu, which
  writes (code, %globaltimer) into the device's ring buffer: a kernel, so
  that it lands in a captured graph between two stages and runs at every
  replay, where `record_function` does not survive. CPU ops run
  synchronously, so there a stamp is the host's `perf_counter_ns`. Stamps
  launch only while tracing is on: a graph captured then holds them and
  every replay writes them, a graph captured with tracing off holds none
  (core/graph.py keys the step and rollout graphs by `enabled`).
- **Counters**, `count(name, value, device)`: an int64 accumulator a
  counter on each device, added to by a device op, so that inside a
  captured graph it accumulates at every replay with no tally.

The rules are core/launches.py's: the stamp kernel counts its launches
through `launches.record` (this module is its counter), and nothing is
stamped or counted inside `muted` (a graph's warm-up steps, thrown away).
A device's ring, head and counters are allocated once, outside any capture
(`ready`), and live as long as the process, so a graph that captured their
addresses never writes freed memory.

`records()` reads every device once and gives the spans of both kinds on
the host's `perf_counter_ns` clock: a CUDA device's globaltimer maps onto
it linearly through two calibration pairs (a stamp, a synchronisation,
the host time; the closest of ten tries), one taken when tracing is
turned on and one at the read. `read(fn, ...)` is the whole protocol of a
reading (on, the calls that capture the stamped graphs, the calls read,
off); `durations` and `table` sum the records up stage by stage.
"""
import collections
import contextlib
import ctypes
import itertools
import statistics
import sys
import time

import torch
import torch.autograd.profiler as _profiler

from metadrive_ped_torch.core import cuda_build, launches as launch_counts

# launches of the stamp kernel (the counter `core.launches.record` keeps)
launches = 0
launches_by_device = collections.Counter()

# host spans, each with its listed parent (None: an outermost call)
HOST_SPANS = {
    "env.step": None,
    "step.actions": "env.step",       # _step_actions: the user's actions to a tensor
    "step.load": "env.step",          # the graph's key and StepGraph.load's pass over the state
    "step.replay": "env.step",        # the graph launch
    "step.clone": "env.step",         # the clones of the graph's outputs
    "step.frame_obs": "env.step",     # _frame_obs: the user's observation
    "step.outputs": "env.step",       # _step_outputs: the host's bookkeeping
    "env.rollout": None,
    "rollout.load": "env.rollout",
    "rollout.replay": "env.rollout",  # one a replay
    "rollout.collect": "env.rollout", # one a replay: _copy_step's copies
}
# device spans, each with its listed parent. A span whose listed parent
# did not run (a step's replay has no rollout; the eager loop has no
# replay) sits in the nearest listed ancestor that did.
DEVICE_SPANS = {
    "rollout": None,                  # one eager pair around a rollout call
    "replay": "rollout",              # a step graph's region, write-back included
    "advance": "replay",
    "advance.actions": "advance",     # clip, lane-change policy, AI protector
    "advance.dynamics": "advance",    # ego substeps, kinematic override, lights
    "advance.traffic": "advance",     # NPC release, IDM (and expert), pedestrians
    "advance.traffic.expert": "advance.traffic",
    "advance.contacts": "advance",    # contact flags and response
    "advance.navigation": "advance",  # localization, reward, done, cost, info
    "advance.reset": "advance",       # auto-reset; a multi-agent env's respawn
    "observe": "replay",
    "observe.lidar": "observe",
    "observe.features": "observe",
    "graph.writeback": "replay",
    # the image observation's frame: in a rollout's replay, or alone in the
    # frame graph that `step` and `reset` replay
    "camera": "replay",
    # the plain chain's stages (ops/camera.py::render_plain, the CPU's path);
    # on the card the frame is one kernel inside `camera`
    "camera.ground": "camera",        # the ground hit (ops/camera.py::_ground_hit), a row chunk
    "camera.boxes": "camera",         # the box hits (_box_hits), a row chunk
}
COUNTERS = (
    "reset.rows",       # rows a step replaced by a spawn
    "reset.computed",   # rows the spawns computed
    "expert.live",      # NPC slots active and driven by the expert
    "expert.computed",  # NPC slots the expert computed
    "camera.pixels",          # rows x H x W the camera rendered
    "camera.boxes_live",      # (pixel, active target slot) pairs
    "camera.boxes_computed",  # (pixel, target slot) pairs the box test computed
                              # (the kernel counts its own, both passes)
)
# stamps a device keeps; past that the oldest are overwritten
RING = 1 << 16

enabled = False
_muted = 0
_NULL = contextlib.nullcontext()
_NAMES = tuple(DEVICE_SPANS)
_CODES = {name: i for i, name in enumerate(_NAMES)}
_COUNTER_AT = {name: i for i, name in enumerate(COUNTERS)}

_calls = 0     # the newest call id
_open = []     # indices into _host of the open host spans, innermost last
_host = []     # [name, parent index, call, start ns, end ns] of every host span
_devices = {}  # device key -> _Device


def enable():
    """Turn tracing on; every known CUDA device's clock is calibrated anew."""
    global enabled
    enabled = True
    for d in _devices.values():
        d.calibrate()


def disable():
    global enabled
    enabled = False


def clear():
    """Forget every record: host spans, stamps, counters."""
    if _open:
        raise RuntimeError("trace.clear() inside an open span")
    _host.clear()
    for d in _devices.values():
        d.clear()


@contextlib.contextmanager
def muted():
    """Nothing is stamped or counted inside the block."""
    global _muted
    _muted += 1
    try:
        yield
    finally:
        _muted -= 1


# ---- host spans --------------------------------------------------------------
def _profiling():
    """Whether a torch.profiler recording is open (False where this torch
    has no such flag: then spans never enter record_function)."""
    return getattr(_profiler, "_is_profiler_enabled", False)


class _HostSpan:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name):
        self.name, self.rec, self.rf = name, None, None

    def __enter__(self):
        global _calls
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if enabled:
            if _open:
                parent = _open[-1]
                call = _host[parent][2]
            else:
                _calls += 1
                parent, call = None, _calls
            self.rec = [self.name, parent, call, time.perf_counter_ns(), None]
            _open.append(len(_host))
            _host.append(self.rec)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[4] = time.perf_counter_ns()
            _open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name):
    """A host span named ``name`` (one of HOST_SPANS)."""
    if not (enabled or _profiling()):
        return _NULL
    return _HostSpan(name)


# ---- device spans and counters -------------------------------------------------
def _key(device):
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    return f"{device.type}:{index}"


def _kernel():
    fn = cuda_build.library("trace_stamp").trace_stamp_launch
    if fn.argtypes is None:
        ptr, u64 = ctypes.c_void_p, ctypes.c_ulonglong
        fn.argtypes = [ptr, ptr, u64, u64, ptr]
        fn.restype = ctypes.c_int
    return fn


class _Device:
    """One device's stamps (a ring and its head on a CUDA device, a list on
    the CPU), its counters and its clock's calibration pair."""

    def __init__(self, key):
        self.key, self.device = key, torch.device(key)
        self.cuda = self.device.type == "cuda"
        self.counters = torch.zeros(len(COUNTERS), dtype=torch.int64, device=self.device)
        self.pair = (0, 0)
        if self.cuda:
            self.ring = torch.zeros((RING, 2), dtype=torch.int64, device=self.device)
            self.head = torch.zeros(1, dtype=torch.int64, device=self.device)
            self.calibrate()
        else:
            self.stamps = []

    def stamp(self, code, ring=None, head=None, capacity=RING):
        if not self.cuda:
            self.stamps.append((code, time.perf_counter_ns()))
            return
        ring = self.ring if ring is None else ring
        head = self.head if head is None else head
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = _kernel()(ring.data_ptr(), head.data_ptr(), capacity, code, stream)
        if err != 0:
            raise RuntimeError(f"trace_stamp kernel launch failed: cudaError {err}")
        launch_counts.record(sys.modules[__name__], self.device.index)

    def calibrate(self):
        """Set `pair`, the calibration pair of tracing turned on."""
        if self.cuda:
            self.pair = self._pair()

    def _pair(self):
        """(globaltimer, host perf_counter_ns) at one instant: of ten
        stamps, the one that came back soonest after its launch, at the
        middle of its launch and its synchronisation."""
        ring = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
        head = torch.zeros(1, dtype=torch.int64, device=self.device)
        best = None
        for _ in range(10):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter_ns()
            self.stamp(0, ring, head, 1)
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, int(ring[0, 1]), (t0 + t1) // 2)
        return best[1:]

    def clear(self):
        self.counters.zero_()
        if self.cuda:
            self.head.zero_()
        else:
            self.stamps.clear()

    def read(self):
        """(the stamps oldest first as (code, host ns), how many were
        overwritten, the counters)."""
        if not self.cuda:
            return list(self.stamps), 0, self.counters.tolist()
        flat = torch.cat([self.head, self.counters, self.ring.reshape(-1)]).cpu()
        n, counters = int(flat[0]), flat[1:1 + len(COUNTERS)].tolist()
        ring = flat[1 + len(COUNTERS):].reshape(RING, 2)
        if n > RING:
            ring = torch.cat([ring[n % RING:], ring[:n % RING]])
        rows = ring[:min(n, RING)].tolist()
        # the globaltimer and the host's clock drift apart by tens of ppm:
        # map linearly between the pair of `enable` and one taken now
        (g0, h0), (g1, h1) = self.pair, self._pair()
        rate = (h1 - h0) / (g1 - g0) if g1 - g0 > 10 ** 7 else 1.0
        return ([(code, h0 + round((t - g0) * rate)) for code, t in rows], max(0, n - RING),
                counters)


def ready(device):
    """The tracer's buffers on ``device``, allocated (and its clock
    calibrated) now if tracing is on: call before a capture, where nothing
    may be allocated or synchronised."""
    if enabled:
        _device(device)


def _device(device):
    key = _key(device)
    d = _devices.get(key)
    if d is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the tracer's buffers on a device are made outside a capture: "
                               "call core.trace.ready(device) before it")
        d = _devices[key] = _Device(key)
    return d


class _Stage:
    __slots__ = ("code", "device")

    def __init__(self, code, device):
        self.code, self.device = code, device

    def __enter__(self):
        self.device.stamp(2 * self.code)
        return self

    def __exit__(self, *exc):
        self.device.stamp(2 * self.code + 1)
        return False


def stage(name, device):
    """A device span named ``name`` (one of DEVICE_SPANS) on ``device``."""
    if not enabled or _muted:
        return _NULL
    return _Stage(_CODES[name], _device(device))


def count(name, value, device):
    """Add ``value`` to the counter ``name`` (one of COUNTERS) on
    ``device``: a tensor is summed on the device, an int added as it is."""
    if not enabled or _muted:
        return
    acc = _device(device).counters.narrow(0, _COUNTER_AT[name], 1)
    acc.add_(value.sum() if torch.is_tensor(value) else value)


# ---- export ------------------------------------------------------------------------
def records():
    """Everything recorded since the last `clear`: ``spans``, a list of dicts (``name``,
    ``parent``, the index of the enclosing span in this list or None,
    ``call``, ``clock``, "host" or "device", ``device``, ``start_ns``,
    ``end_ns``, both on the host's perf_counter_ns clock; a device span
    whose end was not stamped has ``end_ns`` None), ``counters`` summed
    over the devices, and ``lost``, the stamps overwritten in a full ring.
    Every span of one outermost span shares its ``call``; a device span's
    outermost span is its rollout, or without one its replay."""
    global _calls
    if _open:
        raise RuntimeError("trace.records() inside an open span")
    spans = [dict(name=n, parent=p, call=c, clock="host", device="host", start_ns=s, end_ns=e)
             for n, p, c, s, e in _host]
    counters = dict.fromkeys(COUNTERS, 0)
    lost = 0
    for key, d in _devices.items():
        stamps, n_lost, values = d.read()
        lost += n_lost
        for name, v in zip(COUNTERS, values):
            counters[name] += v
        stack = []
        for code, t in stamps:
            name, end = _NAMES[code // 2], code % 2
            if end:
                if stack and spans[stack[-1]]["name"] == name:
                    spans[stack.pop()]["end_ns"] = t
                continue  # its begin was overwritten
            parent = stack[-1] if stack else None
            if parent is None:
                _calls += 1
            call = spans[parent]["call"] if parent is not None else _calls
            stack.append(len(spans))
            spans.append(dict(name=name, parent=parent, call=call, clock="device", device=key,
                              start_ns=t, end_ns=None))
    return dict(spans=spans, counters=counters, lost=lost)


def read(fn, n=1, warm=1, settled=None, wait_s=0.0):
    """The records of ``n`` calls of ``fn()`` with tracing on, after
    ``warm`` (at least one) calls whose records are dropped (the first
    captures the stamped graphs). With ``settled``, warm calls go on, up to
    ``wait_s`` seconds after the first, until ``settled(records of the
    last one)`` holds. Tracing is off again after, and nothing is left
    recorded."""
    enable()
    try:
        for i in itertools.count():
            fn()
            if i == 0:
                t0 = time.perf_counter()
            last = records() if settled is not None else None
            clear()
            if i + 1 >= warm and (settled is None or settled(last)
                                  or time.perf_counter() - t0 >= wait_s):
                break
        for _ in range(n):
            fn()
        return records()
    finally:
        disable()
        clear()


def durations(recs):
    """The ms of every finished span of ``recs`` by (clock, name)."""
    ms = collections.defaultdict(list)
    for s in recs["spans"]:
        if s["end_ns"] is not None:
            ms[s["clock"], s["name"]].append((s["end_ns"] - s["start_ns"]) / 1e6)
    return ms


def table(recs, steps):
    """The spans of ``recs`` stage by stage, in the order listed, as text:
    how many, the median ms of one, and their ms a step over ``steps``
    steps; then the counters, in all and a step."""
    ms = durations(recs)
    lines = [f"{'span':<26}{'clock':>7}{'count':>7}{'median ms':>12}{'ms a step':>12}"]
    for clock, names in (("device", DEVICE_SPANS), ("host", HOST_SPANS)):
        for name in names:
            v = ms.get((clock, name))
            if v:
                lines.append(f"{name:<26}{clock:>7}{len(v):>7}{statistics.median(v):>12.4f}"
                             f"{sum(v) / steps:>12.4f}")
    for name, v in recs["counters"].items():
        lines.append(f"{name:<26}{'':>7}{'':>7}{v:>12}{v / steps:>12.1f}")
    return "\n".join(lines)
