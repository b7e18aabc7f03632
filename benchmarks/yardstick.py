"""The benchmark's own arithmetic: the card's peaks, the detector kernel's
least time, and the reductions of a `torch.profiler` trace to device busy
time, idle gaps, kernel counts and host API calls.

Copied from the program's tools (chip_smoke.py's `detector_bound`,
`OPS_PER_PAIR` and peaks, its `host_api_calls`, tools/profile_torch_step.py's
`kernel_stats`), so that the yardstick stays fixed while the program
changes. Nothing here imports the program.
"""
import bisect
import dataclasses

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): dense float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per (ray, line) pair of the ray-segment sweep:
# denom 3 (2 mul, 1 sub), |denom| guard 2, rel 2, t 4 (2 mul, sub, div),
# u 4, hit tests 3, scale 1 (div), clip 2
OPS_PER_PAIR = 21
# the marker around a traced window (a host span of the harness)
WINDOW = "bench.window"
# the marker around each `step` call of a traced Gymnasium-style loop
ENV_STEP = "bench.env_step"
TOP = 10


def detector_bound(E, Rs, Rl, sidx, table_numel, counts):
    """Least time (ms) of one detector-cloud call on the card, and what sets
    it: each input read once and each output written once, against
    OPS_PER_PAIR operations for every (ray, line) pair of this input.
    ``sidx`` [E] are the envs' scenario indices and ``counts`` [S, 2] the
    line table's (n_cont, n_any) per scenario (tensors); ``table_numel`` is
    the size of the [S, Bl, 4] table."""
    c = counts.long()[sidx.long()].sum(0)
    pairs = Rs * int(c[0]) + Rl * int(c[1])
    bytes_moved = (table_numel * 4 + counts.numel() * 4 + E * 4 + E * 8
                   + 3 * 4 * E * (Rs + Rl))          # fans (dx, dy) in, clouds out
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = OPS_PER_PAIR * pairs / PEAK_FP32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@dataclasses.dataclass
class Trace:
    """What a traced window of ``steps`` steps leaves: the device's
    operations as (name, start us, end us), sorted by start; the host's
    events as (name, start us, end us); the window's bounds (us); set by
    the harness, the actions of its last step and what the loop's measured
    (untraced) window recorded by CUDA events (seconds: `window_device_s`
    between its ends, `step_device_s` summed over its `step` calls)."""
    steps: int
    device: list
    host: list
    start: float
    end: float
    actions: object = None
    measured: dict = None

    @property
    def window_s(self):
        return (self.end - self.start) / 1e6

    def busy_intervals(self):
        """The union of the device's operations inside the window, as
        sorted, disjoint (start, end) intervals (us)."""
        merged = []
        for _, s, e in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self, pattern=""):
        """The device operations whose name holds ``pattern``, inside the
        window."""
        return [(n, s, e) for n, s, e in self.device
                if pattern in n and s >= self.start and e <= self.end]

    def host_api_calls(self, span=WINDOW):
        """CUDA runtime and driver API calls (cuda*, cu*) the host made
        inside the host spans named ``span``: kernel and graph launches,
        copies, synchronisations."""
        spans = [(s, e) for n, s, e in self.host if n == span]
        if span == WINDOW:
            spans = [(self.start, self.end)]
        return sum(1 for n, s, _ in self.host
                   if n.startswith("cu") and any(a <= s <= b for a, b in spans))

    def idle_gaps(self):
        """Idle seconds of the device by what the host was doing: each gap
        between the busy intervals is named by the innermost host event
        over its midpoint (the harness's own span when no other is)."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        hosts = sorted(((s, e, n) for n, s, e in self.host if n != WINDOW),
                       key=lambda h: h[0])
        starts = [h[0] for h in hosts]
        # an event longer than this cannot lie over a point it starts before
        longest = max((e - s for s, e, _ in hosts), default=0.0)
        by_name = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            lo = bisect.bisect_left(starts, mid - longest)
            hi = bisect.bisect_right(starts, mid)
            over = [h for h in hosts[lo:hi] if h[1] >= mid]
            name = min(over, key=lambda h: h[1] - h[0])[2] if over else "harness (no host op)"
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def top_device_ops(self):
        """Device seconds of each operation name in the window, largest
        first."""
        by_name = {}
        for n, s, e in self.kernels():
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def breakdown(self):
        def short(name):
            for noise in ("void ", "at::native::", "(anonymous namespace)::"):
                name = name.replace(noise, "")
            return name if len(name) <= 120 else name[:117] + "..."
        return dict(device_ops=[[short(n), s] for n, s in self.top_device_ops()[:TOP]],
                    idle_gaps=[[short(n), s] for n, s in self.idle_gaps()[:TOP]])


def trace_of(prof, steps):
    """The `Trace` of a profiler run whose window is the host span named
    WINDOW."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for ev in prof.events():
        rng = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or ev.name == WINDOW:
                continue  # a host span's shadow on the device's timeline, not an operation
            device.append((ev.name, float(rng.start), float(rng.end)))
        else:
            host.append((ev.name, float(rng.start), float(rng.end)))
            if ev.name == WINDOW:
                window = (float(rng.start), float(rng.end))
    if window is None:
        raise RuntimeError(f"the profiler kept no {WINDOW} span")
    device.sort(key=lambda d: d[1])
    return Trace(steps=steps, device=device, host=host, start=window[0], end=window[1])


def device_ms(fn, calls):
    """Device time (ms) of one call of fn(), from the profiler's device
    records over ``calls`` calls after one untimed call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    return total / 1e3 / calls if kernels else None
