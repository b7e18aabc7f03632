"""One run of one cell: set-up, the measured window, the traced window, and
the comparison with the reference that decides ``correct``.

Everything that belongs to a cell is data found by name: the cell's entry
in BENCHMARK.json names its configuration (configs/<name>.json) and its
traffic mix (traffic/<name>.json); its per-layer metrics are modules
metrics/<name>.py with a function ``read(trace, env)``; its comparison
limits are limits/<cell>.json. The harness drives the program's env
(metadrive_ped_torch) through its public loops, ``rollout`` or ``step``,
and the frozen reference (benchmarks/reference) through the same loops; a
configuration or traffic mix whose env the reference does not export names
its reference class in a module of its own (``reference_class``).
"""
import contextlib
import gc
import importlib
import importlib.util
import json
import random
import statistics
import time
from pathlib import Path

import torch

from benchmarks import yardstick
from benchmarks.actor import Actor
from benchmarks.reference.core.structs import map_tensors

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
PROGRAM = "metadrive_ped_torch"
REFERENCE = "benchmarks.reference"
GIB = 1024 ** 3
TRACED_STEPS = 20
# On the card the measured window opens no sooner than this many seconds
# after the process started: a process started as another process's run
# ends runs its replayed steps 14-16% slower, as a rule until it is about
# 20 s old and at times past 50 s, whether it works or sleeps meanwhile
# (PERF.md). The wait is not set-up work and is left out of setup_s.
SETTLE_AGE_S = 60.0


def _load(kind, name):
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def _merged(base, extra):
    """``base`` with ``extra``'s keys set, nested dicts merged key by key."""
    out = dict(base)
    for k, v in extra.items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def benchmark_spec():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic mix, limits
    and metrics, all read by name."""

    def __init__(self, name, spec=None):
        spec = benchmark_spec() if spec is None else spec
        entry = {w["name"]: w for w in spec["workloads"]}[name]
        self.name, self.chips = name, entry["chips"]
        self.config = _load("configs", entry["config"])
        self.traffic = _load("traffic", entry["traffic"])
        self.limits = _load("limits", name)
        self.env_class = self.traffic.get("env_class", self.config["env_class"])
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def env_config(self, overrides=None):
        cfg = _merged(self.config["config"], self.traffic.get("config", {}))
        return _merged(cfg, overrides or {})

    def reference_class(self):
        """The reference's env class of this cell. A traffic mix or a
        configuration may name it, ``"reference_class": "<module under
        benchmarks/reference>:<Class>"``; the traffic's wins, as its
        ``env_class`` does. Where the file that names the program's class
        names no reference class, it is that class's name in
        benchmarks.reference."""
        for src in (self.traffic, self.config):
            if "reference_class" in src:
                module, name = src["reference_class"].split(":")
                return getattr(importlib.import_module(f"{REFERENCE}.{module}"), name)
            if "env_class" in src:
                return getattr(importlib.import_module(REFERENCE), src["env_class"])

    def build(self, package, device, overrides=None):
        """The env of this cell from ``package`` (the program or the
        reference) on ``device``."""
        cls = (self.reference_class() if package == REFERENCE
               else getattr(importlib.import_module(package), self.env_class))
        return cls(self.env_config(overrides), device=device)

    def check_block(self, seed):
        """The steps [a, a + n) after reset whose outputs are compared, a
        drawn from ``seed`` in the traffic's range."""
        chk = self.traffic["check"]
        a = random.Random(seed).randint(chk["first"], chk["last"])
        return a, a + chk["steps"]


def metric_reader(name):
    """The ``read`` function of metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"benchmarks.metrics.{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Kept:
    """The program's outputs of the check block and what the reference
    needs to follow it: the actions of every step up to the block's end."""

    def __init__(self, block):
        self.block = block
        self.fields = {}
        self.actions = []

    def add(self, step0, fields):
        """Keep rows [a - step0, b - step0) of ``fields`` ([T, ...] each, the
        steps from ``step0`` on), copied to the host so that the program's
        peak device memory holds none of them."""
        a, b = self.block
        T = next(iter(fields.values())).shape[0]
        lo, hi = max(a, step0) - step0, min(b, step0 + T) - step0
        if lo < hi:
            for k, v in fields.items():
                self.fields.setdefault(k, []).append(v[lo:hi].to("cpu", copy=True))

    def done(self, steps):
        return steps >= self.block[1]

    def stacked(self):
        return {k: torch.cat(v) for k, v in self.fields.items()}


class RolloutLoop:
    """A trainer's collection loop: ``rollout(chunk)`` back to back, with
    fixed actions, collecting what a PPO collector keeps. A step fails where
    a collected field holds a value that is not finite."""

    def __init__(self, cell, env, seed, device):
        tr = cell.traffic
        self.env, self.device, self.chunk = env, device, tr["chunk"]
        self.collect = tuple(tr["collect"])
        self.act = torch.tensor(tr["actions"], dtype=torch.float32, device=device).expand(
            env.num_envs, 2).contiguous()
        self.kept = _Kept(cell.check_block(seed))
        self.steps = 0
        self.measured = {}

    def begin(self, obs):
        pass

    def warm(self):
        """The capture of the cell's graph: a rollout of one step."""
        n = 1
        outs, _ = self.env.rollout(n, actions=self.act, collect=self.collect)
        self.kept.add(0, outs)
        self.steps += n

    def window(self, seconds, graphs):
        """(steps, failed steps, elapsed s, []): chunks until ``seconds``
        have passed and the check block is kept."""
        env, steps0 = self.env, self.steps
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        unreplayed, ends = 0, []
        t0, epoch = time.perf_counter(), time.time()
        while True:
            before = graphs and (graphs.replays, graphs.captures)
            outs, _ = env.rollout(self.chunk, actions=self.act, collect=self.collect)
            ends.append(time.perf_counter() - t0)
            if graphs and (graphs.replays - before[0], graphs.captures) != (self.chunk,
                                                                            before[1]):
                unreplayed += self.chunk
            ok = torch.stack([torch.isfinite(v.reshape(self.chunk, -1).sum(-1))
                              for v in outs.values()]).all(0)
            bad += (~ok).sum()
            if not self.kept.done(self.steps):
                self.kept.add(self.steps, outs)
            self.steps += self.chunk
            del outs, ok
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and self.kept.done(self.steps):
                break
        steps = self.steps - steps0
        self.log(f"chunk ends (s after {epoch}): {ends}")
        return steps, min(steps, unreplayed + int(bad)), elapsed, []

    def traced(self, steps):
        self.env.rollout(steps, actions=self.act, collect=self.collect)
        return self.act


class StepLoop:
    """A Gymnasium-style trainer: the seeded actor on the last observation,
    ``step``, then the host read of reward, terminated and truncated."""

    def __init__(self, cell, env, seed, device):
        self.env, self.device = env, device
        self.kept = _Kept(cell.check_block(seed))
        self.hidden = tuple(cell.traffic["actor_hidden"])
        self.bias = tuple(cell.traffic["actor_bias"])
        self.seed, self.steps, self.obs, self.actor = seed, 0, None, None
        self.last_act = None
        self.span = contextlib.nullcontext
        self.on_card = torch.device(device).type == "cuda"
        self.measured = {}

    def begin(self, obs):
        """The actor, drawn from the seed, and the reset observation."""
        self.obs = obs
        self.actor = Actor(obs.shape[-1], self.seed, self.device, self.hidden, self.bias)

    def _one(self, marks=None):
        """One call: the actor, `step` (between the CUDA events ``marks``,
        where given) and the host read. Returns the step's outputs."""
        act = self.actor(self.obs)
        if marks:
            marks[0].record()
        with self.span(yardstick.ENV_STEP):
            self.obs, reward, terminated, truncated, _ = self.env.step(act)
        if marks:
            marks[1].record()
        reward.cpu(), terminated.cpu(), truncated.cpu()
        self.last_act = act
        return act, reward, terminated, truncated

    def _keep(self, act, reward, terminated, truncated):
        """After a call, outside its time: what the comparison needs."""
        if not self.kept.done(self.steps):
            self.kept.actions.append(act.to("cpu", copy=True))
            fields = dict(obs=self.obs, reward=reward, terminated=terminated,
                          truncated=truncated)
            self.kept.add(self.steps, {k: v[None] for k, v in fields.items()})
        self.steps += 1

    def _event(self):
        return torch.cuda.Event(enable_timing=True) if self.on_card else None

    def warm(self):
        self._keep(*self._one())

    def window(self, seconds, graphs):
        """(steps, failed steps, elapsed s, per-call ms): calls until
        ``seconds`` have passed and the check block is kept. On the card,
        CUDA events mark the window's ends and each `step` call's device
        work (`measured`)."""
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        unreplayed, times, spans = 0, [], []
        ends = (self._event(), self._event())
        t0 = time.perf_counter()
        if ends[0]:
            ends[0].record()
        while True:
            before = graphs and (graphs.replays, graphs.captures)
            marks = (self._event(), self._event())
            t1 = time.perf_counter()
            outs = self._one(marks if marks[0] else None)
            t2 = time.perf_counter()
            times.append((t2 - t1) * 1e3)
            spans.append(marks)
            self._keep(*outs)
            if graphs and (graphs.replays - before[0], graphs.captures) != (1, before[1]):
                unreplayed += 1
            obs = self.obs
            bad += (~torch.isfinite(obs.reshape(obs.shape[0], -1).sum(-1))).any()
            if t2 - t0 >= seconds and self.kept.done(self.steps):
                break
        if ends[1]:
            ends[1].record()
            ends[1].synchronize()
            self.measured = dict(
                window_device_s=ends[0].elapsed_time(ends[1]) / 1e3,
                step_device_s=sum(a.elapsed_time(b) for a, b in spans) / 1e3)
        steps = len(times)
        per_s = max(1, round(steps / (t2 - t0)))
        self.log("median ms of each second's calls: "
                 f"{[statistics.median(times[i:i + per_s]) for i in range(0, steps, per_s)]}")
        return steps, min(steps, unreplayed + int(bad)), t2 - t0, times

    def traced(self, steps):
        from torch.profiler import record_function
        self.span = record_function
        for _ in range(steps):
            self._keep(*self._one())
        return self.last_act


LOOPS = dict(rollout=RolloutLoop, step=StepLoop)


def reset_seed(seed):
    """The env's reset seed of the run's ``--seed`` (the port's keys hold 32
    bits)."""
    return seed % (1 << 32)


def start(cell, env, seed, device, log=print):
    """Reset the program's ``env`` from ``seed`` and warm the cell's loop up
    (the capture of its graph): (the loop, a copy of the reset state
    observation)."""
    loop = LOOPS[cell.traffic["loop"]](cell, env, seed, device)
    loop.log = log
    obs, _ = env.reset(seed=reset_seed(seed))
    reset_obs = env._last_obs.to("cpu", copy=True)
    loop.begin(obs)
    loop.warm()
    return loop, reset_obs


def run_cell(name, seed, seconds, trace, device="cuda", overrides=None, t0=None, fault=None,
             log=print):
    """One run of cell ``name``: the result line's fields (without
    ``device``'s platform keys) and the compared numbers. ``overrides``
    change the configuration (CPU tests at small sizes); ``fault(env)``
    breaks the program's env underneath (fault tests); ``t0`` is the
    process's start on `time.perf_counter`'s clock."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_build = time.perf_counter()
    env = cell.build(PROGRAM, device, overrides)
    if fault is not None:
        fault(env)
    t_start = time.perf_counter()
    loop, reset_obs = start(cell, env, seed, device, log)
    _sync(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up: {setup_s} s; before the env {t_build - t0} s, the env built "
        f"{t_start - t_build} s, reset and warm-up {t0 + setup_s - t_start} s")
    graphs = env._graphs
    if torch.device(device).type == "cuda":
        if graphs is None:
            raise RuntimeError("the env captured no graph at set-up")
        wait = t0 + SETTLE_AGE_S - time.perf_counter()
        log(f"waiting {max(0.0, wait)} s for the process to settle")
        time.sleep(max(0.0, wait))
    steps, failed, elapsed, times = loop.window(seconds, graphs)
    _sync(device)
    peak = torch.cuda.max_memory_reserved() if torch.device(device).type == "cuda" else 0
    values = dict(setup_s=setup_s, agent_steps_per_s=env.num_envs * steps / elapsed,
                  peak_mem_gib=peak / GIB)
    if times:
        values["step_ms_p95"] = statistics.quantiles(times, n=100)[94]
        log(f"step calls: {len(times)}, median {statistics.median(times)} ms, "
            f"p95 {values['step_ms_p95']} ms, {values['agent_steps_per_s']} agent-steps/s")
    result = dict(attempted=steps, failed=failed, memory_peak_bytes=peak)
    if trace:
        result.update(_traced(cell, env, loop, device))
    else:
        result["metrics"] = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                             for m in cell.end_to_end}
    kept = loop.kept
    del env, loop, graphs
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare(cell, seed, reset_obs, kept, device, overrides)
    log(f"reference: built, reset and {kept.block[1]} steps followed in "
        f"{time.perf_counter() - t_ref} s")
    result["check"] = {k: dict(value=v, limit=cell.limits[k]) for k, v in numbers.items()}
    result["correct"] = all(v <= cell.limits[k] for k, v in numbers.items())
    return result


def _traced(cell, env, loop, device):
    """The per-layer metrics of a traced window of TRACED_STEPS steps (and
    of what the loop's measured window recorded), the device's busy and
    window seconds, and the breakdown."""
    from torch.profiler import ProfilerActivity, profile, record_function
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(yardstick.WINDOW):
            actions = loop.traced(TRACED_STEPS)
            _sync(device)
    tr = yardstick.trace_of(prof, TRACED_STEPS)
    del prof
    tr.actions, tr.measured = actions, loop.measured
    metrics = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(tr, env)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    return dict(metrics=metrics, busy_s=tr.busy_s, window_s=tr.window_s,
                breakdown=tr.breakdown())


def _round_bf16(tree):
    """``tree`` with every float tensor rounded to bfloat16 in place."""
    def rnd(t):
        if t.is_floating_point():
            t.copy_(t.to(torch.bfloat16).to(t.dtype))
        return t
    return map_tensors(rnd, tree)


def follow(cell, ref, seed, kept, control=None):
    """The reference env ``ref``'s reset observation and its outputs of the
    check block, from the seed and the actions alone. ``control`` computes
    them in a lower precision: "bf16" stores the state and the outputs in
    bfloat16 after every step, "tf32" lets float32 matrix products use
    TF32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
    try:
        ref.reset(seed=reset_seed(seed))
        if control == "bf16":
            _round_bf16((ref._state, ref._last_obs))
        reset_obs = ref._last_obs.to("cpu", copy=True)
        a, b = kept.block
        loop = cell.traffic["loop"]
        fixed = (torch.tensor(cell.traffic.get("actions", [0.0, 0.0]), dtype=torch.float32,
                              device=ref.device).expand(ref.num_envs, 2).contiguous())
        outs = {}
        for i in range(b):
            if loop == "rollout":
                collect = tuple(cell.traffic["collect"]) if i >= a else ()
                step, _ = ref.rollout(1, actions=fixed, collect=collect)
                step = {k: v[0] for k, v in step.items()}
            else:
                obs, reward, terminated, truncated, _ = ref.step(kept.actions[i])
                step = dict(obs=obs, reward=reward, terminated=terminated, truncated=truncated)
            if control == "bf16":
                _round_bf16((ref._state, ref._last_obs))
                step = {k: _round_bf16(v.clone()) for k, v in step.items()}
            if i >= a:
                for k, v in step.items():
                    outs.setdefault(k, []).append(v.clone())
        return reset_obs, {k: torch.stack(v).cpu() for k, v in outs.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def numbers_of(prog_reset, prog, ref_reset, ref):
    """The compared numbers: the widest gap of the reset observation and of
    each float field of the block (``<field>_gap``: observations, rewards,
    NPC positions where collected), and the count of done flags that
    differ."""
    gap = lambda x, y: float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
    out = dict(reset_gap=gap(prog_reset, ref_reset))
    for k, v in prog.items():
        if v.is_floating_point():
            out[f"{k}_gap"] = gap(v, ref[k])
    out["done_mismatch"] = int(((prog["terminated"] != ref["terminated"])
                                | (prog["truncated"] != ref["truncated"])).sum())
    return out


def compare(cell, seed, reset_obs, kept, device, overrides=None):
    """The compared numbers of the program's kept outputs against the
    reference, built anew from the cell's configuration."""
    ref = cell.build(REFERENCE, device, overrides)
    ref_reset, ref_outs = follow(cell, ref, seed, kept)
    return numbers_of(reset_obs, kept.stacked(), ref_reset, ref_outs)
