"""A vector env's step captured as CUDA graphs and replayed once a step.

The JAX package compiles its step once,
``self._step_jit = jax.jit(self._step_impl, donate_argnums=0)``
(metadrive_ped_tpu/envs/base.py:322), runs `rollout` "entirely on-device
via lax.scan (no per-step host dispatch)" (metadrive_ped_tpu/envs/
base.py:497-529), compiled again only when its key ``(id(policy_fn),
collect, n_steps, num_scenarios)`` changes, and compiles the camera frame
once, ``self._render_jit = jax.jit(self._render_frame)`` (:326-327). Its
`ShardedEnv` (metadrive_ped_tpu/parallel/mesh.py) runs the same compiled
step over a sharded state: one SPMD program. PyTorch runs eagerly: the
host dispatches each of a step's thousands of kernels. Here the step is
captured once into `torch.cuda.CUDAGraph`s, and every later step replays
them.

A `StepGraph` holds static input buffers (the state tree, the actions, and
the last observation where the step reads it: a policy, or the AI
protector's previous observation) and one graph whose captured region is
the policy, `_step_impl`, a leafwise copy of the new state and observation
back into the input buffers (the counterpart of ``donate_argnums=0``, so a
step is one replay and nothing more) and the step's outputs. The rules:

1. **Keys.** `rollout` captures again when ``(policy_fn, collect,
   num_scenarios, shapes)`` changes: JAX's key without ``n_steps``, since
   one graph serves every length (the shapes hold the image stack's where
   the env renders frames: its region then renders each step's frame and
   rolls the stack, a buffer as the state is). `step` captures again when
   ``(whether it reads the last observation, num_scenarios, shapes)``
   changes. An env keeps the newest graph of each (`EnvGraphs`), as JAX
   keeps its newest `rollout` compile; the key holds ``policy_fn`` itself,
   so its id is not reused while the graph lives.
2. **State set between steps.** Before a call the runner copies into its
   buffers every leaf of ``env._state`` (and ``env._last_obs`` where the
   step reads it) whose storage is not that buffer's: one pass over the
   leaves, a copy only where a leaf was rebound. So `reset`, `restore`,
   `set_break_down`, a curriculum's scenario cap and `replay_frame` reach
   the next replay. After a call ``env._state`` and ``env._last_obs`` are
   the graph's buffers: as with the JAX step's donated state, a state or
   observation held across a later step is overwritten by it (clone or
   `snapshot` what you keep).
3. **No aliasing.** Inside the region, an output leaf that shares storage
   with an input buffer is cloned before the write-back, so no write-back
   reads a buffer that an earlier one overwrote (the new state's
   ``last_pos`` is the old ``pos``) and no output is an input buffer.
4. **Outputs.** A replay overwrites the graph's outputs: `rollout` copies
   the collected fields after each replay into ``[n_steps, ...]`` tensors
   it allocates once per call; `step` returns clones.
5. **Warm-up.** Before the capture, `WARMUP_STEPS` eager steps run on a
   side stream on copies of the buffers and are thrown away (the env's
   state does not advance); the default CUDA generator is left as they
   found it.
6. **Kernel launches.** The warm-up's launches are not counted, and the
   capture's go into its tally (`core.launches`): each replay adds the
   tally to the kernels' counts, so a count stays the kernel's executions
   on the device it ran on.
7. **No fallback.** On a CUDA device `step` and `rollout` capture or
   raise. The CPU has no graphs and runs the eager loop.
8. **Tracing** (core/trace.py). The step and rollout keys hold whether
   tracing is on: a graph captured with it on holds the stage stamps
   (in an env's step and rollout graphs `replay` around the region and
   `graph.writeback` around the write-back; the env's stages inside, in
   the shards' graphs too) and the counters,
   and one captured with it off holds exactly the step's kernels. The
   warm-up stamps and counts nothing. `step` and `rollout` keep host
   spans around the load (the key, a capture where it is new, the copies
   of rule 2), each replay, the clones and the collected copies.

Two more programs follow the same rules:

- **The camera frame** (`EnvGraphs.frame`, the counterpart of
  ``_render_jit``): the env's frame of its state, keyed by (modality,
  width, height, the state's shapes, whether tracing is on: rule 8). It
  reads the state buffers of the graph that stepped the env last
  (``stepped``), so a replayed step and its frame copy nothing between
  them; a state that `reset` or `restore` rebound is loaded into those
  buffers (rule 2).
- **The sharded step** (`ShardedGraphs`, for `parallel.ShardedEnv`): each
  shard's `_advance` and `_observe` as two graphs on the shard's device
  over one set of buffers (`ShardGraph`). Between the two replays runs
  only what must see every shard (with lidar noise, the batch's step-count
  sum: each shard's advance graph outputs its part, and the total is
  formed on the device and copied into every shard's buffer). A
  `rollout`'s policy sees the joined batch: on a mesh of one device one
  graph joins the shards' buffers, runs the policy and cuts its actions
  into the shards' action buffers; across devices the join and the cut
  are copies between replays around the policy's graph on the mesh's
  first device.
"""
import torch

from metadrive_ped_torch.core import launches, trace
from metadrive_ped_torch.core.structs import map_tensors

WARMUP_STEPS = 2


def leaves(tree):
    """The tensors of ``tree`` (a tensor, `_Tree`, or nest of tuples, lists
    and dicts of them) in `map_tensors` order."""
    out = []
    map_tensors(out.append, tree)
    return out


def signature(*trees):
    """Shape, dtype and device of every tensor of ``trees``: a key part."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(trees))


def _storage(t):
    return t.untyped_storage().data_ptr()


def _unaliased(tree, storages):
    """``tree`` with every tensor that shares storage with ``storages``
    cloned."""
    return map_tensors(lambda t: t.clone() if _storage(t) in storages else t, tree)


def _written(buffers, new, outs):
    """Write ``new``, which maps buffer names to trees, into those buffers
    leaf by leaf, after every tensor of ``new`` and ``outs`` that shares
    storage with a buffer is cloned (rule 3); returns ``outs``."""
    storages = {_storage(t) for t in leaves(buffers)}
    new, outs = _unaliased((new, outs), storages)
    for name, tree in new.items():
        for dst, src in zip(leaves(buffers[name]), leaves(tree)):
            dst.copy_(src)
    return outs


def _region(body):
    """The captured region of ``body(buffers) -> (new, outs)``: ``new``
    written into the buffers (`_written`); the region returns ``outs``."""
    return lambda buffers: _written(buffers, *body(buffers))


class CudaGraphCapture:
    """Captures on one CUDA device: warm-up on a side stream, then one
    `torch.cuda.CUDAGraph` a `capture`, on the same stream."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        trace.ready(device)

    def warm_up(self, fn, buffers):
        rng = torch.cuda.get_rng_state(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                fn(map_tensors(torch.clone, buffers))
        current.wait_stream(self.stream)
        torch.cuda.set_rng_state(rng, self.device)

    def capture(self, fn, buffers):
        """(the outputs of ``fn(buffers)``, the replay of its graph). A
        replay runs on its device's current stream."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph, stream=self.stream):
            outs = fn(buffers)
        return outs, graph.replay


def capture_backend(device):
    """The capture of ``device``: CUDA graphs on a CUDA device, None on the
    CPU, which has no graphs (its steps run eagerly)."""
    return CudaGraphCapture if device.type == "cuda" else None


class StepGraph:
    """One captured region over static buffers. ``inputs`` maps names to
    trees, cloned into the buffers, except the names in ``shared``, whose
    trees are taken as the buffers (another graph's). ``body(buffers)``
    returns (new, outs) as `_region` takes them; after a `replay` the
    buffers hold the new values and `outs` the outputs. ``warm_up=False``
    where the caller warmed the region up (`ShardGraph`)."""

    def __init__(self, key, capture, body, inputs, shared=(), warm_up=True):
        self.key = key
        self.buffers = {k: v if k in shared else map_tensors(torch.clone, v)
                        for k, v in inputs.items()}
        self._storages = {_storage(t) for t in leaves(self.buffers)}
        region = _region(body)
        if warm_up:
            with launches.uncounted(), trace.muted():
                capture.warm_up(region, self.buffers)
        with launches.capturing() as self.tally:
            self.outs, self._replay = capture.capture(region, self.buffers)
        self.state = self.buffers.get("state")

    def load(self, inputs):
        """Copy in every leaf of ``inputs`` whose storage is not its
        buffer's (rule 2); a leaf that is another buffer is cloned first."""
        pairs = [(b, t) for k, tree in inputs.items()
                 for b, t in zip(leaves(self.buffers[k]), leaves(tree))
                 if t.data_ptr() != b.data_ptr() or t.stride() != b.stride()]
        sources = [_unaliased(t, self._storages) for _, t in pairs]
        for (b, _), t in zip(pairs, sources):
            b.copy_(t)

    def replay(self):
        self._replay()
        launches.replayed(self.tally)


def _last_obs(graph):
    """The observation after a step graph's replay: its buffer where the
    step reads it, else its output."""
    return graph.buffers.get("obs", graph.outs[0])


class _Slots:
    """The newest graph of each slot, and how many were captured."""

    captures = 0

    def _graph(self, slot, key, build, fresh=False):
        """The graph in ``slot``, built anew by ``build()`` when its key is
        not ``key`` or ``fresh`` (the old graph is released first)."""
        graph = getattr(self, slot)
        if graph is None or graph.key != key or fresh:
            # drop every reference to the old graph first: its memory pool
            # is freed before the new capture takes one
            graph = None
            setattr(self, slot, None)
            graph = build()
            setattr(self, slot, graph)
            self.captures += 1
        return graph


class EnvGraphs(_Slots):
    """The step graph, the rollout graph and the frame graph of one env (the
    newest key of each), how many times they were captured, and how many
    steps and frames were replayed."""

    def __init__(self, capture_cls, device):
        self._capture_cls, self._device = capture_cls, device
        self._step = self._rollout = self._frame = None
        self.replays = self.frame_replays = 0
        # the state buffers of the graph that stepped the env last (None:
        # none did); the frame graph reads them
        self.stepped = None

    def _loaded(self, slot, key, body, inputs):
        graph = self._graph(slot, key, lambda: StepGraph(
            key, self._capture_cls(self._device), self._stamped(body), inputs))
        graph.load(inputs)
        return graph

    def _stamped(self, body):
        """``body`` with its write-back (`_written`) inside it: the device
        span `replay`, the write-back the span `graph.writeback` (rule 8)."""
        def run(b):
            with trace.stage("replay", self._device):
                new, outs = body(b)
                with trace.stage("graph.writeback", self._device):
                    return {}, _written(b, new, outs)
        return run

    @staticmethod
    def _inputs(env, actions, reads_obs):
        inputs = dict(state=env._state, actions=actions)
        if reads_obs:
            if env._last_obs is None:
                raise RuntimeError("reset() the env first: this step reads the last observation")
            inputs["obs"] = env._last_obs
        return inputs

    def _stepped(self, env, graph):
        env._state, env._last_obs = graph.state, _last_obs(graph)
        self.stepped = graph.state

    def step(self, env, actions):
        """`_step_impl` with the actions [rows, 2] and, where the env reads
        it (`_prev_obs`), the last observation: (obs, reward, terminated,
        truncated, info), clones of the graph's outputs."""
        reads_obs = env._prev_obs() is not None

        def body(b):
            state, obs, reward, terminated, truncated, info = env._step_impl(
                b["state"], b["actions"], b.get("obs"))
            new = dict(state=state, obs=obs) if "obs" in b else dict(state=state)
            return new, (obs, (reward, terminated, truncated, info))

        with trace.span("step.load"):
            key = (reads_obs, env.num_scenarios, signature(env._state, actions), trace.enabled)
            graph = self._loaded("_step", key, body, self._inputs(env, actions, reads_obs))
        with trace.span("step.replay"):
            graph.replay()
        self.replays += 1
        self._stepped(env, graph)
        with trace.span("step.clone"):
            return (env._last_obs.clone(),) + map_tensors(torch.clone, graph.outs[1])

    def rollout(self, env, n_steps, policy_fn, actions, collect):
        """``n_steps`` replays of the step with ``policy_fn(obs, state)`` or
        the fixed ``actions``: the collected fields stacked over steps.
        Where the env renders frames (`_frames`), the region also renders
        the stepped state's frame and rolls the image stack, a buffer
        ("image") as the state is, which ``"image"`` collects and which is
        ``env._img_stack`` after the call."""
        collect = tuple(collect)
        frames = env._frames()

        def body(b):
            act = policy_fn(b["obs"], b["state"]) if policy_fn is not None else b["actions"]
            state, obs, reward, terminated, truncated, info = env._step_impl(b["state"], act)
            special = dict(reward=reward, obs=obs, terminated=terminated, truncated=truncated,
                           **env._rollout_fields(state))
            new = dict(state=state, obs=obs) if "obs" in b else dict(state=state)
            if frames:
                new["image"] = special["image"] = env._rolled_stack(state, b["image"])
            return new, (obs, {k: special[k] if k in special else info[k] for k in collect})

        with trace.span("rollout.load"):
            key = (policy_fn, collect, env.num_scenarios, signature(env._state, actions),
                   trace.enabled)
            inputs = self._inputs(env, actions, policy_fn is not None)
            if frames:
                key += (signature(env._img_stack),)
                inputs["image"] = env._img_stack
            graph = self._loaded("_rollout", key, body, inputs)
        outs = _stacked(graph.outs[1], n_steps)
        for t in range(n_steps):
            with trace.span("rollout.replay"):
                graph.replay()
            with trace.span("rollout.collect"):
                _copy_step(outs, graph.outs[1], t)
        self.replays += n_steps
        self._stepped(env, graph)
        if frames:
            env._img_stack = graph.buffers["image"]
        return outs

    def frame(self, env, spec, render):
        """``render(state)`` replayed over ``env._state``: the graph's
        output, overwritten by the next frame. ``spec`` (modality, width,
        height), the state's shapes and whether tracing is on key the
        graph. Where the state is the buffers of the graph that stepped the
        env last, the frame graph reads them; a state rebound since
        (`reset`, `restore`) is copied into its buffers, which become
        ``env._state``."""
        state = env._state
        stepped = state is self.stepped
        key = (spec, signature(state), trace.enabled)
        # a frame graph that reads other buffers than the stepping graph's
        # is captured again over the stepping graph's
        fresh = stepped and self._frame is not None and self._frame.state is not state
        graph = self._graph("_frame", key, lambda: StepGraph(
            key, self._capture_cls(self._device), lambda b: ({}, render(b["state"])),
            dict(state=state), shared=("state",) if stepped else ()), fresh=fresh)
        graph.load(dict(state=state))
        env._state = graph.state
        graph.replay()
        self.frame_replays += 1
        return graph.outs


def _stacked(fields, n_steps):
    """Empty ``[n_steps, ...]`` tensors shaped as the tensors of ``fields``."""
    return map_tensors(lambda t: t.new_empty((n_steps,) + tuple(t.shape)), fields)


def _copy_step(outs, fields, t):
    for dst, src in zip(leaves(outs), leaves(fields)):
        dst[t].copy_(src)


class ShardGraph:
    """One shard's step on its device as two graphs over one set of buffers
    (``inputs``: "state", "actions" and "obs", the last observation, each
    cloned): ``advance(buffers)`` and ``observe(buffers, advance's
    outputs)``, each returning (new, outs) as `_region` takes them. They
    warm up once, together, as one step."""

    def __init__(self, capture, advance, observe, inputs):
        buffers = {k: map_tensors(torch.clone, v) for k, v in inputs.items()}
        adv = _region(advance)
        with launches.uncounted(), trace.muted():
            capture.warm_up(_region(lambda b: observe(b, adv(b))), buffers)
        self.advance = StepGraph(None, capture, advance, buffers, tuple(buffers), warm_up=False)
        self.observe = StepGraph(None, capture, lambda b: observe(b, self.advance.outs),
                                 buffers, tuple(buffers), warm_up=False)
        self.buffers, self.load = buffers, self.advance.load


def refuse_sharded_image(collect):
    """A sharded rollout renders no frame: it cannot collect "image"."""
    if "image" in collect:
        raise ValueError('a ShardedEnv rollout renders no frame and cannot collect "image": '
                         "step the env, or roll it out unsharded")


def _join_into(dst, parts):
    """Copy the shards' trees ``parts`` into the joined tree ``dst`` (rows
    along the first axis, in shard order; a 0-d leaf from the first
    shard), as `ShardedEnv._gather` joins them."""
    for d, *ps in zip(leaves(dst), *map(leaves, parts)):
        if d.dim() == 0:
            d.copy_(ps[0])
            continue
        r = 0
        for p in ps:
            d[r:r + p.shape[0]].copy_(p)
            r += p.shape[0]


class _ShardedStep:
    """The graphs of one key of a `ShardedGraphs`: a `ShardGraph` a shard
    and, with a policy, the policy's graph on the mesh's first device."""

    def __init__(self, key, capture_cls, senv, blocks, advance, observe, policy_fn):
        self.key = key
        self.shards = [ShardGraph(capture_cls(sh.device), advance(sh), observe(sh),
                                  dict(state=sh._state, actions=a, obs=sh._last_obs))
                       for sh, a in zip(senv.shards, blocks)]
        self.policy = None
        if policy_fn is not None:
            self._capture_policy(capture_cls, senv, policy_fn)

    def _capture_policy(self, capture_cls, senv, policy_fn):
        """The policy's graph over the joined batch's own buffers ("obs",
        "state") on the mesh's first device. On a mesh of one device the
        graph also joins the shards' buffers into them and cuts the actions
        into the shards' action buffers; across devices those copies run
        around its replay (`replay`)."""
        self._one_device = len(set(senv.mesh)) == 1
        shards = {k: [u.buffers[k] for u in self.shards] for k in ("obs", "state", "actions")}
        inputs = dict(obs=senv._gather(shards["obs"]), state=senv._gather(shards["state"]))
        self._parts = shards
        if self._one_device:
            inputs.update(shard_obs=shards["obs"], shard_state=shards["state"],
                          actions=shards["actions"])

        def body(b):
            if self._one_device:
                _join_into(b["obs"], b["shard_obs"])
                _join_into(b["state"], b["shard_state"])
            act = policy_fn(b["obs"], b["state"])
            return (dict(actions=senv._cut(act)) if self._one_device else {}), act

        self.policy = StepGraph(None, capture_cls(senv.mesh[0]), body, inputs,
                                shared=("shard_obs", "shard_state", "actions"))

    def replay(self, senv):
        """One sharded step: the policy (with one), every shard's advance,
        the noise's batch step-count sum, every shard's observe."""
        if self.policy is not None:
            if not self._one_device:
                _join_into(self.policy.buffers["obs"], self._parts["obs"])
                _join_into(self.policy.buffers["state"], self._parts["state"])
            self.policy.replay()
            if not self._one_device:
                act, r = self.policy.outs, 0
                for a in self._parts["actions"]:
                    a.copy_(act[r:r + a.shape[0]])
                    r += a.shape[0]
        for u in self.shards:
            u.advance.replay()
        if senv._noisy:
            senv._hand_out_step_sum([u.advance.outs[1] for u in self.shards])
        for u in self.shards:
            u.observe.replay()


class ShardedGraphs(_Slots):
    """The captured steps of a `parallel.ShardedEnv`: the newest `step` key
    and the newest `rollout` key, each a `ShardGraph` a shard (and the
    policy's graph); how many times they were captured, how many sharded
    steps were replayed, and each shard's replays."""

    def __init__(self, capture_cls, n_shards):
        self._capture_cls = capture_cls
        self._step = self._rollout = None
        self.replays = 0
        self.shard_replays = [0] * n_shards

    @staticmethod
    def _observe(sh):
        def body(b, adv):
            return dict(obs=sh._observe(b["state"], *adv[0])), ()
        return body

    def _loaded(self, slot, key, senv, blocks, advance, policy_fn=None):
        if any(sh._state is None or sh._last_obs is None for sh in senv.shards):
            raise RuntimeError("reset() the env first")
        unit = self._graph(slot, key, lambda: _ShardedStep(
            key, self._capture_cls, senv, blocks, advance, self._observe, policy_fn))
        for u, sh, a in zip(unit.shards, senv.shards, blocks):
            inputs = dict(state=sh._state, obs=sh._last_obs)
            if policy_fn is None:
                inputs["actions"] = a
            u.load(inputs)
        return unit

    def _replayed(self, senv, unit, steps):
        """Count ``steps`` replays and leave every shard's state and last
        observation in its buffers (the frame graph reads them)."""
        self.replays += steps
        for k, (u, sh) in enumerate(zip(unit.shards, senv.shards)):
            self.shard_replays[k] += steps
            sh._state, sh._last_obs = u.buffers["state"], u.buffers["obs"]
            sh._graphs_or_none().stepped = sh._state

    def step(self, senv, blocks):
        """Every shard's `_advance` (reading the last observation where the
        env does, `_prev_obs`) on its actions block and `_observe`, replayed:
        each shard's (reward, terminated, truncated, info), the graphs'
        outputs, overwritten by the next step."""
        reads_obs = senv.shards[0]._prev_obs() is not None

        def advance(sh):
            def body(b):
                state, args, *outs = sh._advance(b["state"], b["actions"],
                                                 b["obs"] if reads_obs else None)
                return dict(state=state), (args, senv._step_sum(state), tuple(outs))
            return body

        states = [sh._state for sh in senv.shards]
        key = (reads_obs, senv.num_scenarios, signature(states, blocks), trace.enabled)
        unit = self._loaded("_step", key, senv, blocks, advance)
        unit.replay(senv)
        self._replayed(senv, unit, 1)
        return [u.advance.outs[2] for u in unit.shards]

    def rollout(self, senv, n_steps, policy_fn, blocks, collect):
        """``n_steps`` sharded steps replayed with ``policy_fn(obs, state)``
        on the joined batch or the fixed actions ``blocks``: each shard's
        collected fields stacked over steps."""
        collect = tuple(collect)
        refuse_sharded_image(collect)

        def advance(sh):
            def body(b):
                state, args, reward, terminated, truncated, info = sh._advance(
                    b["state"], b["actions"])
                special = dict(reward=reward, terminated=terminated, truncated=truncated,
                               **sh._rollout_fields(state))
                fields = {k: special[k] if k in special else info[k]
                          for k in collect if k != "obs"}
                return dict(state=state), (args, senv._step_sum(state), fields)
            return body

        states = [sh._state for sh in senv.shards]
        key = (policy_fn, collect, senv.num_scenarios, signature(states, blocks), trace.enabled)
        unit = self._loaded("_rollout", key, senv, blocks, advance, policy_fn)
        fields = [{k: u.buffers["obs"] if k == "obs" else u.advance.outs[2][k] for k in collect}
                  for u in unit.shards]
        outs = [_stacked(f, n_steps) for f in fields]
        for t in range(n_steps):
            unit.replay(senv)
            for o, f in zip(outs, fields):
                _copy_step(o, f, t)
        self._replayed(senv, unit, n_steps)
        return outs
