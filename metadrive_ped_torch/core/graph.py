"""A vector env's step captured as one CUDA graph and replayed once a step.

The JAX package compiles its step once,
``self._step_jit = jax.jit(self._step_impl, donate_argnums=0)``
(metadrive_ped_tpu/envs/base.py:322), and runs `rollout` "entirely
on-device via lax.scan (no per-step host dispatch)"
(metadrive_ped_tpu/envs/base.py:497-529), compiled again only when its key
``(id(policy_fn), collect, n_steps, num_scenarios)`` changes. PyTorch runs
eagerly: the host dispatches each of a step's thousands of kernels. Here
the step is captured once into a `torch.cuda.CUDAGraph`, and every later
step is one replay of it.

A `StepGraph` holds static input buffers (the state tree, the actions, and
the last observation where the step reads it: a policy, or the AI
protector's previous observation) and one graph whose captured region is
the policy, `_step_impl`, a leafwise copy of the new state and observation
back into the input buffers (the counterpart of ``donate_argnums=0``, so a
step is one replay and nothing more) and the step's outputs. The rules:

1. **Keys.** `rollout` captures again when ``(policy_fn, collect,
   num_scenarios, shapes)`` changes: JAX's key without ``n_steps``, since
   one graph serves every length. `step` captures again when
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
   tally to the kernels' counts, so a count stays the kernel's executions.
7. **No fallback.** On a CUDA device `step` and `rollout` capture or
   raise. The CPU has no graphs and runs the eager loop.
"""
import torch

from metadrive_ped_torch.core import launches
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


class CudaGraphCapture:
    """The capture on a CUDA device: warm-up on a side stream, then one
    `torch.cuda.CUDAGraph` of ``fn(buffers)``."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph = None

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
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph, stream=self.stream):
            outs = fn(buffers)
        self.graph = graph
        return outs

    def replay(self):
        self.graph.replay()


def capture_backend(device):
    """The capture of ``device``: CUDA graphs on a CUDA device, None on the
    CPU, which has no graphs (its steps run eagerly)."""
    return CudaGraphCapture if device.type == "cuda" else None


class StepGraph:
    """One captured step. ``inputs`` maps "state", "actions" and, where the
    step reads it, "obs" to the current tensors; ``body(buffers)`` returns
    (new state, new obs, outputs). After a `replay`, `state` and `obs` hold
    the new state and observation, and `outs` the outputs."""

    def __init__(self, key, capture, body, inputs):
        self.key = key
        self.buffers = {k: map_tensors(torch.clone, v) for k, v in inputs.items()}
        self._storages = {_storage(t) for t in leaves(self.buffers)}
        with launches.uncounted():
            capture.warm_up(self._region(body), self.buffers)
        with launches.capturing() as self.tally:
            obs, self.outs = capture.capture(self._region(body), self.buffers)
        self._capture = capture
        self.state = self.buffers["state"]
        self.obs = self.buffers.get("obs", obs)

    @staticmethod
    def _region(body):
        def run(buffers):
            new_state, new_obs, outs = body(buffers)
            storages = {_storage(t) for t in leaves(buffers)}
            new_state, new_obs, outs = _unaliased((new_state, new_obs, outs), storages)
            for dst, src in zip(leaves(buffers["state"]), leaves(new_state)):
                dst.copy_(src)
            if "obs" in buffers:
                buffers["obs"].copy_(new_obs)
            return new_obs, outs
        return run

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
        self._capture.replay()
        launches.replayed(self.tally)


class EnvGraphs:
    """The step graph and the rollout graph of one env (the newest key of
    each), and how many times they were captured and replayed."""

    def __init__(self, capture_cls, device):
        self._capture_cls, self._device = capture_cls, device
        self._step = self._rollout = None
        self.captures = self.replays = 0

    def _graph(self, slot, key, body, inputs):
        """The graph in ``slot`` loaded with ``inputs``, captured anew when
        its key is not ``key`` (the old graph is released first)."""
        graph = getattr(self, slot)
        if graph is None or graph.key != key:
            # drop every reference to the old graph first: its memory pool
            # is freed before the new capture takes one
            graph = None
            setattr(self, slot, None)
            graph = StepGraph(key, self._capture_cls(self._device), body, inputs)
            setattr(self, slot, graph)
            self.captures += 1
        graph.load(inputs)
        return graph

    @staticmethod
    def _inputs(env, actions, reads_obs):
        inputs = dict(state=env._state, actions=actions)
        if reads_obs:
            if env._last_obs is None:
                raise RuntimeError("reset() the env first: this step reads the last observation")
            inputs["obs"] = env._last_obs
        return inputs

    def step(self, env, actions):
        """`_step_impl` with the actions [rows, 2] and, where the env reads
        it (`_prev_obs`), the last observation: (obs, reward, terminated,
        truncated, info), clones of the graph's outputs."""
        reads_obs = env._prev_obs() is not None

        def body(b):
            state, obs, reward, terminated, truncated, info = env._step_impl(
                b["state"], b["actions"], b.get("obs"))
            return state, obs, (reward, terminated, truncated, info)

        key = (reads_obs, env.num_scenarios, signature(env._state, actions))
        graph = self._graph("_step", key, body, self._inputs(env, actions, reads_obs))
        graph.replay()
        self.replays += 1
        env._state, env._last_obs = graph.state, graph.obs
        return (graph.obs.clone(),) + map_tensors(torch.clone, graph.outs)

    def rollout(self, env, n_steps, policy_fn, actions, collect):
        """``n_steps`` replays of the step with ``policy_fn(obs, state)`` or
        the fixed ``actions``: the collected fields stacked over steps."""
        collect = tuple(collect)

        def body(b):
            act = policy_fn(b["obs"], b["state"]) if policy_fn is not None else b["actions"]
            state, obs, reward, terminated, truncated, info = env._step_impl(b["state"], act)
            special = dict(reward=reward, obs=obs, terminated=terminated, truncated=truncated,
                           **env._rollout_fields(state))
            return state, obs, {k: special[k] if k in special else info[k] for k in collect}

        key = (policy_fn, collect, env.num_scenarios, signature(env._state, actions))
        graph = self._graph("_rollout", key, body,
                            self._inputs(env, actions, policy_fn is not None))
        outs = map_tensors(lambda t: t.new_empty((n_steps,) + tuple(t.shape)), graph.outs)
        pairs = list(zip(leaves(outs), leaves(graph.outs)))
        for t in range(n_steps):
            graph.replay()
            for dst, src in pairs:
                dst[t].copy_(src)
        self.replays += n_steps
        env._state, env._last_obs = graph.state, graph.obs
        return outs
