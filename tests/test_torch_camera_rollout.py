"""The camera observation through `rollout` (envs/base.py, core/graph.py) on
the CPU at 2 envs and 32x24 frames: eager and replayed (through
tests/test_torch_graph.py's `EagerGraph` stand-in), rollouts equal the
same number of `step` calls from one reset bit for bit (the image stack,
the state observation, reward and the done flags, across auto-resets and
from one call to the next) and leave the stack a `step` continues; an env without the camera renders
nothing in `rollout` and cannot collect "image"; `ShardedEnv` refuses to
collect it; and the program's `ops/camera.render` equals the benchmark's
frozen reference copy on seeded random poses, bodies and scenes."""
import functools
import types

import pytest
import torch
from test_torch_graph import EagerGraph

import metadrive_ped_torch as T
from benchmarks.reference.ops import camera as ref_camera
from metadrive_ped_torch.core import graph
from metadrive_ped_torch.core.structs import map_tensors
from metadrive_ped_torch.ops import camera
from metadrive_ped_torch.parallel import ShardedEnv

E = 2
CFG = dict(num_envs=E, map="SCS", num_scenarios=2, traffic_density=0.1, horizon=6,
           image_observation=True, stack_size=3, sensors=dict(main_camera=("rgb", 32, 24)))
COLLECT = ("obs", "image", "reward", "terminated", "truncated")
FULL = torch.tensor([[0.0, 1.0]] * E)
STEPS = 10


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the small frames: with a thread a core in
    every test process, the frames' elementwise kernels contend for the
    cores and run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["eager", "replayed"])
def path(request, monkeypatch):
    if request.param == "replayed":
        monkeypatch.setattr(graph, "capture_backend", lambda device: EagerGraph)
    return request.param


def _pair(cfg=CFG):
    a, b = T.MetaDriveEnv(cfg, device="cpu"), T.MetaDriveEnv(cfg, device="cpu")
    a.reset(seed=5)
    b.reset(seed=5)
    return a, b


def _steps(env, n):
    """``n`` `step` calls, their outputs stacked over steps as `rollout`
    collects them."""
    outs = [map_tensors(torch.clone, env.step(FULL)) for _ in range(n)]
    return dict(obs=torch.stack([o[0]["state"] for o in outs]),
                image=torch.stack([o[0]["image"] for o in outs]),
                reward=torch.stack([o[1] for o in outs]),
                terminated=torch.stack([o[2] for o in outs]),
                truncated=torch.stack([o[3] for o in outs]))


@pytest.mark.parametrize("modality", ["rgb", "depth"])
def test_image_rollout_equals_steps(path, modality):
    """Rollouts of 4 and 6 steps against 10 steps: the stack carries over
    from one call to the next."""
    cfg = dict(CFG, sensors=dict(main_camera=(modality, 32, 24)))
    a, b = _pair(cfg)
    parts = [a.rollout(n, actions=FULL, collect=COLLECT)[0] for n in (4, STEPS - 4)]
    rolled = {k: torch.cat([p[k] for p in parts]) for k in COLLECT}
    stepped = _steps(b, STEPS)
    C = 1 if modality == "depth" else 3
    assert rolled["image"].shape == (STEPS, E, 24, 32, C, 3)
    for k in COLLECT:
        assert torch.equal(rolled[k], stepped[k]), k
    assert bool((stepped["terminated"] | stepped["truncated"]).any()), "an auto-reset"
    assert torch.equal(a._img_stack, b._img_stack)
    if path == "replayed":
        assert a._graphs._rollout.key[-1] == graph.signature(a._img_stack)
        assert a._img_stack is a._graphs._rollout.buffers["image"]
    # a step after the rollout continues its stack
    assert torch.equal(a.step(FULL)[0]["image"], b.step(FULL)[0]["image"])


def test_an_image_env_rolls_its_stack_when_image_is_not_collected(path):
    a, b = _pair()
    a.rollout(4, actions=FULL, collect=("reward",))
    _steps(b, 4)
    assert torch.equal(a._img_stack, b._img_stack)


def test_without_the_camera_rollout_renders_nothing(path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("rendered a frame")
    monkeypatch.setattr(camera, "render", refuse)
    env = T.MetaDriveEnv(dict(CFG, image_observation=False), device="cpu")
    env.reset(seed=5)
    outs, _ = env.rollout(4, actions=FULL, collect=("obs", "reward"))
    assert set(outs) == {"obs", "reward"}
    assert env._img_stack is None
    for roll in (env.rollout, env._rollout_eager):
        with pytest.raises(ValueError, match="image"):
            roll(2, actions=FULL, collect=("reward", "image"))
    if path == "replayed":
        assert len(env._graphs._rollout.key) == 5


def test_sharded_env_refuses_to_collect_the_image(path):
    senv = ShardedEnv(T.MetaDriveEnv(dict(CFG, num_envs=4), device="cpu"), ["cpu"] * 2)
    senv.reset(seed=5)
    act = torch.tensor([[0.0, 1.0]] * 4)
    for roll in (senv.rollout, senv._rollout_eager):
        with pytest.raises(ValueError, match="image"):
            roll(2, actions=act, collect=("reward", "image"))
    outs, _ = senv.rollout(2, actions=act, collect=("reward",))
    assert outs["reward"].shape == (2, 4)


def _random_case(seed, E=5, bodies=9, width=20, height=14):
    """An env's scene and seeded random camera poses (on and off the road),
    bodies (sizes, headings, some inactive) and scenario rows."""
    g = torch.Generator().manual_seed(seed)
    scene = _scene()
    sidx = torch.randint(0, scene.num_scenarios, (E,), generator=g).int()
    lanes = scene.lane_p0[sidx.long(), 0]
    pos = lanes + torch.randn(E, 2, generator=g) * 6.0
    length = 4 + torch.rand(E, generator=g)
    ego = types.SimpleNamespace(pos=pos, heading=torch.rand(E, generator=g) * 6.3 - 3.15,
                                params=types.SimpleNamespace(length=length))
    t_pos = pos[:, None] + torch.randn(E, bodies, 2, generator=g) * 12.0
    rand = lambda: torch.rand(E, bodies, generator=g)  # noqa: E731
    targets = (t_pos, rand() * 6.3 - 3.15, 1 + 4 * rand(), 0.5 + 2 * rand(), rand() < 0.7)
    slices = dict(npc=slice(0, 5), obj=slice(5, 7), ped=slice(7, 9))
    obj_kind = torch.randint(0, 4, (E, 2), generator=g)
    return (scene, sidx, ego, targets, slices, obj_kind), dict(width=width, height=height,
                                                                pitch_deg=float(seed % 3) * 4.0)


@functools.lru_cache(maxsize=None)
def _scene():
    return T.MetaDriveEnv(dict(num_envs=2, map="SCS", num_scenarios=3, traffic_density=0.3),
                          device="cpu").scene


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_program_camera_equals_the_reference_copy(seed, monkeypatch):
    """Every modality bit for bit, in one chunk of rows and in chunks of
    two rows."""
    args, kw = _random_case(seed)
    for chunk in (None, 2):
        if chunk:
            for mod in (camera, ref_camera):
                monkeypatch.setattr(mod, "RENDER_CHUNK_ELEMENTS", 2 * kw["width"] * kw["height"]
                                    * max(args[0].lane_kind.shape[1], args[0].seg_type.shape[1]))
        ours, ref = camera.render(*args, **kw), ref_camera.render(*args, **kw)
        assert set(ours) == set(ref) == {"depth", "semantic", "rgb", "instance"}
        for k in ours:
            assert torch.equal(ours[k], ref[k]), (k, chunk)
        sem = ours["semantic"].reshape(-1, 3)
        assert len(torch.unique(sem, dim=0)) >= 4, "the case draws sky, ground, lines and bodies"


@pytest.mark.parametrize("modality", camera.MODALITIES)
def test_render_gives_only_the_modalities_asked_for(modality):
    """`render(..., modalities=(m,))` is `render(...)[m]`, and nothing else."""
    args, kw = _random_case(4)
    one = camera.render(*args, **kw, modalities=(modality,))
    assert list(one) == [modality]
    assert torch.equal(one[modality], camera.render(*args, **kw)[modality])


def test_render_takes_the_plain_chain_for_cpu_tensors(monkeypatch):
    """On CPU tensors `render` is `render_plain` and launches nothing; an
    unknown modality, or a device that is neither cpu nor cuda, raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("launched the kernel")
    monkeypatch.setattr(camera, "_render_kernel", refuse)
    args, kw = _random_case(5)
    before = camera.launches
    ours, plain = camera.render(*args, **kw), camera.render_plain(*args, **kw)
    assert list(ours) == list(camera.MODALITIES)
    for k in camera.MODALITIES:
        assert torch.equal(ours[k], plain[k]), k
    assert camera.launches == before
    with pytest.raises(ValueError, match="modalities"):
        camera.render(*args, **kw, modalities=("rgb", "lidar"))
    scene, sidx, ego, *rest = args
    meta = types.SimpleNamespace(pos=ego.pos.to("meta"), heading=ego.heading.to("meta"),
                                 params=ego.params)
    with pytest.raises(ValueError, match="cpu or cuda"):
        camera.render(scene, sidx, meta, *rest, **kw)
