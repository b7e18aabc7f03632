"""The port's PPO trainer (examples/train_ppo.py) against the JAX package's,
and a smoke run of every ported example on the CPU.

The JAX trainer's `make_train_state` and `policy_forward` are module-level
functions and are called as they are. Its GAE, loss and update are closures
inside `main()` (metadrive_ped_tpu/examples/train_ppo.py:96-164), so the
references below write them out from those lines with `jax.grad` and
`optax.adam`. Parameters go between the packages as numpy arrays
(`params_from_jax` / `params_to_jax`). Tolerances: initial parameters and
the sampled actions 1e-6 and 1e-5 (the normal twin, `prng.normal`, is
within 1e-6 of `jax.random.normal`), the forward pass 1e-5, GAE 1e-6, the
loss and its gradients 1e-5, one PPO update 1e-5 where Adam's first step
is well conditioned (see `test_ppo_update_matches_jax`)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metadrive_ped_torch.core import prng
from metadrive_ped_torch.examples import train_ppo as ppo
from metadrive_ped_torch.policies.expert import load_expert_params
from metadrive_ped_tpu.examples.train_ppo import make_train_state, policy_forward

OBS_DIM, B, CLIP, LR = 275, 64, 0.2, 3e-4
# elements Adam's first step may exempt from the update's 1e-5 (6 here)
EXEMPT_CAP = 16


def _jax_params(seed):
    """Trained-looking parameters: the JAX initial state plus noise, so
    that every layer matters."""
    params, _, _ = make_train_state(jax.random.PRNGKey(seed), OBS_DIM, LR)
    rng = np.random.RandomState(seed)
    return {k: (np.asarray(v) + 0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in params.items()}


def _batch(params, seed):
    """(obs, act, adv, ret, logp_old) of B samples; logp_old is the policy's
    own log-density moved by noise, so that some ratios leave the clip band."""
    rng = np.random.RandomState(seed)
    obs = rng.uniform(0, 1, (B, OBS_DIM)).astype(np.float32)
    act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    adv = rng.normal(0, 1, B).astype(np.float32)
    ret = rng.normal(0, 1, B).astype(np.float32)
    mean, log_std, _ = policy_forward(params, jnp.asarray(obs))
    logp = np.asarray(_jax_logp(mean, log_std, jnp.asarray(act)))
    logp_old = (logp + rng.normal(0, 0.3, B)).astype(np.float32)
    return obs, act, adv, ret, logp_old


def _jax_logp(mean, log_std, a):
    std = jnp.exp(log_std)
    return (-0.5 * ((a - mean) / std) ** 2 - log_std - 0.5 * np.log(2 * np.pi)).sum(-1)


def _jax_loss(params, o, a, adv, ret, lp_old, clip=CLIP):
    """loss_fn of train_ppo.py:111-127."""
    mean, log_std, value = policy_forward(params, o)
    ratio = jnp.exp(_jax_logp(mean, log_std, a) - lp_old)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg = -jnp.minimum(ratio * adv_n, jnp.clip(ratio, 1 - clip, 1 + clip) * adv_n).mean()
    vf = 0.5 * ((value - ret) ** 2).mean()
    ent = (log_std + 0.5 * np.log(2 * np.pi * np.e)).sum(-1).mean()
    return pg + 0.5 * vf - 1e-3 * ent


def _jax_update(params, batch, idx, epochs, minibatches):
    """ppo_update of train_ppo.py:108-147: the same permutation ``idx`` in
    every epoch, one optax.adam step per minibatch."""
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    mb = batch[0].shape[0] // minibatches
    for _ in range(epochs):
        for i in range(minibatches):
            sl = idx[i * mb:(i + 1) * mb]
            g = jax.grad(_jax_loss)(params, *(jnp.asarray(x)[sl] for x in batch))
            updates, opt_state = tx.update(g, opt_state)
            params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def _jax_gae(values, rewards, dones, last_value, gamma=0.99, lam=0.95):
    """compute_gae of train_ppo.py:149-164."""
    def rev_body(gae, xs):
        r, v, nv, d = xs
        delta = r + gamma * nv * (1.0 - d) - v
        gae = delta + gamma * lam * (1.0 - d) * gae
        return gae, gae

    next_values = jnp.concatenate([values[1:], last_value[None]], axis=0)
    _, adv = jax.lax.scan(rev_body, jnp.zeros_like(last_value),
                          (rewards, values, next_values, dones), reverse=True)
    return adv, adv + values


def _close(a, b, atol, name=""):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=atol, err_msg=name)


def test_init_matches_jax():
    """PolicyValue drawn from the threefry twin of PRNGKey(0) equals
    make_train_state's parameters (shared keys for policy and value)."""
    ref, _, _ = make_train_state(jax.random.PRNGKey(0), OBS_DIM, LR)
    ours = ppo.params_to_jax(ppo.PolicyValue(OBS_DIM, key=prng.prng_key(0), device="cpu"))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].shape == np.shape(ref[k]) and ours[k].dtype == np.float32
        _close(ref[k], ours[k], 1e-6, k)


def test_params_round_trip():
    params = _jax_params(3)
    back = ppo.params_to_jax(ppo.params_from_jax(params, device="cpu"))
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])


def test_policy_forward_matches_jax():
    params = _jax_params(1)
    obs = np.random.RandomState(1).uniform(0, 1, (B, OBS_DIM)).astype(np.float32)
    ref = policy_forward(params, jnp.asarray(obs))
    with torch.no_grad():
        ours = ppo.params_from_jax(params, device="cpu")(torch.from_numpy(obs))
    for name, a, b in zip(("mean", "log_std", "value"), ref, ours):
        assert b.shape == a.shape
        _close(a, b, 1e-5, name)


def test_sample_policy_matches_jax():
    """The rollout policy: clip(mean + exp(log_std) * normal(fold_in(key,
    sum(step_count)))), as train_ppo.py:98-106, on the same obs and step
    counts."""
    params = _jax_params(2)
    obs = np.random.RandomState(2).uniform(0, 1, (8, OBS_DIM)).astype(np.float32)
    step_count = np.arange(8, dtype=np.int32) * 37
    key = jax.random.split(jax.random.PRNGKey(5), 3)[1]
    mean, log_std, _ = policy_forward(params, jnp.asarray(obs))
    k = jax.random.fold_in(key, jnp.sum(jnp.asarray(step_count)))
    ref = jnp.clip(mean + jnp.exp(log_std) * jax.random.normal(k, mean.shape), -1.0, 1.0)
    tkey = prng.split(prng.prng_key(5), 3)[1]
    state = type("State", (), dict(step_count=torch.from_numpy(step_count)))
    ours = ppo.sample_policy(ppo.params_from_jax(params, device="cpu"), tkey)(
        torch.from_numpy(obs), state)
    _close(ref, ours, 1e-5)


def test_gae_matches_jax():
    rng = np.random.RandomState(4)
    T, E = 16, 8
    values, rewards = (rng.normal(0, 1, (T, E)).astype(np.float32) for _ in range(2))
    dones = (rng.uniform(0, 1, (T, E)) < 0.15).astype(np.float32)
    last = rng.normal(0, 1, E).astype(np.float32)
    ref = _jax_gae(*map(jnp.asarray, (values, rewards, dones, last)))
    ours = ppo.compute_gae(*map(torch.from_numpy, (values, rewards, dones, last)), 0.99, 0.95)
    for a, b in zip(ref, ours):
        _close(a, b, 1e-6)


def test_loss_and_grads_match_jax():
    params = _jax_params(5)
    batch = _batch(params, 5)
    ref_loss, ref_grads = jax.value_and_grad(_jax_loss)(params, *map(jnp.asarray, batch))
    module = ppo.params_from_jax(params, device="cpu")
    loss = ppo.ppo_loss(module, *map(torch.from_numpy, batch), CLIP)
    loss.backward()
    _close(ref_loss, loss.detach(), 1e-5, "loss")
    for k in ppo.PARAM_NAMES:
        _close(ref_grads[k], getattr(module, k).grad, 1e-5, k)


def test_adam_matches_optax():
    """torch.optim.Adam (defaults) against optax.adam on the same gradients,
    three steps, tiny gradients (near Adam's eps = 1e-8) included."""
    rng = np.random.RandomState(7)
    p0 = rng.normal(0, 0.1, (64, 32)).astype(np.float32)
    grads = [rng.normal(0, 1e-3, p0.shape).astype(np.float32) for _ in range(3)]
    grads[0][:4] = rng.normal(0, 1e-8, (4, 32))
    tx = optax.adam(LR)
    ref, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    ours = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([ours], lr=LR)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state)
        ref = optax.apply_updates(ref, updates)
        ours.grad = torch.from_numpy(g)
        opt.step()
    _close(ref, ours.detach(), 1e-7)


def test_ppo_update_matches_jax():
    """One ppo_update (epochs 1, minibatches 2, 64 samples) from the same
    carried-across parameters with JAX's permutation handed in.

    Adam's first step moves a parameter by lr * g / (|g| + eps), eps = 1e-8.
    The two packages' float32 gradients of the first minibatch agree within
    1e-5 (`test_loss_and_grads_match_jax`; here they differ by up to 3e-8,
    the sums of the matrix products rounding in another order), and where g
    is near zero that step maps such a difference to up to lr itself. So
    the elements where lr * |g / (|g| + eps) - g' / (|g'| + eps)| of the two
    packages' first-minibatch gradients g, g' exceeds 5e-6 (6 of 274,181
    on this batch) are exempt, at most EXEMPT_CAP of them; every other
    element within 1e-5.
    `test_adam_matches_optax` holds the optimizer alone, tiny gradients
    included, within 1e-7; chip_smoke.py's ppo_card_vs_cpu applies the same
    rule between the card and the CPU."""
    params = _jax_params(6)
    batch = _batch(params, 6)
    idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(6), B))
    ref = _jax_update(params, batch, idx, epochs=1, minibatches=2)
    first = idx[:B // 2]
    g_jax = jax.grad(_jax_loss)(params, *(jnp.asarray(x)[first] for x in batch))
    probe = ppo.params_from_jax(params, device="cpu")
    ppo.ppo_loss(probe, *(torch.from_numpy(x[first]) for x in batch), CLIP).backward()
    module = ppo.params_from_jax(params, device="cpu")
    opt = torch.optim.Adam(module.parameters(), lr=LR)
    ppo.ppo_update(module, opt, tuple(map(torch.from_numpy, batch)), epochs=1, minibatches=2,
                   clip=CLIP, perm=torch.from_numpy(idx.copy()))
    ours = ppo.params_to_jax(module)
    moved = max(float(np.abs(ref[k] - params[k]).max()) for k in ref)
    assert moved > 1e-4, "the update moves the parameters"
    step = lambda g: g / (np.abs(g) + 1e-8)
    ill = {k: LR * np.abs(step(np.asarray(g_jax[k])) - step(getattr(probe, k).grad.numpy()))
           > 5e-6 for k in ref}
    assert sum(int(m.sum()) for m in ill.values()) <= EXEMPT_CAP
    for k in ref:
        _close(np.asarray(g_jax[k]), getattr(probe, k).grad, 1e-5, k)
        _close(np.where(ill[k], 0, ref[k]), np.where(ill[k], 0, ours[k]), 1e-5, k)


def test_save_loads_as_expert(tmp_path):
    path = str(tmp_path / "policy.npz")
    history = ppo.main(["--cpu", "--quick", "--save", path])
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    params = load_expert_params(path, device="cpu")
    with np.load(path) as saved:
        assert set(saved.files) == {"default_policy/fc_1/kernel", "default_policy/fc_1/bias",
                                    "default_policy/fc_2/kernel", "default_policy/fc_2/bias",
                                    "default_policy/fc_out/kernel", "default_policy/fc_out/bias"}
    assert params["w1"].shape == (OBS_DIM, 256) and params["w3"].shape == (256, 4)


# every ported example at its smallest size, with --cpu
EXAMPLES = {
    "train_ppo": ["--quick"],
    "drive_in_single_agent_env": ["-e", "2", "-n", "5"],
    "drive_in_safe_metadrive_env": ["-e", "2", "-n", "5"],
    "drive_in_multi_agent_env": ["--env", "tollgate", "-e", "1", "-n", "3"],
    "drive_in_real_env": ["-n", "5"],
    "custom_inramp_env": ["--num-envs", "2", "--steps", "5", "--start-seed", "0"],
    "procedural_generation": ["--num-maps", "1", "--blocks", "2"],
    "profile_metadrive": ["-n", "3", "-e", "2", "--num-scenarios", "1"],
    "profile_metadrive_marl": ["-n", "3", "-e", "1"],
    "profile_trace": ["-e", "2", "-n", "2", "--num-scenarios", "1"],
    "verify_headless_installation": [],
    "read_and_visualize_scenario_description": [],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    module = importlib.import_module(f"metadrive_ped_torch.examples.{name}")
    assert module.main(EXAMPLES[name] + ["--cpu"]) is not None
    assert capsys.readouterr().out.strip()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_needs_a_gpu_without_cpu_flag(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"metadrive_ped_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(EXAMPLES[name])


def test_single_agent_render_waits_for_the_renderer(tmp_path):
    """--render waited for the top-down renderer; it now writes the frame."""
    from metadrive_ped_torch.examples import drive_in_single_agent_env
    drive_in_single_agent_env.main(EXAMPLES["drive_in_single_agent_env"]
                                   + ["--cpu", "--render", str(tmp_path / "f.png")])
    assert [p.name for p in tmp_path.iterdir()] in (["f.png"], ["f.png.npy"])
