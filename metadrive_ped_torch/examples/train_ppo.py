"""PPO training on the vectorized MetaDriveEnv, on one GPU.

The batched twin of the reference's training entry
(metadrive/examples/train_generalization_experiment.py, which drives rllib
PPO over subprocess env workers): the simulator is the batch, so rollout
collection, GAE and the clipped-PPO update all run on one device with no
env workers. The policy is the 256x256 tanh MLP of the shipped expert
checkpoint (examples/ppo_expert/numpy_expert.py), so a trained policy
exports to the expert's .npz format (``--save``).

    python -m metadrive_ped_torch.examples.train_ppo --num-envs 512 --iters 20
    python -m metadrive_ped_torch.examples.train_ppo --cpu --quick  # smoke

The sampling policy draws its noise on the device from
``prng.fold_in(key, sum(step_count))``, so collection makes no host
synchronisation inside `rollout`. This is an example, not a tuned
baseline: reward curves depend on scale and iterations.
"""
import argparse
import math
import time

import numpy as np
import torch
from torch import nn

from metadrive_ped_torch.core import prng
from metadrive_ped_torch.examples import example_device, force_cpu_flag
from metadrive_ped_torch.policies.expert import _CHECKPOINT_KEYS

HIDDEN = 256
PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3", "vw1", "vb1", "vw2", "vb2", "vw3", "vb3")
LOG_2PI = 0.5 * math.log(2 * math.pi)
ENTROPY_CONST = 0.5 * math.log(2 * math.pi * math.e)


def env_config(num_envs, num_scenarios):
    """The training env: map 3, traffic 0.05, horizon 1000 and the expert's
    observation layout (lidar 240, 4 neighbours: 275 features)."""
    return dict(num_envs=num_envs, map=3, num_scenarios=num_scenarios, traffic_density=0.05,
                horizon=1000, vehicle_config=dict(lidar=dict(num_lasers=240, num_others=4)))


class PolicyValue(nn.Module):
    """Policy and value MLPs: obs -> 256 -> 256 (tanh) -> 4 (mean, log_std)
    and obs -> 256 -> 256 (tanh) -> 1. Parameters are stored [in, out] under
    the names of the checkpoint layout (w1, b1, ..., vb3)."""

    def __init__(self, obs_dim, key=None, device=None):
        super().__init__()
        shapes = dict(w1=(obs_dim, HIDDEN), b1=(HIDDEN,), w2=(HIDDEN, HIDDEN), b2=(HIDDEN,),
                      w3=(HIDDEN, 4), b3=(4,), vw1=(obs_dim, HIDDEN), vb1=(HIDDEN,),
                      vw2=(HIDDEN, HIDDEN), vb2=(HIDDEN,), vw3=(HIDDEN, 1), vb3=(1,))
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(torch.zeros(shapes[name], device=device)))
        if key is not None:
            self.reset_parameters(key)

    @torch.no_grad()
    def reset_parameters(self, key):
        """Normal weights scaled by 1/sqrt(fan_in), output layers by a further
        0.01, zero biases, from the threefry key ``key``; the policy and the
        value layers of one depth share their key, as the JAX trainer's
        make_train_state does."""
        keys = prng.split(key.to(self.w1.device), 3)
        for i, (w, v) in enumerate((("w1", "vw1"), ("w2", "vw2"), ("w3", "vw3"))):
            for name in (w, v):
                p = getattr(self, name)
                draw = prng.normal(keys[i], tuple(p.shape)) * float(1.0 / np.sqrt(p.shape[0]))
                p.copy_(draw * 0.01 if i == 2 else draw)
        for name in ("b1", "b2", "b3", "vb1", "vb2", "vb3"):
            getattr(self, name).zero_()

    def forward(self, obs):
        """obs [..., D] -> (mean [..., 2], log_std [..., 2] in [-5, 2],
        value [...])."""
        x = torch.tanh(obs @ self.w1 + self.b1)
        x = torch.tanh(x @ self.w2 + self.b2)
        out = x @ self.w3 + self.b3
        mean, log_std = out[..., :2], torch.clamp(out[..., 2:], -5.0, 2.0)
        v = torch.tanh(obs @ self.vw1 + self.vb1)
        v = torch.tanh(v @ self.vw2 + self.vb2)
        value = (v @ self.vw3 + self.vb3)[..., 0]
        return mean, log_std, value


def params_from_jax(params, device=None):
    """A `PolicyValue` holding ``params``, a dict of numpy arrays w1 ... vb3
    in the JAX trainer's layout ([in, out] weights)."""
    module = PolicyValue(np.asarray(params["w1"]).shape[0], device=device)
    with torch.no_grad():
        for name in PARAM_NAMES:
            getattr(module, name).copy_(torch.as_tensor(np.asarray(params[name], np.float32)))
    return module


def params_to_jax(module):
    """Inverse of `params_from_jax`: dict of numpy arrays w1 ... vb3."""
    return {name: getattr(module, name).detach().cpu().numpy() for name in PARAM_NAMES}


def save_expert_npz(module, path):
    """Write the policy half in the expert checkpoint's array names, which
    `policies.expert.load_expert_params` reads."""
    params = params_to_jax(module)
    np.savez(path, **{name: params[k] for k, name in _CHECKPOINT_KEYS.items()})


def log_prob(mean, log_std, act):
    """Diagonal Gaussian log-density of ``act``, summed over the last axis."""
    std = torch.exp(log_std)
    return (-0.5 * ((act - mean) / std) ** 2 - log_std - LOG_2PI).sum(-1)


def sample_policy(module, key):
    """policy_fn(obs, state) for `rollout`: the clipped Gaussian sample with
    noise `prng.normal(fold_in(key, sum(step_count)))`, drawn on the device
    with no host synchronisation. The JAX trainer's sum is int32 taken as
    uint32 bits; `fold_in` masks the int64 sum to the same 32 bits."""

    @torch.no_grad()
    def policy_fn(obs, state):
        mean, log_std, _ = module(obs)
        k = prng.fold_in(key, state.step_count.sum())
        return torch.clamp(mean + torch.exp(log_std) * prng.normal(k, tuple(mean.shape)),
                           -1.0, 1.0)

    return policy_fn


def compute_gae(values, rewards, dones, last_value, gamma, lam):
    """Generalised advantage estimates over [T, E] tensors, as a reverse
    loop over the rollout: (advantages, returns)."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    gae = torch.zeros_like(last_value)
    adv = []
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + gamma * next_values[t] * (1.0 - dones[t]) - values[t]
        gae = delta + gamma * lam * (1.0 - dones[t]) * gae
        adv.append(gae)
    adv = torch.stack(adv[::-1])
    return adv, adv + values


def ppo_loss(module, obs, act, adv, ret, logp_old, clip):
    """Clipped-PPO loss with a 0.5 value term and a 1e-3 entropy bonus;
    advantages are normalised with the population std (ddof 0)."""
    mean, log_std, value = module(obs)
    ratio = torch.exp(log_prob(mean, log_std, act) - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - clip, 1 + clip) * adv_n).mean()
    vf = 0.5 * ((value - ret) ** 2).mean()
    ent = (log_std + ENTROPY_CONST).sum(-1).mean()
    return pg + 0.5 * vf - 1e-3 * ent


def ppo_update(module, optimizer, batch, epochs, minibatches, clip, perm=None, generator=None):
    """``epochs`` passes over ``batch`` = (obs, act, adv, ret, logp_old)
    [B, ...], each in ``minibatches`` Adam steps over one permutation of the
    rows (``perm``, else a draw of ``generator``), as the JAX trainer's
    ppo_update. Returns the last minibatch's loss (a device tensor)."""
    obs_b = batch[0]
    B = obs_b.shape[0]
    if perm is None:
        perm = torch.randperm(B, generator=generator, device=obs_b.device)
    perm = torch.as_tensor(perm).to(obs_b.device)
    mb = B // minibatches
    loss = None
    for _ in range(epochs):
        for i in range(minibatches):
            sl = perm[i * mb:(i + 1) * mb]
            loss = ppo_loss(module, *(x[sl] for x in batch), clip)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
    return loss.detach()


def collect(env, module, key, n_steps, gamma, lam):
    """One rollout of the sampling policy and its GAE: (batch of flat [T*E,
    ...] tensors (obs, act, adv, ret, logp_old), mean step reward)."""
    # the obs the first action of this rollout sees; a clone, since on the
    # card the rollout overwrites the env's last observation in place
    obs0 = env._last_obs.clone()
    outs, mean_r = env.rollout(n_steps, policy_fn=sample_policy(module, key),
                               collect=("obs", "reward", "terminated", "truncated", "ego_action"))
    # rollout collects the post-step obs; a_t was sampled from the obs
    # before step t, so shift by one (at done steps outs["obs"][t] is already
    # the auto-reset obs of the next episode)
    obs_t = torch.cat([obs0[None], outs["obs"][:-1]], dim=0)
    act_t = outs["ego_action"]
    done_t = (outs["terminated"] | outs["truncated"]).float()
    with torch.no_grad():
        mean_a, log_std_a, val_t = module(obs_t)
        logp_t = log_prob(mean_a, log_std_a, act_t)
        last_v = module(env._last_obs)[2]
    adv, ret = compute_gae(val_t, outs["reward"], done_t, last_v, gamma, lam)
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    return tuple(map(flat, (obs_t, act_t, adv, ret, logp_t))), mean_r


def param_norm(module):
    return float(torch.sqrt(sum((p.detach() ** 2).sum() for p in module.parameters())))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_iteration(env, module, optimizer, key, args, generator=None):
    """Collect one rollout and run one PPO update. Returns the iteration's
    numbers: collect env-steps/s, update ms, samples/s, loss and the change
    of the parameter norm, with the batch it trained on."""
    device = env.device
    norm0 = param_norm(module)
    _sync(device)
    t0 = time.perf_counter()
    batch, mean_r = collect(env, module, key, args.rollout, args.gamma, args.lam)
    _sync(device)
    t1 = time.perf_counter()
    loss = ppo_update(module, optimizer, batch, args.epochs, args.minibatches, args.clip,
                      generator=generator)
    _sync(device)
    t2 = time.perf_counter()
    samples = batch[0].shape[0]
    stats = dict(mean_step_reward=mean_r, collect_env_steps_per_s=samples / (t1 - t0),
                 update_ms=(t2 - t1) * 1e3,
                 update_samples_per_s=samples * args.epochs / (t2 - t1),
                 loss=float(loss), param_norm=param_norm(module))
    stats["param_norm_change"] = stats["param_norm"] - norm0
    return stats, batch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--rollout", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--minibatches", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--lam", type=float, default=0.95)
    p.add_argument("--clip", type=float, default=0.2)
    p.add_argument("--num-scenarios", type=int, default=64,
                   help="training scenario count (generalization axis of the "
                        "reference experiment)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--save", default=None, help="export .npz in the expert format")
    force_cpu_flag(p)
    args = p.parse_args(argv)
    if args.quick:
        args.num_envs, args.rollout, args.iters, args.num_scenarios = 16, 16, 2, 2
    return args


def main(argv=None):
    args = parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch import MetaDriveEnv

    env = MetaDriveEnv(env_config(args.num_envs, args.num_scenarios), device=device)
    env.reset(seed=0)
    rng = prng.prng_key(0, device)
    module = PolicyValue(env.observation_dim, key=rng, device=device)
    optimizer = torch.optim.Adam(module.parameters(), lr=args.lr)
    generator = torch.Generator(device=device).manual_seed(0)
    history = []
    for it in range(args.iters):
        keys = prng.split(rng, 3)
        rng, k_roll = keys[0], keys[1]
        stats, _ = train_iteration(env, module, optimizer, k_roll, args, generator)
        history.append(stats)
        print(f"iter {it:3d}  mean_step_reward {stats['mean_step_reward']:+.4f}  "
              f"collect {stats['collect_env_steps_per_s']:,.0f} env-steps/s  "
              f"update {stats['update_ms']:.1f} ms  loss {stats['loss']:+.4f}")
    if args.save:
        save_expert_npz(module, args.save)
        print(f"saved policy (expert .npz format) -> {args.save}")
    return history


if __name__ == "__main__":
    main()
