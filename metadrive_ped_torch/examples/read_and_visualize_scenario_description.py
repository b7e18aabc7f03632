"""Read a ScenarioDescription dataset and print a summary
(reference: examples/read_and_visualize_scenario_description.py). With no
--dataset argument, it first writes one from PG rollouts.

    python -m metadrive_ped_torch.examples.read_and_visualize_scenario_description [--cpu]
"""
import argparse
import tempfile

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def describe(sd):
    meta = sd["metadata"]
    n_lanes = sum(1 for f in sd["map_features"].values() if "LANE" in str(f.get("type", "")))
    print(f"  scenario {meta.get('scenario_id', '?')}: {len(meta['ts'])} steps, "
          f"{len(sd['tracks'])} tracks, {n_lanes} lanes, sdc={meta['sdc_id']}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default=None, help="SD pkl directory (default: self-generate)")
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch.scenario.utils import load_scenarios

    if args.dataset:
        scenarios = load_scenarios(args.dataset)
        for sd in scenarios[:10]:
            describe(sd)
        return scenarios

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.scenario import export_scenarios
    from metadrive_ped_torch.scenario.utils import save_dataset

    env = MetaDriveEnv(dict(num_envs=3, num_scenarios=3, map=3, traffic_density=0.1),
                       device=device)
    env.reset(seed=0)
    with tempfile.TemporaryDirectory() as d:
        save_dataset(list(export_scenarios(env, n_steps=50).values()), d)
        scenarios = load_scenarios(d)
        print(f"dataset at {d}: {len(scenarios)} scenarios")
        for sd in scenarios:
            describe(sd)
    return scenarios


if __name__ == "__main__":
    main()
