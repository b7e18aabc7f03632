"""The readings that a cell's comparison limits are set from:

    python3 -m benchmarks.control --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--controls bf16 tf32] [--out PATH]

For each seed the program runs its loop from reset through the cell's
check block (its set-up and a short window at the cell's own size), and
the reference follows; for each control seed and each control the
reference, computed in a lower precision ("bf16": state and outputs stored
in bfloat16 after every step; "tf32": float32 matrix products in TF32),
takes the program's place. Prints one JSON line per reading and a summary:
the largest program reading and the smallest control reading of each
compared number, beside the cell's limit.
"""
import argparse
import gc
import json
import sys

import torch

from benchmarks import harness


def readings(name, seeds, control_seeds, controls, device="cuda", overrides=None):
    """(program readings, control readings): lists of dicts of the compared
    numbers, with "seed" (and "control")."""
    cell = harness.Cell(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    env = cell.build(harness.PROGRAM, device, overrides)
    kept = {}
    for s in seeds:
        loop, reset_obs = harness.start(cell, env, s, device,
                                        log=lambda *a: print(*a, file=sys.stderr))
        loop.window(0.0, env._graphs)
        kept[s] = (reset_obs, loop.kept)
    del env, loop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.build(harness.REFERENCE, device, overrides)
    program, control, refs = [], [], {}
    for s in seeds:
        refs[s] = harness.follow(cell, ref, s, kept[s][1])
        program.append(dict(seed=s, **harness.numbers_of(kept[s][0], kept[s][1].stacked(),
                                                         *refs[s])))
    for c in controls:
        for s in control_seeds:
            c_reset, c_outs = harness.follow(cell, ref, s, kept[s][1], control=c)
            control.append(dict(seed=s, control=c,
                                **harness.numbers_of(c_reset, c_outs, *refs[s])))
    return cell, program, control


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=["bf16"])
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    cell, program, control = readings(args.workload, args.seeds, args.control_seeds,
                                      args.controls)
    lines = [dict(workload=args.workload, kind="program", **r) for r in program]
    lines += [dict(workload=args.workload, kind="control", **r) for r in control]
    summary = dict(workload=args.workload, kind="summary",
                   card=torch.cuda.get_device_name(0), limits=cell.limits)
    for k in cell.limits:
        summary[k] = dict(program_max=max(r[k] for r in program),
                          control_min={c: min(r[k] for r in control if r["control"] == c)
                                       for c in args.controls if control})
    lines.append(summary)
    text = "\n".join(json.dumps(x) for x in lines)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
