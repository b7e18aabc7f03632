"""One run of one cell of BENCHMARK.json, from the root of a checkout:

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error and, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``. Exits non-zero, printing no
result, without enough CUDA devices or when a JAX module was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
CACHE = CHECKOUT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmarks import guard, harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t0=T0, log=log)
    found = guard.blocked_modules()
    if found:
        log("a JAX module was loaded in this run: " + ", ".join(found))
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell.chips,
                  memory_peak_bytes=res["memory_peak_bytes"])
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = dict(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
                metrics=res["metrics"], device=device)
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    for k, v in res["check"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
