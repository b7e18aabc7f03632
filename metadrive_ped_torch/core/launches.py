"""Launch counts of the hand-written kernels, kept right under CUDA graphs.

A kernel's wrapper owns its counter: any hashable object (a module, a
class instance) with an int ``launches`` and a `collections.Counter`
``launches_by_device`` (ops/ray_segment.py uses its own module), which
callers read and set to 0 to start counting.
Where it launches its kernel the wrapper calls `record(counter,
device_index)`, and nowhere else. The count then stays the kernel's
executions on the card:

- outside a capture, `record` adds one to the counter;
- while `capturing` is open (core/graph.py captures a step), the launch is
  put into the graph and executes nothing: `record` adds it to the
  capture's tally instead, and `replayed(tally)` adds the tally to its
  counters at each replay of that graph (a tally keeps each launch's
  device, so a `ShardedEnv` shard's replays count on the shard's device);
- inside `uncounted` (a graph's warm-up steps, thrown away like a check
  against a kernel's plain version) nothing is counted.

A launch into a CUDA graph that `capturing` does not tally raises: its
replays could not be counted.
"""
import collections
import contextlib

import torch

_tallies = []     # the open captures' tallies, innermost last
_paused = 0       # depth of open `uncounted` blocks


def record(counter, device_index):
    """One launch of ``counter``'s kernel on CUDA device ``device_index``."""
    if _paused:
        return
    if _tallies:
        _tallies[-1][counter, device_index] += 1
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a kernel was launched into a CUDA graph that "
                           "core.launches.capturing does not tally: its replays cannot be counted")
    counter.launches += 1
    counter.launches_by_device[device_index] += 1


@contextlib.contextmanager
def capturing():
    """Tally the launches of a capture: yields the tally, a Counter of
    (counter, device index) -> launches, for `replayed`."""
    tally = collections.Counter()
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.pop()


def replayed(tally):
    """One replay of a graph whose capture made ``tally``."""
    for (counter, device_index), n in tally.items():
        counter.launches += n
        counter.launches_by_device[device_index] += n


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are not counted."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1
