"""Carry scenes and states into the port from host (numpy) data.

`scene_from_pack` takes a compiled scene pack; `state_from_numpy` takes a
state (`SimState`, or `ScenarioSimState` of the scenario path) written out
as nested dicts of numpy arrays, keyed by the field names of the state and
its children. Together they let another
implementation hand its scene and state over, so that both step from the
same state.
"""
import dataclasses
import typing

import numpy as np
import torch

from metadrive_ped_torch.core.structs import Scene, SimState, _Tree


def scene_from_pack(pack, device):
    """The device `Scene` of a numpy scene pack (`mapgen.build_scene_pack`)."""
    return Scene.from_pack(pack, device)


def _leaf(a, device):
    a = np.array(a)  # a writable copy
    if a.dtype == np.uint32:
        # PRNG keys: uint32 words held in int64 (core/prng.py)
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _build(cls, tree, device):
    hints = typing.get_type_hints(cls)
    return cls(**{
        f.name: (_build(hints[f.name], tree[f.name], device)
                 if issubclass(hints[f.name], _Tree) else _leaf(tree[f.name], device))
        for f in dataclasses.fields(cls)
    })


def state_from_numpy(tree, device, cls=SimState):
    """A state of class ``cls`` from nested dicts of numpy arrays (uint32
    keys become int64)."""
    return _build(cls, tree, device)


def state_to_numpy(state):
    """Inverse of `state_from_numpy`: nested dicts of numpy arrays."""
    return {
        f.name: (state_to_numpy(v) if isinstance(v, _Tree) else v.detach().cpu().numpy())
        for f in dataclasses.fields(state)
        for v in [getattr(state, f.name)]
    }
