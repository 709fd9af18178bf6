"""Checkpoint / resume for simulation state.

Counterpart of ``rmf_crowdsim_tpu/utils/checkpoint.py`` (``state_to_dict``,
``save_state``, ``load_state``; :24-56).  The reference has no
serialization of ``Simulation`` state (SURVEY.md §5).  The complete state
(positions, velocities, masks, waypoint cursors, id allocator, clock) is
one flat dict of arrays, written with ``np.savez`` into one file.

The port's random state is the ``torch.Generator`` beside the tensors
(``SimState.generator``), not an array field: it is saved as its
``get_state()`` bytes under ``"generator"`` and restored on a generator of
the load device, so a ``PoissonCrowd`` session resumes bitwise.  A
generator's state is particular to its device type (a CUDA generator's is
not a CPU one's), so a checkpoint resumes on the kind of device that wrote
it.  The JAX package's orbax pair is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import STATE_TENSOR_FIELDS, SimState

GENERATOR_FIELD = "generator"
_INT_FIELDS = ("next_waypoint", "uid", "source_id", "hl_idx", "lp_idx",
               "route_id", "route_wp", "next_uid")


def state_to_dict(state: SimState) -> dict:
    """The state's tensor fields as numpy arrays, and the generator's
    state as ``uint8`` bytes under ``"generator"``."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in STATE_TENSOR_FIELDS}
    out[GENERATOR_FIELD] = state.generator.get_state().numpy()
    return out


def save_state(path: str, state: SimState) -> None:
    np.savez(path, **state_to_dict(state))


def _check_dtypes(data) -> None:
    """Refuse a checkpoint whose fields would change the state's dtypes.
    The step mixes the float fields and the int32 fields with each other,
    and torch promotes mixed dtypes without a word (a float64 position
    makes float64 velocities), so a field of another dtype than the
    state's would silently change the dtypes of the whole state."""
    f = data["position"].dtype
    want = {name: np.dtype(np.int32) if name in _INT_FIELDS
            else np.dtype(np.bool_) if name == "alive" else f
            for name in STATE_TENSOR_FIELDS}
    want[GENERATOR_FIELD] = np.dtype(np.uint8)
    bad = {name: f"{data[name].dtype} (want {dt})"
           for name, dt in want.items() if data[name].dtype != dt}
    if f not in (np.float32, np.float64):
        bad["position"] = f"{f} (want float32 or float64)"
    if bad:
        raise ValueError(f"checkpoint fields of the wrong dtype: {bad}; "
                         "refusing a silent dtype change")


def load_state(path: str, device="cuda") -> SimState:
    """The state saved at ``path``, on ``device`` (the card unless the
    caller names another device), with its generator restored."""
    with np.load(path) as data:
        missing = set(STATE_TENSOR_FIELDS + (GENERATOR_FIELD,)) - set(
            data.files)
        if missing:
            raise ValueError(f"checkpoint missing fields: {sorted(missing)}")
        _check_dtypes(data)
        fields = {name: torch.from_numpy(np.array(data[name])).to(device)
                  for name in STATE_TENSOR_FIELDS}
        gen_state = torch.from_numpy(np.array(data[GENERATOR_FIELD]))
    gen = torch.Generator(device=device)
    try:
        gen.set_state(gen_state)
    except RuntimeError as e:
        raise ValueError(
            f"the checkpoint's generator state does not fit a generator on "
            f"{device}: a checkpoint resumes on the kind of device that "
            f"wrote it ({e})") from e
    return SimState(**fields, generator=gen)
