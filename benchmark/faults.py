"""Faults planted in the program's timed path, to see ``correct`` come out
false: each ``plant(set_attr)`` replaces one function of the program
through ``set_attr(owner, name, value)`` (pytest's
``monkeypatch.setattr`` in the tests, ``setattr`` in
``calibrate.py --fault``).  One card, so no exchange between chips.

- ``unchanged``: a step that returns its state unchanged;
- ``half``: every other slot left out of the force pass;
- ``altered``: one agent's answer altered where the force pass makes it;
- ``event``: one spawn event's uid altered where the session delivers it.
"""

from __future__ import annotations

import torch


def unchanged(set_attr):
    import rmf_crowdsim_tpu_torch.core.step as step_mod

    finish = step_mod._finish_phase

    def broken(config, hl, params, state, *args):
        _, events, destroyed = finish(config, hl, params, state, *args)
        return state, events, destroyed

    set_attr(step_mod, "_finish_phase", broken)


def half(set_attr):
    from rmf_crowdsim_tpu_torch.models.local import Zanlungo

    plan = Zanlungo.plan_fused

    def broken(self, params, bcfg, state, rec_vel, *a, **k):
        v, occ, dropped = plan(self, params, bcfg, state, rec_vel, *a, **k)
        v = v.clone()
        v[1::2] = rec_vel[1::2]
        return v, occ, dropped

    set_attr(Zanlungo, "plan_fused", broken)


def altered(set_attr):
    from rmf_crowdsim_tpu_torch.models.local import Zanlungo

    plan = Zanlungo.plan_fused

    def broken(self, params, bcfg, state, rec_vel, *a, **k):
        v, occ, dropped = plan(self, params, bcfg, state, rec_vel, *a, **k)
        first = int(torch.nonzero(state.alive)[0])
        v = v.clone()
        v[first] += 0.5
        return v, occ, dropped

    set_attr(Zanlungo, "plan_fused", broken)


def event(set_attr):
    import rmf_crowdsim_tpu_torch.core.simulation as sim_mod

    deliver = sim_mod._deliver

    def broken(listeners, spawned, reached, destroyed):
        uid, pos = spawned
        if len(uid):
            uid = uid.copy()
            uid[0] += 1
        deliver(listeners, (uid, pos), reached, destroyed)

    set_attr(sim_mod, "_deliver", broken)


STEP_FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
FAULTS = dict(STEP_FAULTS, event=event)
