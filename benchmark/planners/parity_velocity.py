"""``parity_velocity``: the configuration's ``parity_velocity`` (vx, vy);
even uids walk ``-v``, odd ``+v`` (rmf_crowdsim_viz/src/main.rs:20-41)."""


class Planner:
    def __init__(self, cfg: dict, spec: dict, plan, device):
        from rmf_crowdsim_tpu_torch import ParityVelocity

        self.v = tuple(cfg["parity_velocity"])
        self.hl = ParityVelocity(self.v)

    def legs(self, sinks):
        raise ValueError("parity_velocity leads a placed crowd, no sources")

    def reference(self, sinks, legs, device):
        return ("parity", self.v), 0, 0.0
