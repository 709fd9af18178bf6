"""``monotonic``: the program's ``MonotonicCrowd(rate)``, which asks
``floor(rate * dt + 0.5)`` agents every step (source_sink.rs:96-101)."""


def program(spec: dict, phase: float):
    from rmf_crowdsim_tpu_torch import MonotonicCrowd

    return MonotonicCrowd(spec["rate"])


def reference(spec: dict, phases, dt: float):
    return spec["rate"], None
