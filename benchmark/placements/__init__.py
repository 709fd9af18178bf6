"""Crowd placements, one module a kind: ``positions(config, spec, n, seed,
device) -> [n, 2]`` in the configuration's float type, drawn on the device
from the seed."""
