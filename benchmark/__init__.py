"""The benchmark of ``rmf_crowdsim_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` measures one cell of ``BENCHMARK.json`` and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the deployment (``SimConfig`` fields, the
  planners' parameters, ``dt``, its source);
- ``traffic/<mix>.json``: the parameters that ``scene.py``, the one
  generator, reads; each ``kind`` in it names a module of its own
  (``drivers/``, ``placements/``, ``layouts/``, ``generators/``,
  ``planners/``), and an unknown kind raises;
- ``metrics/<metric>.py``: a reader with ``read(ctx)`` that takes the
  metric from the traced run, or returns None where it finds nothing.

``limits/<cell>.json`` holds each cell's limits and the readings they were
set from; ``reference/`` is the plain PyTorch reference that decides
``correct``; ``faults.py`` the faults that must make it false;
``yardstick.py`` holds the frozen copies (percentiles, the K1 and K3
counts, the published peaks).  Nothing here imports JAX or the JAX
package.
"""
