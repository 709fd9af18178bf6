"""High-level planners, one module a kind: ``Planner(cfg, spec, plan,
device)``, where ``plan`` is the SourcePlan of the agents that the planner
leads (None for a placed crowd).  It has:

- ``hl``: the program's planner object;
- ``legs(sinks)``: [S, W] route ids of the program's SourceSinks' legs;
- ``reference(sinks, legs, device)``: ``(entry, routes_off, worst)``, the
  reference world's planner entry, the legs whose route failed the
  reference's judge, and the worst route's length over its shortest
  path."""
