"""SourceSink layouts, one module a kind: ``plan(spec, cfg, seed) ->
scene.SourcePlan``, the sources' points, waypoints and generator phases."""
