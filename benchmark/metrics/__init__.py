"""Per-layer metrics, one reader a file: ``<metric>.py`` defines
``read(ctx)``, which returns the metric's value from the traced run, or
None where the run holds nothing to read (the harness then leaves the
metric out of the line).

``ctx`` (built by ``harness.py``) has: ``trace`` (a ``trace.Trace`` of the
profiled unit, or None), ``step_times`` (seconds of each step of the
measured window, where the driver times steps one by one), ``listener_s``
and ``window_steps`` (the listener's own time over the window and the
window's steps), ``k1_bound_ms`` (K1's bound a launch, averaged
over the checked steps' inputs, or None) and ``memory_peak_bytes``."""
