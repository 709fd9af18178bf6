"""Crowd generators, one module a kind: ``program(spec, phase)`` gives a
source's generator for the program; ``reference(spec, phases, dt)`` gives
the reference's ``(rate, requests)``: a monotonic rate, or a function of
the step that returns every source's count."""
