"""Offline data-generation tooling (documentary — requires ANSYS
Fluent/ICEM, external to this environment). Capability mirror of
``generation-code/`` in the reference; the port's own copy of
``cfdbench_tpu/generation``."""
