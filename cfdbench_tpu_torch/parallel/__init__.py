"""Data parallelism of the port (``mesh.py``); see ROADMAP.md A15 for the
axes not yet ported."""
