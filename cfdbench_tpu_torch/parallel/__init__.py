"""Parallelism of the port: the mesh and its data axis (``mesh.py``),
tensor parallelism over its model axis (``sharding_rules.py``,
``tensor.py``) and the FNO's pipeline (``pipeline.py``); see ROADMAP.md
A15 for the axes not yet ported."""
