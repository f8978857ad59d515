"""Traffic: ``<mix>.json`` parameter files read by the one generator, ``scene.py``."""
