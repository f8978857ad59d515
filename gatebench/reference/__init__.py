"""Plain PyTorch float32 references of the gate's networks and stages.

Frozen copies written from the published descriptions and the gate's
stated semantics; nothing here imports the program. ``check.py`` holds
the program's outputs to them.
"""
