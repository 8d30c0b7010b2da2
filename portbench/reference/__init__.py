"""The plain reference that decides a run's ``correct``: plain PyTorch and
NumPy, importing nothing of the program.  ``pipeline`` composes the two
entry paths; the other modules are frozen copies of the repository port's
plain modules (``ops/``, ``pipeline/geometry.py``) and of its models cut to
inference, kept here so that the yardstick does not move with the program.
"""
