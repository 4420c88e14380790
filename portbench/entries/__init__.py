"""One module a program entry that a window drives, found by its name
(:func:`portbench.program.entry`): ``system`` and ``numbers``."""
