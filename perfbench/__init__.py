"""The serving benchmark of ``repro_torch`` on one H100 (``run.py``).

Everything that belongs to one configuration, one traffic mix, one
metric or one kernel lives in a file of its own, found by name
(README.md)."""
