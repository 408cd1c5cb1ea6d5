"""Host-side NumPy/SciPy oracle implementations.

The reference library ships no unit tests (SURVEY.md section 4); its validation
is calibrated golden-run examples.  This package provides reference-faithful
host implementations of every solver and numeric primitive, written straight
from the equations/semantics documented in SURVEY.md, to generate golden flows
the engine is tested against (tests/ compares engine vs oracle within AEE
bounds).  Everything here is intentionally slow, simple and NumPy-only.
"""
