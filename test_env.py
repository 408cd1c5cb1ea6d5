#!/usr/bin/env python3
"""Environment smoke check — drop-in equivalent of the reference's root-level
``test_env.py`` (prints the numerics stack versions; accelerator failure is
tolerated).  Run directly: ``python3 test_env.py``."""

from opticalflow_ri.utils.envcheck import main

if __name__ == "__main__":
    main()
