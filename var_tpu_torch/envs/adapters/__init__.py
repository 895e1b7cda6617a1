"""Adapters of the host sims onto real simulators: PyBullet for the arm
(`pybullet_arm.py`), AI2-THOR's iTHOR for the grid house (`ithor.py`).
Each imports its simulator only when it connects."""
