"""Trajectory evaluation, trajectory / state dumps, metrics and numerics
guards."""
