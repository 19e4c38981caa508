"""The planner's worker-side metrics (planner/metrics.py)."""
