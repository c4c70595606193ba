"""The benchmark of pulser_diff_torch: see harness.py."""
