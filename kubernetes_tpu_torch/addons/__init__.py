"""Cluster addons (ref: cluster/addons/ — DNS, monitoring)."""
