"""Counters of the port's device plane."""
