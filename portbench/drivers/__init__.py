"""Drivers of the traffic mixes, one file each, found by name."""
