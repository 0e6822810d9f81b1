"""Logical-axis sharding of the port (`distributed/sharding.py`)."""
