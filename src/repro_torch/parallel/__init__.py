"""Logical-axis sharding rules (``sharding``)."""
