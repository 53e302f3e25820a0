"""Arch configs; see registry.get_arch."""
