"""Checkpointing: atomic keep-K save and restore of the train state."""
