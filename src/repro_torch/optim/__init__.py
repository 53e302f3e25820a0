"""Optimizers: AdamW, schedules, gradient compression."""
