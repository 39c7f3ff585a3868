"""Seeded inputs: studies, step noise and weights."""
