"""Seeded synthetic stand-ins for the paper's datasets (numpy)."""
