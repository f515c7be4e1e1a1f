"""Example drivers."""
