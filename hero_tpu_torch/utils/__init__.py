"""Logging, seeding and file helpers of the drivers."""
