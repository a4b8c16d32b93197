"""Resident-slot migration engine (single device, vranks)."""
