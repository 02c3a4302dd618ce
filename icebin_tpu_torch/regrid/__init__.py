"""Regridder whose sheets build through the port."""
