"""Coupling driver and f64 conservation ledger of the port."""
