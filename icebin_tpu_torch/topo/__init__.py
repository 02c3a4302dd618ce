"""TOPO pipeline of the port (its own copy of the reference's numpy
module)."""
