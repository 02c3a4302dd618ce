"""Grid and exchange-grid files: the reference's NetCDF schema
(``icebin_tpu.io.ncio``, numpy and scipy, no JAX), re-exported so that a
user of the port needs no import from ``icebin_tpu``."""
from icebin_tpu.io.ncio import (read_exchange, read_grid, write_exchange,
                                write_grid)

__all__ = ["read_exchange", "read_grid", "write_exchange", "write_grid"]
