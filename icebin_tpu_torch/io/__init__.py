"""Grid, exchange-grid, regridder and matrix files in the reference's
NetCDF schema (``ncio``, the port's own copy), so files written by either
package read back in the other."""
from icebin_tpu_torch.io.ncio import (read_exchange, read_grid, write_exchange,
                                      write_grid)

__all__ = ["read_exchange", "read_grid", "write_exchange", "write_grid"]
