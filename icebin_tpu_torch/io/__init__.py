"""Grid, exchange-grid, regridder and matrix files in the reference's
NetCDF schema (``ncio``, the port's own copy), so files written by either
package read back in the other; and the ModelE and SeaRISE input formats
(``giss``: GISS Fortran sequential binaries, ``searise``: SeaRISE NetCDF
ice datasets), the port's own copies of the reference's readers and
writers."""
from icebin_tpu_torch.io.giss import (GissRecord, read_giss, read_z1qx1n,
                                      write_giss, write_z1qx1n)
from icebin_tpu_torch.io.ncio import (read_exchange, read_grid, write_exchange,
                                      write_grid)
from icebin_tpu_torch.io.searise import (SeaRiseData, read_searise,
                                         searise_elevmask,
                                         write_synthetic_searise)

__all__ = ["GissRecord", "SeaRiseData", "read_exchange", "read_giss",
           "read_grid", "read_searise", "read_z1qx1n", "searise_elevmask",
           "write_exchange", "write_giss", "write_grid",
           "write_synthetic_searise", "write_z1qx1n"]
