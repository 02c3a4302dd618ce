"""The port's own copy of ``icebin_tpu/coupler/writer.py`` (numpy and
scipy; the coupler hands it host arrays).

Per-step coupler field dumps: the observability/debugging story.

Reference: the coupler dumps every field entering/leaving each step to
NetCDF (``gcm-out``/``gcm-in`` files + per-sheet ``IceWriter`` [U];
SURVEY.md section 5.5) -- cheap, complete, diffable.  Same pattern here:
one NetCDF-3 file per step (or per N steps) with E/A/I fields and the f64
ledger row, so two runs can be diffed field-by-field.
"""
from __future__ import annotations

import pathlib
from typing import Dict, Optional

import numpy as np
from scipy.io import netcdf_file

__all__ = ["CouplerWriter"]


class CouplerWriter:
    """Writes step dumps into ``dir/step_NNNNNN.nc`` (reference IceWriter)."""

    def __init__(self, out_dir: str, every: int = 1):
        self.dir = pathlib.Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = max(1, every)
        self.step = 0

    def dump(self, time: float, fields: Dict[str, np.ndarray],
             ledger_row: Optional[dict] = None) -> Optional[str]:
        """fields: name -> 1-D/2-D arrays (e.g. 'greenland.fI', '...fE_out').
        Returns the path written, or None when skipped by cadence."""
        step = self.step
        self.step += 1
        if step % self.every:
            return None
        path = str(self.dir / f"step_{step:06d}.nc")
        with netcdf_file(path, "w") as nc:
            nc.time = float(time)
            nc.step = step
            if ledger_row:
                # ledger values as f64 VARIABLES (scipy netcdf attributes
                # downcast floats to f32, which would defeat f64 diffing)
                nc.createDimension("one", 1)
                for k, v in ledger_row.items():
                    lv = nc.createVariable(
                        "ledger_" + k.replace(".", "_"), "d", ("one",))
                    lv[:] = float(v)
            for name, arr in fields.items():
                a = np.asarray(arr, dtype=np.float64)
                a = np.where(np.isfinite(a), a, -1e30)   # NetCDF3-safe fill
                dims = []
                for d, n in enumerate(a.shape):
                    dn = f"{name}_d{d}"
                    nc.createDimension(dn, n)
                    dims.append(dn)
                v = nc.createVariable(name.replace(".", "_"), "d",
                                      tuple(dims))
                v[:] = a
                v.missing_value = -1e30
        return path

    @staticmethod
    def read(path: str) -> Dict[str, np.ndarray]:
        out = {}
        with netcdf_file(path, "r", mmap=False) as nc:
            for name, var in nc.variables.items():
                a = np.array(var[:])
                out[name] = np.where(a <= -9e29, np.nan, a)
            out["_attrs"] = {k: float(v) for k, v in nc._attributes.items()
                             if np.isscalar(v)}
        return out
