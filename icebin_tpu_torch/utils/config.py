"""The port's own copy of ``icebin_tpu/utils/config.py``: the same JSON
keys, so a reference ``run.json`` loads unchanged.  ``SheetConfig.engine``
is kept for that reason only: the port's ``run`` CLI clips exchange grids
through its kernels on the CLI's ``--device``, whatever the engine says.

Run configuration: one dataclass/JSON config for a coupled run.

Reference: the ``icebin.nc`` NetCDF config (coupler params, sheet list, file
paths) plus ModelE rundeck parameters (reference GCMCoupler ctor config
parse [U]; SURVEY.md section 5.6).  TPU build: a single JSON-serializable
dataclass covering grids, EC definitions, sheet list, matrix params, mesh
shape, and coupling cadence -- loadable by the CLI tools and by
``GCMCoupler.from_config``-style constructors.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

__all__ = ["SheetConfig", "RunConfig"]


@dataclasses.dataclass
class SheetConfig:
    name: str
    grid_file: str                    # ice grid NetCDF (io.ncio schema)
    exchange_file: Optional[str] = None   # cached exchange grid (else built)
    elevmask_file: Optional[str] = None   # .npy initial elevmask
    subdiv: int = 2
    #: the reference's exchange-grid clip engine; read and kept, not used
    engine: str = "auto"


@dataclasses.dataclass
class RunConfig:
    gridA_file: str
    hcdefs: List[float]
    sheets: List[SheetConfig]
    # matrix params (reference RegridParams)
    scale: bool = True
    correctA: bool = True
    sigma: Optional[Tuple[float, float]] = None
    # coupling
    dt_seconds: float = 86400.0 * 30
    n_steps: int = 12
    regen_every: int = 10
    min_thickness: float = 1.0
    # device mesh
    mesh_shape: Optional[List[int]] = None    # e.g. [8] ice-axis devices
    matrix_dtype: str = "float32"
    # observability
    dump_dir: Optional[str] = None            # per-step field dumps
    checkpoint_every: int = 0                 # 0 = off

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, src: str) -> "RunConfig":
        if src.strip().startswith("{"):
            d = json.loads(src)
        else:
            with open(src) as f:
                d = json.load(f)
        d["sheets"] = [SheetConfig(**s) for s in d.get("sheets", [])]
        if d.get("sigma") is not None:
            d["sigma"] = tuple(d["sigma"])
        return cls(**d)

    def regrid_params(self):
        from icebin_tpu_torch.regrid.matrices import RegridParams
        return RegridParams(scale=self.scale, correctA=self.correctA,
                            sigma=self.sigma)
