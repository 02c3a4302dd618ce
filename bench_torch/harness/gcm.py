"""A configuration's GCM grid, found by its kind (``gcm_grid.kind``).

A kind is two files under ``bench_torch``, loaded by path as the metric
readers are:

* ``gcm/<kind>.py``, the program's half: ``DRIVERS``, the traffic drivers
  the kind supports, and ``regridder(cfg, device, res_km=None, data=None)``,
  what ``GCMCoupler`` is given, every sheet's exchange grid built on
  ``device``.
* ``reference/gcm/<kind>.py``, the reference's half (nothing of the
  program): ``exchange(cfg, sheet, lattice, device, prec, data=None)``, that
  sheet's ``reference.grid.Exchange``, its ``nA`` the count of the GCM's
  atmosphere cells; and optionally ``inputs(cfg, seed)``, the data the kind
  needs besides the configuration, in plain numpy from the configuration
  and the seed.

``load`` calls ``inputs`` once and hands the same ``data`` to both halves.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH = Path(__file__).resolve().parent.parent


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class KindError(LookupError):
    """A configuration's GCM grid kind is unknown, or does not drive the
    traffic."""


def find(cfg: dict, driver: str):
    """The two halves of the configuration's kind, as modules; a
    ``KindError`` naming the files where the kind is unknown or does not
    support the traffic's ``driver``."""
    kind = cfg["gcm_grid"]["kind"]
    prog = BENCH / "gcm" / f"{kind}.py"
    ref = BENCH / "reference" / "gcm" / f"{kind}.py"
    names = [str(p.relative_to(BENCH.parent)) for p in (prog, ref)]
    missing = [n for n, p in zip(names, (prog, ref)) if not p.is_file()]
    if missing:
        raise KindError(f"GCM grid kind {kind!r} of configuration "
                        f"{cfg['name']!r}: looked for {' and '.join(names)}"
                        f", found no {' and no '.join(missing)}")
    tag = kind.replace(".", "_").replace("-", "_")
    program = _module(prog, f"bench_gcm_{tag}")
    if driver not in program.DRIVERS:
        raise KindError(f"GCM grid kind {kind!r} ({names[0]}) drives "
                        f"{tuple(program.DRIVERS)}, not the traffic's "
                        f"{driver!r}")
    return program, _module(ref, f"bench_gcm_reference_{tag}")


@dataclasses.dataclass
class Grid:
    """The GCM grid of one configuration and seed: both halves of its kind
    and the data they share."""

    cfg: dict
    program: ModuleType
    reference: ModuleType
    data: Optional[dict]

    def regridder(self, device, res_km=None):
        return self.program.regridder(self.cfg, device, res_km,
                                      data=self.data)

    def exchange(self, sheet: dict, lattice, device, prec):
        return self.reference.exchange(self.cfg, sheet, lattice, device,
                                       prec, data=self.data)


def load(cfg: dict, driver: str, seed: int) -> Grid:
    program, reference = find(cfg, driver)
    inputs = getattr(reference, "inputs", None)
    return Grid(cfg, program, reference,
                inputs(cfg, seed) if inputs else None)
