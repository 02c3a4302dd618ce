"""The port's own copy of ``icebin_tpu/io/giss.py``; it imports
nothing of the reference package.  ``read_z1qx1n``'s lazy imports are the
port's own ``grid.spec``, ``regrid.hntr`` and ``topo.topo``.

GISS-format Fortran sequential binary files (the ``giss2nc`` equivalent).

ModelE's input datasets (Z1QX1N.BS1-style topography, ocean fractions, etc.)
are Fortran *sequential unformatted* files written by GISS tooling: each
record is framed by 4-byte big-endian length markers and holds an 80-byte
character TITLE followed by a big-endian ``real*4`` array:

    [>i4 len][TITLE*80][data >f4 ...][>i4 len]

The reference ingests these via its ``z1qx1n_bs1`` readers and converts
them with ``giss2nc`` (reference: ``slib/icebin/modele/z1qx1n_bs1*``,
``giss2nc`` [U]; SURVEY.md section 2 "TOPO pipeline", section 3.4).  This
module is a faithful standalone implementation: a reader, a bit-exact
writer (used to generate synthetic files IN THE REAL FORMAT for tests and
to round-trip), and the Z1QX1N -> TopoFields ingestion used by
``make_topoo``.

Layout convention: ModelE arrays are Fortran ``(im, jm)`` column-major
(longitude fastest), which equals a C-order ``(jm, im)`` array; flattening
that matches this package's flat cell index (``grid/spec.py``: flat =
j * nlon + i).
"""
from __future__ import annotations

import dataclasses
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GissRecord", "read_giss", "write_giss", "read_z1qx1n",
           "write_z1qx1n", "TITLE_BYTES"]

TITLE_BYTES = 80


@dataclasses.dataclass
class GissRecord:
    """One TITLE*80 + real*4 array record."""

    title: str                    # trailing blanks stripped
    data: np.ndarray              # float32 (native endian), shape (jm, im)
                                  # when inferrable, else 1-D

    @property
    def name(self) -> str:
        """Leading field token of the title (e.g. 'FOCEAN' from
        'FOCEAN: Ocean Surface Fraction (0:1)')."""
        m = re.match(r"\s*([A-Za-z0-9_]+)", self.title)
        return m.group(1).upper() if m else ""


def _read_marker(f) -> Optional[int]:
    b = f.read(4)
    if len(b) == 0:
        return None
    if len(b) != 4:
        raise ValueError("truncated GISS record marker")
    return struct.unpack(">i", b)[0]


def read_giss(path: str,
              shape: Optional[Tuple[int, int]] = None) -> List[GissRecord]:
    """Read every record of a GISS-format file.

    ``shape``: optional (jm, im) to reshape payloads; by default square-ish
    ModelE shapes are inferred from the element count against the standard
    grids (1x1, Q-degree, 2x2.5, ...), else data stays 1-D.
    """
    recs: List[GissRecord] = []
    with open(path, "rb") as f:
        while True:
            n = _read_marker(f)
            if n is None:
                break
            if n < TITLE_BYTES or (n - TITLE_BYTES) % 4 != 0:
                raise ValueError(f"bad GISS record length {n}")
            payload = f.read(n)
            if len(payload) != n:
                raise ValueError("truncated GISS record payload")
            n2 = _read_marker(f)
            if n2 != n:
                raise ValueError(f"GISS record marker mismatch {n} != {n2}")
            title = payload[:TITLE_BYTES].decode("ascii",
                                                 errors="replace").rstrip()
            data = np.frombuffer(payload[TITLE_BYTES:], dtype=">f4").astype(
                np.float32)
            sh = shape or _infer_shape(data.size)
            if sh is not None:
                data = data.reshape(sh)
            recs.append(GissRecord(title=title, data=data))
    return recs


_KNOWN_IMJM = (
    (72, 46), (144, 90), (288, 180), (360, 180), (720, 360),
    (1440, 720), (2160, 1080), (10800, 5400),   # ModelE + minute grids
)


def _infer_shape(size: int) -> Optional[Tuple[int, int]]:
    for im, jm in _KNOWN_IMJM:
        if size == im * jm:
            return (jm, im)
    return None


def write_giss(path: str, records: Sequence[GissRecord]) -> None:
    """Write records in the exact GISS sequential format (big-endian
    markers, TITLE*80 space-padded, >f4 data).  ``read_giss`` of the result
    is bit-exact."""
    with open(path, "wb") as f:
        for r in records:
            title = r.title.encode("ascii")
            if len(title) > TITLE_BYTES:
                raise ValueError(f"title longer than {TITLE_BYTES} bytes")
            title = title.ljust(TITLE_BYTES)
            data = np.ascontiguousarray(r.data, dtype=">f4").tobytes()
            n = len(title) + len(data)
            mark = struct.pack(">i", n)
            f.write(mark)
            f.write(title)
            f.write(data)
            f.write(mark)


# -- Z1QX1N-style topo ingestion -------------------------------------------

#: title tokens -> TopoFields attribute.  Real Z1QX1N.BS1 uses these names
#: (plus extras like FOCENF/ZATMOF/ZLAKE that make_topoo does not need).
_Z1QX1N_FIELDS: Dict[str, str] = {
    "FOCEAN": "focean", "FLAKE": "flake", "FGRND": "fgrnd",
    "FGICE": "fgice", "ZATMO": "zatmo",
}


def read_z1qx1n(path: str, spec=None):
    """GISS-format Z1QX1N-style file -> TopoFields.

    ``spec``: optional GridSpecLonLat; by default a global uniform grid
    matching the record shape is assumed (the real Z1QX1N family is
    global uniform).  Fractions are renormalized against float32 storage
    jitter (sum==1 to ~1e-7 in the file; TopoFields.check needs 1e-9).
    """
    from icebin_tpu_torch.grid.spec import GridSpecLonLat
    from icebin_tpu_torch.regrid.hntr import hntr_spec
    from icebin_tpu_torch.topo.topo import TopoFields

    fields: Dict[str, np.ndarray] = {}
    shape = None
    for r in read_giss(path):
        key = _Z1QX1N_FIELDS.get(r.name)
        if key is not None and key not in fields:
            fields[key] = np.asarray(r.data, np.float64)
            shape = r.data.shape
    missing = set(_Z1QX1N_FIELDS.values()) - set(fields)
    if missing:
        raise ValueError(f"Z1QX1N file {path} missing fields: "
                         f"{sorted(missing)}")
    if spec is None:
        if shape is None or len(shape) != 2:
            raise ValueError("cannot infer grid shape; pass spec=")
        jm, im = shape
        spec = hntr_spec(im, jm)
    if not isinstance(spec, GridSpecLonLat):
        raise TypeError("spec must be a GridSpecLonLat")
    if spec.ncells != fields["zatmo"].size:
        raise ValueError(f"spec has {spec.ncells} cells, file has "
                         f"{fields['zatmo'].size}")
    flat = {k: v.reshape(-1) for k, v in fields.items()}
    # float32 storage jitter: renormalize the fraction sum exactly to 1
    s = flat["focean"] + flat["flake"] + flat["fgrnd"] + flat["fgice"]
    if np.abs(s - 1.0).max() > 1e-3:
        raise ValueError(f"surface fractions in {path} do not sum to 1 "
                         f"(max dev {np.abs(s - 1.0).max():.2e})")
    for k in ("focean", "flake", "fgrnd", "fgice"):
        flat[k] = flat[k] / s
    return TopoFields(spec=spec, **flat).check()


def write_z1qx1n(path: str, topo) -> None:
    """TopoFields -> GISS-format file with Z1QX1N-style titles (used to
    generate REAL-format synthetic inputs for tests and demos)."""
    titles = {
        "focean": "FOCEAN: Ocean Surface Fraction (0:1)",
        "flake": "FLAKE: Lake Surface Fraction (0:1)",
        "fgrnd": "FGRND: Ground Surface Fraction (0:1)",
        "fgice": "FGICE: Glacial Ice Surface Fraction (0:1)",
        "zatmo": "ZATMO: Atmospheric Topography (m)",
    }
    jm, im = topo.spec.nlat, topo.spec.nlon
    recs = [GissRecord(title=titles[k],
                       data=np.asarray(getattr(topo, k), np.float32)
                       .reshape(jm, im))
            for k in titles]
    write_giss(path, recs)
