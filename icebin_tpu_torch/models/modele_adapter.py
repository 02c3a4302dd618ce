"""ModelE adapter: the GCM-facing boundary of the port's coupler (port of
``icebin_tpu/models/modele_adapter.py``).

Reference: ``GCMCoupler_ModelE`` + the ``gcmce_*`` C functions called from
ModelE's Fortran LISnow/lisheet code, with f90blitz marshalling of (i, j,
ihc) arrays (reference: ``slib/icebin/modele/GCMCoupler_ModelE.*``,
ibmisc f90blitz [U]; SURVEY.md sections 2, 3.3, 3.5).  This module is the
Python side of that boundary; ``icebin_tpu_torch/native/gcmce.cc`` exposes
the same API as a C ABI for a Fortran GCM.

Responsibilities:
* E-index layout translation: the framework's canonical a-major E layout
  (``regrid.matrices``) <-> ModelE's ihc-major (i, j, ihc) Fortran layout --
  a fixed permutation, applied once per step at the boundary.  The layout
  functions are the reference's, copied as they are (numpy).
* Fortran array marshalling: a Fortran (im, jm, nhc) real*8 array is
  C-contiguous (nhc, jm, im); views are zero-copy.
* The per-step protocol: accept per-rank sparse E-grid multivecs
  (``gcmce_add_gcm_outpute``-style), run the port's ``GCMCoupler.couple``
  on ``device``, return E/A results and updated TOPO fields (fhc, elevE,
  underice) for ModelE's in-place boundary-condition update.

Differences from the reference: ``ModelEAdapter`` takes the coupler's
``device``; the densified forcing becomes one f32 tensor there, shared by
every sheet (the reference builds one ``jnp`` array per sheet from the same
values), and outputs come back to the host through ``.cpu().numpy()``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from icebin_tpu_torch.coupler.coupler import CouplerConfig, GCMCoupler
from icebin_tpu_torch.coupler.multivec import VectorMultivec, concatenate
from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
from icebin_tpu_torch.topo.topo import elevation_class_fields

__all__ = ["to_modele_E", "from_modele_E", "fortran_ijh_to_flatE",
           "flatE_to_fortran_ijh", "ModelEAdapter"]


def to_modele_E(field, nA: int, nhc: int):
    """a-major (e = a*nhc + ihc) -> ModelE ihc-major (e = ihc*nA + a)."""
    f = np.asarray(field)
    return np.moveaxis(f.reshape(f.shape[:-1] + (nA, nhc)), -1, -2
                       ).reshape(f.shape[:-1] + (nhc * nA,))


def from_modele_E(field, nA: int, nhc: int):
    """ModelE ihc-major -> canonical a-major."""
    f = np.asarray(field)
    return np.moveaxis(f.reshape(f.shape[:-1] + (nhc, nA)), -1, -2
                       ).reshape(f.shape[:-1] + (nA * nhc,))


def fortran_ijh_to_flatE(arr, nA: int, nhc: int):
    """ModelE Fortran array A(im, jm, nhc) (seen from C as (nhc, jm, im))
    -> canonical flat E (a-major).  Zero-copy view + one permutation."""
    a = np.asarray(arr)
    if a.ndim != 3:
        raise ValueError("expected a 3-D (nhc, jm, im) array view")
    nhc_, jm, im = a.shape
    if nhc_ != nhc or jm * im != nA:
        raise ValueError(f"shape {a.shape} does not match nA={nA}, nhc={nhc}")
    return from_modele_E(a.reshape(nhc * nA), nA, nhc)


def flatE_to_fortran_ijh(field, im: int, jm: int, nhc: int):
    """Canonical flat E -> (nhc, jm, im) C view of a Fortran (im,jm,nhc)."""
    f = to_modele_E(np.asarray(field), im * jm, nhc)
    return f.reshape(nhc, jm, im)


class ModelEAdapter:
    """The gcmce_* API surface (reference C functions [U]):

    gcmce_new            -> ModelEAdapter(gr, cfg, device=...)
    gcmce_set_start_time -> set_start_time(t0)
    gcmce_add_gcm_outpute-> add_rank_output(multivec) per rank
    gcmce_couple_native  -> couple_native(itime) -> results
    update_topo          -> topo() (fhc/elevE/underice, ModelE layout)
    """

    def __init__(self, gr: GCMRegridder, cfg: CouplerConfig = CouplerConfig(),
                 *, device):
        self.device = torch.device(device)
        self.coupler = GCMCoupler(gr, cfg, device=self.device)
        self.gr = gr
        self._rank_outputs: List[VectorMultivec] = []
        self.start_time = 0.0

    @property
    def nA(self) -> int:
        return self.gr.nA

    @property
    def nhc(self) -> int:
        return self.gr.nhc

    def set_start_time(self, t0: float) -> None:
        self.start_time = t0
        self.coupler.time = t0

    def set_held_state(self, sheet: str, fields_modele, default: float = 0.0
                       ) -> None:
        """Register GCM-held extensive EC state (ModelE ihc-major layout);
        it is remapped through E1vE0 at every matrix regeneration inside
        ``IceSheetCoupler`` (reference update_topo remaps ModelE's land-ice
        state [U])."""
        f = np.atleast_2d(np.asarray(fields_modele, dtype=np.float64))
        self.coupler.sheets[sheet].set_held_state(
            from_modele_E(f, self.nA, self.nhc), default=default)

    def held_state(self, sheet: str):
        """Current held EC state back in ModelE ihc-major layout."""
        h = self.coupler.sheets[sheet].held_E
        return None if h is None else to_modele_E(h, self.nA, self.nhc)

    def add_rank_output(self, index, vals) -> None:
        """Accept one rank's sparse E-grid contribution, ModelE ihc-major
        indices (reference gcmce_add_gcm_outpute [U])."""
        self._rank_outputs.append(VectorMultivec(index=index, vals=vals))

    def couple_native(self, itime: float) -> Dict[str, dict]:
        """One coupling step from accumulated rank outputs (reference
        gcmce_couple_native [U]).  Returns per-sheet results with E-grid
        outputs already permuted to ModelE layout."""
        mv = concatenate(self._rank_outputs)
        self._rank_outputs = []
        dense_modele = mv.to_dense(self.gr.nE)
        fE = from_modele_E(dense_modele, self.nA, self.nhc)
        n_in = len(self.coupler.sheets[next(iter(self.coupler.sheets))]
                   .contract_in)
        if fE.shape[0] != n_in:
            raise ValueError(f"expected {n_in} contract fields, "
                             f"got {fE.shape[0]}")
        fE_dev = torch.as_tensor(np.ascontiguousarray(fE, np.float32),
                                 device=self.device)
        results = self.coupler.couple({name: fE_dev
                                       for name in self.coupler.sheets})
        out = {}
        for name, r in results.items():
            fE_out = r["fE_out"].cpu().numpy()
            out[name] = {
                "fE_out_modele": to_modele_E(fE_out, self.nA, self.nhc),
                "fA_out": r["fA_out"].cpu().numpy(),
                "fhc": r["fhc"], "elevE": r["elevE"],
            }
        return out

    def topo(self):
        """(fhc, elevE, underice) in ModelE (nhc, jm, im) layout for the
        in-place TOPO update (reference update_topo path [U])."""
        masks = {name: sc.regen_elevmask
                 for name, sc in self.coupler.sheets.items()}
        fhc, elevE, underice = elevation_class_fields(self.gr, masks)
        im, jm = self.gr.specA.shape
        return (fhc.reshape(self.nhc, jm, im),
                np.where(np.isfinite(elevE), elevE, 0.0).reshape(
                    self.nhc, jm, im),
                underice.reshape(self.nhc, jm, im))
