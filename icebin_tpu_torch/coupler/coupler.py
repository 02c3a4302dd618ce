"""GCM<->ice coupling driver (port of ``icebin_tpu/coupler/coupler.py``).

One coupling step (``IceSheetCoupler._couple_core``): IvE forcing transport
with fused unit conversion -> f64 mass repair of the extensive fields ->
SIA ice step (mass and enthalpy columns) -> EvI/AvI harvest, each repaired
-> a 15-entry f64 ledger row.  Every ``regen_every`` steps the matrices are
rebuilt from the evolved surface and GCM-held EC state is remapped through
E1vE0.  Matrix construction, E1vE0 and unit contracts are the reference's
host modules, imported from ``icebin_tpu``.

Differences from the reference:

* The device is the tensors' device (given explicitly to the constructors);
  the reference's engine strings ("pallas"/"xla"/"auto") are gone, and
  ``CouplerConfig.nv`` replaces ``pallas_nv``.  ``prods_passes`` is
  accepted and ignored: the kernels always sum in f64.
* Mass and energy books (mfac, ledger sums) are always f64.
* PyTorch runs eagerly, so ``couple_window`` is a plain loop over
  ``_couple_core`` and ``couple`` needs no jit cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from icebin_tpu.coupler.e1ve0 import e1ve0_matrix
from icebin_tpu.coupler.varset import (VarSet, ice_modele_output_contract,
                                       ice_native_input_contract,
                                       modele_ice_input_contract)
from icebin_tpu.regrid.gcmregridder import GCMRegridder
from icebin_tpu.regrid.matrices import RegridMatrices, RegridParams

from icebin_tpu_torch.coupler.ledger import Ledger, repair_mass, weighted_mass
from icebin_tpu_torch.models.ice_sheet import (RHO_ICE, IceFluxes,
                                               IceSheetConfig, IceSheetState,
                                               init_state, step_coupled)
from icebin_tpu_torch.ops.apply import apply_view
from icebin_tpu_torch.ops.csr import csr_view_pair

__all__ = ["CouplerConfig", "IceSheetCoupler", "GCMCoupler"]

_F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class CouplerConfig:
    dt: float = 86400.0 * 30      # coupling interval [s]
    regen_every: int = 10         # rebuild matrices every N steps
    min_thickness: float = 1.0    # m; below = ice-free for masking
    params: RegridParams = RegridParams(scale=True, correctA=True)
    repair: bool = True           # f64 mass repair on every apply
    #: input fields that are extensive fluxes -- mass-repaired after the
    #: IvE transport (intensive fields like temperature must not be)
    repair_fields: tuple = ("smb_mass", "smb_enth", "deltah", "heat_flux",
                            "geothermal_flux", "rain_mass", "rain_enth")
    #: fields per kernel call; the 8-field forcing and 10-field harvest
    #: each ride one call
    nv: int = 16
    #: accepted for API parity with the reference; the kernels always sum
    #: in f64, so there is no accuracy mode to select
    prods_passes: Optional[int] = None
    #: True = ``couple`` books its ledger row without a device->host sync
    #: (``Ledger.post_deferred``); the books are identical
    defer_ledger: bool = False


class IceSheetCoupler:
    """One ice sheet's coupling state on ``device``."""

    #: contract fields whose repaired sum enters the column energy budget
    ENERGY_IN_FIELDS = ("smb_enth", "deltah", "heat_flux",
                        "geothermal_flux")
    #: ledger row names, in the order of ``_couple_core``'s stats vector
    STAT_KEYS = ("mass_in_E", "mass_delivered_I", "ice_mass",
                 "mass_returned_I", "mass_clamp_I", "mass_residual",
                 "energy_in_E", "energy_delivered_I", "energy_pdd_implied",
                 "energy_storage_I", "energy_returned_I", "energy_clamp_I",
                 "energy_residual", "mass_rain_through",
                 "energy_rain_through")

    def __init__(self, gr: GCMRegridder, sheet: str, cfg: CouplerConfig, *,
                 device, ice_cfg: Optional[IceSheetConfig] = None,
                 ice_state: Optional[IceSheetState] = None,
                 contract_in: Optional[VarSet] = None,
                 contract_in_ice: Optional[VarSet] = None,
                 contract_out: Optional[VarSet] = None):
        self.gr = gr
        self.sheet = sheet
        self.cfg = cfg
        self.device = torch.device(device)
        specI = gr.sheets[sheet].specI
        dx = float(np.diff(specI.xb).mean())
        dy = float(np.diff(specI.yb).mean())
        self.ice_cfg = ice_cfg or IceSheetConfig(nx=specI.nx, ny=specI.ny,
                                                 dx=dx, dy=dy)
        self.state = (ice_state if ice_state is not None
                      else init_state(self.ice_cfg, device=self.device))
        self.cell_area = dx * dy
        #: the ice model (fn(cfg, state, smb, tsurf, dt, enth_flux) ->
        #: (state, IceFluxes))
        self.ice_step = step_coupled
        self.contract_in = contract_in or modele_ice_input_contract()
        self.contract_in_ice = contract_in_ice or ice_native_input_contract()
        self._fac_in, self._off_in = self.contract_in.conversion_to(
            self.contract_in_ice)
        self.contract_out = contract_out or ice_modele_output_contract()
        self.rm: Optional[RegridMatrices] = None
        self._mats: Dict[str, object] = {}
        self.steps_since_regen = 0
        #: GCM-held extensive EC state means, remapped through E1vE0 at
        #: every regeneration (host f64)
        self.held_E: Optional[np.ndarray] = None
        self.held_default = 0.0
        self.regen_matrices()

    # -- matrix lifecycle --------------------------------------------------

    def elevmask(self) -> np.ndarray:
        return self.state.elevmask(self.cfg.min_thickness).cpu().numpy()

    def regen_matrices(self, elevmask=None) -> Optional[RegridMatrices]:
        """(Re)build the matrices from the current ice surface (or an
        explicit elevmask); returns the PREVIOUS factory (for E1vE0)."""
        old = self.rm
        if elevmask is None:
            elevmask = self.elevmask()
        self.regen_elevmask = np.asarray(elevmask)
        self.rm = self.gr.regrid_matrices(self.sheet, elevmask)
        self._mats = {}
        self._build_mats()
        self.steps_since_regen = 0
        return old

    def _pair(self, M, small_axis="rows"):
        return csr_view_pair(M, nv=self.cfg.nv, small_axis=small_axis,
                             device=self.device)

    def _build_mats(self) -> None:
        """EvI/IvE/AvI/IvA device applies.  Unsmoothed, IvE (IvA) is the
        exact transpose of EvI (AvI), so one pack serves both; with sigma
        smoothing the reverse direction is packed from its own canonical
        matrix (S is asymmetric)."""
        share = self.cfg.params.sigma is None
        for name in ("EvI", "AvI"):
            rev_name = "Iv" + name[0]
            fwd, rev = self._pair(self.rm.matrix(name, self.cfg.params))
            self._mats[name] = fwd
            if not share:
                rev = self._pair(self.rm.matrix(rev_name, self.cfg.params),
                                 small_axis="cols")[0]
            self._mats[rev_name] = rev

    def mat(self, name: str):
        """Any of the six user matrices as a device apply; AvE/EvA build
        lazily and drop at each regeneration like the rest."""
        if name not in self._mats and name in ("AvE", "EvA"):
            M = self.rm.matrix("AvE", dataclasses.replace(self.cfg.params,
                                                          sigma=None))
            self._mats["AvE"], self._mats["EvA"] = self._pair(M)
        return self._mats[name]

    def apply(self, name: str, f, var_factor=None, var_offset=None):
        """Apply matrix ``name`` to a device field, with the f64 mass repair
        (unless a unit conversion is fused)."""
        return self._apply_mat(self.mat(name), f, var_factor=var_factor,
                               var_offset=var_offset)

    def _apply_mat(self, bm, f, var_factor=None, var_offset=None):
        out = apply_view(bm, f, scale=True, var_factor=var_factor,
                         var_offset=var_offset, fill=math.nan)
        if self.cfg.repair and var_factor is None and var_offset is None:
            m_src = weighted_mass(f, bm.Mw).reshape(-1)
            out2 = torch.where(torch.isfinite(out), out, 0.0)
            out = repair_mass(out2[None] if out.dim() == 1 else out2,
                              bm.wM, m_src)
            out = out[0] if f.dim() == 1 else out
        return out

    # -- GCM-held EC state (E1vE0 across regenerations) ---------------------

    def set_held_state(self, fields, default: float = 0.0) -> None:
        """(n_held, nE) extensive EC state means the GCM holds per EC."""
        f = np.asarray(fields, dtype=np.float64)
        self.held_E = f[None, :].copy() if f.ndim == 1 else f.copy()
        self.held_default = float(default)

    def held_mass(self) -> float:
        """f64 total of held state in the CURRENT EC measure."""
        if self.held_E is None:
            return 0.0
        return float(np.sum(self.held_E * self.rm.ec_weights()[None, :]))

    def _remap_held(self, remap, old_rm: RegridMatrices, ledger: Ledger):
        """Apply E1vE0 to the held EC state; book dropped/gained mass."""
        f0 = self.held_E
        w0_full = old_rm.ec_weights()
        w1_full = self.rm.ec_weights()
        f1 = np.atleast_2d(remap.apply(f0, scale=True,
                                       fill=self.held_default))
        dropped = float(np.sum(f0 * (w0_full - remap.Mw)[None, :]))
        gained = float(np.sum(f1 * (w1_full - remap.wM)[None, :]))
        self.held_E = f1
        ledger.post(f"{self.sheet}.held_mass",
                    float(np.sum(f1 * w1_full[None, :])))
        ledger.post(f"{self.sheet}.held_mass_dropped", dropped)
        ledger.post(f"{self.sheet}.held_mass_gained", gained)

    # -- one coupling step -------------------------------------------------

    def _couple_core(self, ive, evi, avi, state, fE_in):
        """The device math of one coupling step.  Returns (fI, fE_out,
        fA_out, new_state, stats (15,) f64)."""
        cfg = self.cfg
        cin = self.contract_in
        dev = fE_in.device
        fac = torch.as_tensor(self._fac_in, dtype=fE_in.dtype, device=dev)
        off = torch.as_tensor(self._off_in, dtype=fE_in.dtype, device=dev)
        # 1. E -> I forcing transport fused with the unit conversion
        fI = apply_view(ive, fE_in, scale=True, var_factor=fac,
                        var_offset=off, fill=math.nan)
        fI64 = None
        rep = list(cfg.repair_fields)
        if cfg.repair:
            # the f64 repaired rows feed the ledger, their f32 downcast
            # the model (its quantization lands in the residual rows)
            idx = torch.as_tensor([cin.index(n) for n in rep], device=dev)
            src_conv = fE_in[idx] * fac[idx, None]
            m_src = weighted_mass(src_conv, ive.Mw)
            sub = torch.where(torch.isfinite(fI[idx]), fI[idx], 0.0)
            fI64 = repair_mass(sub, ive.wM, m_src)
            fI[idx] = torch.where(torch.isfinite(fI[idx]),
                                  fI64.to(fI.dtype), fI[idx])

        def row(name):
            """Finite-cleaned forcing row: f64 repaired where available."""
            if fI64 is not None and name in rep:
                r = fI64[rep.index(name)]
            else:
                r = fI[cin.index(name)]
            return torch.where(torch.isfinite(r), r, 0.0)

        # projection-area correction at the model boundary: transported
        # densities are per matrix-measure area (wM), the lattice model
        # integrates over plane cells (dx*dy)
        wMi = ive.wM.to(_F64)
        mfac = wMi / self.cell_area
        smbI = row("smb_mass") * mfac
        tsI = row("tsurf")
        rainI = row("rain_mass") * mfac
        rain_enthI = row("rain_enth") * mfac
        enthI = sum(row(n) for n in self.ENERGY_IN_FIELDS) * mfac

        def _sum(x):
            return x.reshape(-1).to(_F64).sum()

        def e_src(name):
            k = cin.index(name)
            return weighted_mass(fE_in[k] * fac[k], ive.Mw) * cfg.dt

        m_in = e_src("smb_mass") + e_src("rain_mass")
        e_in = (sum(e_src(n) for n in self.ENERGY_IN_FIELDS)
                + e_src("rain_enth"))
        mass0 = _sum(state.H) * self.cell_area * RHO_ICE
        e_store0 = _sum(state.enth) * self.cell_area
        if fI64 is not None:
            def dlv(name):
                return weighted_mass(fI64[rep.index(name)], ive.wM) * cfg.dt
        else:
            def dlv(name):
                return weighted_mass(row(name), ive.wM) * cfg.dt
        m_delivered = dlv("smb_mass") + dlv("rain_mass")
        m_rain = dlv("rain_mass")
        e_rain = dlv("rain_enth")
        e_delivered = sum(dlv(n) for n in self.ENERGY_IN_FIELDS) + e_rain

        # 2. ice model step
        new_state, fx = self.ice_step(self.ice_cfg, state, smbI, tsI,
                                      cfg.dt, enthI)
        mass1 = _sum(new_state.H) * self.cell_area * RHO_ICE
        e_store1 = _sum(new_state.enth) * self.cell_area
        ad = self.cell_area * cfg.dt
        shed = (fx.runoff + fx.basal_melt + fx.calving).to(_F64)
        m_returned = shed.sum() * ad + m_rain
        m_clamp = fx.mass_clamp.to(_F64).sum() * ad
        e_shed = (fx.enth_runoff + fx.enth_basal + fx.enth_calving).to(_F64)
        e_returned = e_shed.sum() * ad + e_rain
        e_clamp = fx.enth_clamp.to(_F64).sum() * ad
        e_pdd = fx.latent_pdd.to(_F64).sum() * ad

        # 3. harvest I -> E/A (flux rows back to the matrix measure)
        inv = torch.where(wMi > 0,
                          self.cell_area / torch.where(wMi > 0, wMi, 1.0),
                          0.0)
        outI = self._ice_outputs(new_state, fx, rainI, rain_enthI, inv)
        fE_out = self._apply_mat(evi, outI)
        fA_out = self._apply_mat(avi, outI)

        # residual rows: defined so the ledger identities hold exactly
        m_del_f32 = (_sum(smbI) + _sum(rainI)) * ad
        e_del_f32 = _sum(enthI) * ad
        m_residual = ((mass1 - mass0 - m_del_f32 + m_returned - m_clamp)
                      + (m_del_f32 - m_delivered))
        e_residual = ((e_store1 - e_store0 - e_del_f32
                       + (e_returned - e_rain) + e_clamp)
                      + (e_del_f32 + e_rain - e_delivered))
        stats = torch.stack([
            m_in, m_delivered, mass1, m_returned, m_clamp, m_residual,
            e_in, e_delivered, e_pdd,
            e_store1, e_returned, e_clamp, e_residual,
            m_rain, e_rain])
        return fI, fE_out, fA_out, new_state, stats

    def _mats_hot(self):
        return self.mat("IvE"), self.mat("EvI"), self.mat("AvI")

    def couple(self, t: float, fE_in: torch.Tensor, ledger: Ledger):
        """fE_in: (n_contract_in, nE) GCM fields on the E grid, GCM units,
        on this coupler's device.  Returns E/A-grid outputs and
        diagnostics."""
        fI, fE_out, fA_out, new_state, stats = self._couple_core(
            *self._mats_hot(), self.state, fE_in)
        self.state = new_state
        keys = tuple(f"{self.sheet}.{k}" for k in self.STAT_KEYS)
        if self.cfg.defer_ledger:
            ledger.post_deferred(keys, stats)
        else:
            for k, v in zip(keys, stats.cpu().tolist()):
                ledger.post(k, v)
        self.steps_since_regen += 1
        remap = self._regen_if_due(ledger)
        return {"fI": fI, "fE_out": fE_out, "fA_out": fA_out,
                "E1vE0": remap,
                "fhc": self.rm.fhc(), "elevE": self.rm.elevE()}

    def _regen_if_due(self, ledger: Ledger):
        """Regenerate matrices + E1vE0-remap held state when due; returns
        the E1vE0 remap or None."""
        remap = None
        if self.steps_since_regen >= self.cfg.regen_every:
            old_rm = self.regen_matrices()
            if old_rm is not None:
                remap = e1ve0_matrix(old_rm, self.rm)
                if self.held_E is not None:
                    self._remap_held(remap, old_rm, ledger)
        return remap

    def couple_window(self, fE_seq: torch.Tensor):
        """K coupling steps on fixed matrices (the caller bounds K by the
        regen cadence and regenerates at the boundary).  fE_seq:
        (K, n_contract_in, nE).  Returns (stats (K, 15) f64 host array,
        dict with the LAST step's fI/fE_out/fA_out); one host sync."""
        mats = self._mats_hot()
        stats, last = [], None
        for fE in fE_seq:
            fI, fE_out, fA_out, self.state, s = self._couple_core(
                *mats, self.state, fE)
            stats.append(s)
            last = {"fI": fI, "fE_out": fE_out, "fA_out": fA_out}
        self.steps_since_regen += len(stats)
        return torch.stack(stats).cpu().numpy(), last

    def _ice_outputs(self, state, fx: IceFluxes, rainI, rain_enthI,
                     inv_mfac) -> torch.Tensor:
        """(n_contract_out, nI) harvest in ice units: elevation, thickness,
        mask, runoff (+ rain), basal melt, calving, their enthalpies, and
        the column specific enthalpy."""
        icy = state.H.reshape(-1) > self.cfg.min_thickness
        elev = torch.where(icy, state.surface.reshape(-1), torch.nan)
        thick = torch.where(icy, state.H.reshape(-1), torch.nan)
        dt_ = state.H.dtype
        mask = icy.to(dt_)
        inv = inv_mfac.to(dt_)

        def r(x):
            return x.reshape(-1).to(dt_) * inv

        runoff = r(fx.runoff) + r(rainI)
        enth_run = r(fx.enth_runoff) + r(rain_enthI)
        h_col = torch.where(icy, state.specific_enthalpy().reshape(-1),
                            torch.nan)
        return torch.stack([elev, thick, mask,
                            runoff, r(fx.basal_melt), r(fx.calving),
                            enth_run, r(fx.enth_basal), r(fx.enth_calving),
                            h_col])


class GCMCoupler:
    """Multi-sheet coupling driver over a regridder, on ``device``."""

    def __init__(self, gr: GCMRegridder, cfg: CouplerConfig = CouplerConfig(),
                 *, device, sheets: Optional[Dict[str, IceSheetCoupler]] = None):
        self.gr = gr
        self.cfg = cfg
        self.device = torch.device(device)
        if sheets is None:
            sheets = {name: IceSheetCoupler(gr, name, cfg, device=device)
                      for name in gr.sheets}
        self.sheets = sheets
        self.ledger = Ledger()
        self.time = 0.0

    def couple(self, gcm_ovalsE: Dict[str, torch.Tensor]):
        """One coupling step for every sheet; gcm_ovalsE maps sheet name ->
        (n_in, nE) tensor on the coupler's device."""
        self.ledger.open_step(self.time)
        results = {name: sc.couple(self.time, gcm_ovalsE[name], self.ledger)
                   for name, sc in self.sheets.items()}
        self.time += self.cfg.dt
        return results

    def run_transient(self, forcing_fn: Callable[[float, str], torch.Tensor],
                      n_steps: int, fused: bool = False):
        """N-step transient loop, conservation booked per step.
        forcing_fn(t, sheet) -> (n_in, nE) tensor.  ``fused=True`` runs each
        regeneration window through ``couple_window`` (one host sync per
        window); ledger rows, regeneration and E1vE0 are the same."""
        if not fused:
            out = None
            for _ in range(n_steps):
                out = self.couple({name: forcing_fn(self.time, name)
                                   for name in self.sheets})
            return out
        return self._run_transient_fused(forcing_fn, n_steps)

    def _run_transient_fused(self, forcing_fn, n_steps: int):
        cfg = self.cfg
        results = None
        done = 0
        while done < n_steps:
            k = max(1, min(n_steps - done,
                           *(sc.cfg.regen_every - sc.steps_since_regen
                             for sc in self.sheets.values())))
            t0 = self.time
            stats, results = {}, {}
            for name, sc in self.sheets.items():
                fE_seq = torch.stack([forcing_fn(t0 + i * cfg.dt, name)
                                      for i in range(k)])
                stats[name], results[name] = sc.couple_window(fE_seq)
            for i in range(k):
                self.ledger.open_step(t0 + i * cfg.dt)
                for name in self.sheets:
                    for j, key in enumerate(IceSheetCoupler.STAT_KEYS):
                        self.ledger.post(f"{name}.{key}", stats[name][i, j])
            self.time += k * cfg.dt
            done += k
            for name, sc in self.sheets.items():
                results[name]["E1vE0"] = sc._regen_if_due(self.ledger)
                results[name]["fhc"] = sc.rm.fhc()
                results[name]["elevE"] = sc.rm.elevE()
        return results
