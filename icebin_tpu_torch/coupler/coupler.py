"""GCM<->ice coupling driver (port of ``icebin_tpu/coupler/coupler.py``).

One coupling step (``IceSheetCoupler._couple_core``): IvE forcing transport
with fused unit conversion -> f64 mass repair of the extensive fields ->
SIA ice step (mass and enthalpy columns) -> EvI/AvI harvest, each repaired
-> a 15-entry f64 ledger row.  Every ``regen_every`` steps the matrices are
rebuilt from the evolved surface and GCM-held EC state is remapped through
E1vE0.  Unit contracts, and the host matrix factory and E1vE0, are the
port's own copies of the reference's host modules.

Differences from the reference:

* The device is the tensors' device (given explicitly to the constructors);
  the reference's engine strings ("pallas"/"xla"/"auto") are gone, and
  ``CouplerConfig.nv`` replaces ``pallas_nv``.
* Mass and energy books (mfac, ledger sums) are always f64.
* A sheet steps only through its window (``launch_window`` enqueues K
  steps, ``finish_window`` fetches their K ledger rows in one copy), and
  ``GCMCoupler`` runs and books every window in one routine (``_window``):
  ``couple`` is a window of one, ``run_transient(fused=True)`` windows
  bounded by the regeneration cadence.
* The compiled step (the reference's ``jax.jit`` of ``_couple_core``) is a
  CUDA graph (``coupler.step_graph``): a sheet whose matrices are the
  single-device ``CsrView`` packs and whose ice model is fusible by the
  reference's rule (``_model_fusible``) captures ``_couple_core`` with the
  SIA at a fixed budget of CFL substeps (``advance(..., substeps=s)``),
  once per budget, and replays it.  The graph is kept across
  regenerations: on the device path the new packs are loaded into the
  buffers it reads and its dest-small launches are rebound in place
  (``_rebind_graphs``); a host-path regeneration captures it again.  A
  window replays its K steps back to back and reads its rows and (short,
  substeps) flags once at the end, so a window is one sync, as the
  reference's ``lax.scan`` is.  A window whose budget fell short reruns
  from its start at a larger budget, and later windows start at the most
  substeps seen (``finish_window``).  The graph runs the eager
  step's operations in its order, so its results are the eager step's bit
  for bit.  On the CPU the same loop runs the budgeted step eagerly.
  Mesh-sharded views and other models (DISMAL) run ``_couple_core``
  eagerly, as there; which models a fused run takes window by window is
  the reference's rule too, so the two packages dump and checkpoint on the
  same steps.
* Fields reach the writer through ``.cpu().numpy()``.
* Regeneration runs on the device (``regrid.device``) for a single-device
  sheet without sigma smoothing: the sheet's exchange grid is uploaded
  once, and every regeneration assembles the EvI/AvI CSRs, E1vE0 and the
  elevation-class measures there from the ice state's elevation mask,
  bit for bit the host factory's.  With sigma (a scipy composition) and
  on a mesh rank (``coupler.sharded``, blocks cut from ``rm.matrix``) the
  host factory builds them, as in the reference.  ``regens_device`` and
  ``regens_host`` count the matrix builds by path.  The regridder may be
  ModelE's mismatched one (``regrid.modele.GCMRegridderModelE``, its
  exchange grids against the ocean grid O): it hands the device path its
  cells moved to A and scaled (``device_exchange``) and the host path its
  retargeted factory, so both build A-level matrices.
* The host work of a fused window and of a regeneration is spanned
  (``utils.trace``: ``window``, ``window.forcing``, ``window.launch``,
  ``window.fetch``, ``regen`` and its stages, ``regen.topo``); the
  recorder is off unless a caller switches it on.
* With a ``mesh`` (``parallel.mesh.IceMesh``) each rank runs its own
  ``GCMCoupler`` over its y-block of every sheet (``coupler.sharded``):
  the applies dispatch to the sharded views, sums over the ice lattice add
  the ranks' partials in rank order (``_across``; sums over the replicated
  A and E spaces are not reduced), and the writer gathers ice fields and
  writes from rank 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from icebin_tpu_torch.coupler.e1ve0 import e1ve0_matrix
from icebin_tpu_torch.coupler.ledger import Ledger, weighted_mass
from icebin_tpu_torch.coupler.varset import (VarSet,
                                             ice_modele_output_contract,
                                             ice_native_input_contract,
                                             modele_ice_input_contract)
from icebin_tpu_torch.coupler.step_graph import StepGraph
from icebin_tpu_torch.models.ice_sheet import (RHO_ICE, IceFluxes,
                                               IceSheetConfig, IceSheetState,
                                               advance, init_state,
                                               step_coupled)
from icebin_tpu_torch.ops.apply import apply_view
from icebin_tpu_torch.ops.books import (Rows, books_repair, books_stats,
                                        books_sum)
from icebin_tpu_torch.ops.csr import (CsrBuffers, CsrView, csr_pack_sorted,
                                      csr_view_pair)
from icebin_tpu_torch.regrid.device import (DeviceRegridMatrices,
                                            e1ve0_device)
from icebin_tpu_torch.regrid.gcmregridder import GCMRegridder
from icebin_tpu_torch.regrid.matrices import RegridMatrices, RegridParams
from icebin_tpu_torch.utils.trace import span

__all__ = ["CouplerConfig", "IceSheetCoupler", "GCMCoupler"]

_F64 = torch.float64
#: the matrices the coupling step applies, each with its transpose (IvE,
#: IvA)
HOT = ("EvI", "AvI")


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
    #: accepted and has no effect: every window books its rows from one
    #: fetch
    defer_ledger: bool = False


class HostRegen:
    """How a coupler builds its matrices on the host: the host factory
    (``RegridMatrices``), ``csr_pack`` and ``e1ve0_matrix``.  Taken with
    sigma smoothing and by a mesh rank."""

    path = "host"

    def __init__(self, sc: "IceSheetCoupler"):
        self.sc = sc

    def factory(self, elevmask):
        """(the mask on the host, the factory built from it)."""
        if isinstance(elevmask, torch.Tensor):
            elevmask = elevmask.cpu().numpy()
        elevmask = np.asarray(elevmask)
        return elevmask, self.sc.gr.regrid_matrices(self.sc.sheet, elevmask)

    def pair(self, rm, name: str, params: RegridParams, small_axis="rows"):
        """Device views over one pack of ``rm``'s matrix ``name``:
        (forward, reverse) with ``small_axis`` its rows, else (reverse,
        forward)."""
        with span("regen.factory", sheet=self.sc.sheet):
            M = rm.matrix(name, params)
        return csr_view_pair(M, nv=self.sc.cfg.nv, small_axis=small_axis,
                             device=self.sc.device)

    @staticmethod
    def e1ve0(old, new):
        return e1ve0_matrix(old, new)


class DeviceRegen:
    """How a coupler builds its matrices on the device (``regrid.device``):
    the sheet's exchange grid, as its regridder hands it over
    (``device_exchange``: A-level cells, for ModelE's regridder its O-level
    cells moved to A and scaled), uploaded once, here (span
    ``regen.upload``), ``DeviceRegridMatrices``, ``csr_pack_sorted`` and
    ``e1ve0_device``.  The hot packs (``HOT``) are loaded into buffers
    sized once for the most entries the exchange grid can give
    (``CsrBuffers``, ``DeviceExchange.max_entries``), so every generation's
    lies where the compiled step's graphs read.  Taken on one device
    without sigma smoothing."""

    path = "device"

    def __init__(self, sc: "IceSheetCoupler"):
        self.sc = sc
        with span("regen.upload", sheet=sc.sheet):
            self.xd = sc.gr.device_exchange(sc.sheet, sc.device)
            if self.xd.ocean is not None:
                self.xd.count_ocean_iced(sc.elevmask())
        #: by hot matrix, the buffers its packs are loaded into
        self.buffers: Dict[str, CsrBuffers] = {}

    def factory(self, elevmask):
        """(the mask as given, the factory built from it)."""
        if not isinstance(elevmask, torch.Tensor):
            elevmask = np.asarray(elevmask)
        return elevmask, DeviceRegridMatrices(self.xd, elevmask)

    def pair(self, rm, name: str, params: RegridParams):
        """(forward, reverse) views over one pack of ``rm``'s matrix
        ``name``, its rows the small side, packed on the device."""
        with span("regen.factory", sheet=self.sc.sheet):
            rows, cols, vals, shape = rm.coo(name, params)
        pack = csr_pack_sorted(rows, cols, vals, shape, nv=self.sc.cfg.nv)
        if name in HOT:
            if name not in self.buffers:
                self.buffers[name] = CsrBuffers(
                    *shape, self.xd.max_entries(name), pack.nv,
                    device=self.sc.device)
            with span("regen.pack", sheet=self.sc.sheet):
                pack = self.buffers[name].load(pack)
        return CsrView(pack, transposed=False), CsrView(pack,
                                                        transposed=True)

    @staticmethod
    def e1ve0(old, new):
        return e1ve0_device(old, new)


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
        #: the unit conversion as device constants by forcing dtype (a copy
        #: from a host list inside the step would break its capture)
        self._conv: Dict[torch.dtype, tuple] = {}
        self._conversion(torch.float32)
        self.contract_out = contract_out or ice_modele_output_contract()
        #: the current matrix factory (``RegridMatrices`` or
        #: ``DeviceRegridMatrices``)
        self.rm = None
        self._mats: Dict[str, object] = {}
        self.steps_since_regen = 0
        #: GCM-held extensive EC state means, remapped through E1vE0 at
        #: every regeneration (host f64)
        self.held_E: Optional[np.ndarray] = None
        self.held_default = 0.0
        #: (ny, nx) bool mask of the physical lattice cells, or None when
        #: all are; a ragged mesh decomposition's pad rows are not
        self._active_mask: Optional[torch.Tensor] = None
        #: the matrix generation (counted by ``regen_matrices``), and the
        #: one whose fhc and elevE are computed
        self._gen = 0
        self._topo_gen = 0
        #: the compiled step: a graph by substep budget, kept across
        #: regenerations, under the key of what else it froze; the budgets
        #: whose graph is captured again at its next run; whether each hot
        #: matrix had live rows when the graphs were last made or rebound
        self._graphs: Dict[int, StepGraph] = {}
        self._graph_key = None
        self._stale: set = set()
        self._live = None
        #: on the card, the captures' side stream
        self._capture_stream = None
        #: CFL substeps the compiled step starts at (the most seen)
        self.budget = 1
        #: compiled-step counters: graph replays, budget reruns (steps or
        #: windows run again at a larger budget), each capture's ms, and
        #: the regenerations the kept graphs served (``_rebind_graphs``)
        self.replays = 0
        self.reruns = 0
        self.capture_ms: list = []
        self.rebinds = 0
        #: matrix builds (the first, resumes and regenerations) by path
        self.regens_device = 0
        self.regens_host = 0
        #: how matrices are built, decided once
        self.regen = (DeviceRegen(self) if self._regen_on_device()
                      else HostRegen(self))
        self.regen_matrices()

    def place_state(self, state: IceSheetState) -> None:
        """Take ``state`` (the whole lattice) as this coupler's; a mesh
        coupler keeps its rank's block."""
        self.state = state

    def gathered_state(self) -> IceSheetState:
        """The whole lattice's state (a mesh coupler gathers its ranks')."""
        return self.state

    def gather_ice(self, f: torch.Tensor) -> torch.Tensor:
        """A field over this coupler's ice cells as the whole lattice's."""
        return f

    def _across(self, *partials):
        """Totals over the ice lattice from this coupler's partial sums:
        the sums themselves on one device; a mesh coupler adds its ranks'
        in rank order."""
        return partials

    # -- matrix lifecycle --------------------------------------------------

    def elevmask(self) -> torch.Tensor:
        """The whole lattice's elevation mask, where the state lies."""
        return self.state.elevmask(self.cfg.min_thickness)

    @property
    def regen_elevmask(self) -> np.ndarray:
        """The elevation mask the current matrices were built from, on the
        host (a device mask is fetched at the first read)."""
        if isinstance(self._regen_elevmask, torch.Tensor):
            self._regen_elevmask = self._regen_elevmask.cpu().numpy()
        return self._regen_elevmask

    def _regen_on_device(self) -> bool:
        """Whether matrices are built on the device (``DeviceRegen``, else
        ``HostRegen``), decided once: without sigma smoothing, whose
        composition is the host factory's scipy product.  A mesh rank
        builds on the host (its override)."""
        return self.cfg.params.sigma is None

    def regen_matrices(self, elevmask=None):
        """(Re)build the matrices from the current ice surface (or an
        explicit elevmask); returns the PREVIOUS factory (for E1vE0)."""
        old = self.rm
        with span("regen.factory", sheet=self.sheet):
            self._regen_elevmask, self.rm = self.regen.factory(
                self.elevmask() if elevmask is None else elevmask)
        if self.regen.path == "device":
            self.regens_device += 1
        else:
            self.regens_host += 1
        self._mats = {}
        self._build_mats()
        self.steps_since_regen = 0
        self._gen += 1
        self._rebind_graphs()
        return old

    def _build_mats(self) -> None:
        """EvI/IvE/AvI/IvA device applies.  Unsmoothed, IvE (IvA) is the
        exact transpose of EvI (AvI), so one pack serves both; with sigma
        smoothing (host factory) the reverse direction is packed from its
        own canonical matrix (S is asymmetric)."""
        for name in HOT:
            rev_name = "Iv" + name[0]
            fwd, rev = self.regen.pair(self.rm, name, self.cfg.params)
            self._mats[name] = fwd
            if self.cfg.params.sigma is not None:
                rev = self.regen.pair(self.rm, rev_name, self.cfg.params,
                                      small_axis="cols")[0]
            self._mats[rev_name] = rev

    def mat(self, name: str):
        """Any of the six user matrices as a device apply; AvE/EvA build
        lazily and drop at each regeneration like the rest.  On the device
        path the hot views (EvI, IvE, AvI, IvA) lie in buffers that every
        regeneration reloads: a view is valid until the next one."""
        if name not in self._mats and name in ("AvE", "EvA"):
            self._mats["AvE"], self._mats["EvA"] = self.regen.pair(
                self.rm, "AvE",
                dataclasses.replace(self.cfg.params, sigma=None))
        return self._mats[name]

    def apply(self, name: str, f, var_factor=None, var_offset=None):
        """Apply matrix ``name`` to a device field, with the f64 mass repair
        (unless a unit conversion is fused)."""
        return self._apply_mat(self.mat(name), f, var_factor=var_factor,
                               var_offset=var_offset,
                               lattice=name not in ("AvE", "EvA"))

    def _apply_mat(self, bm, f, var_factor=None, var_offset=None,
                   lattice=True):
        """``bm`` applied to ``f`` with the repair; ``lattice``: the view's
        ice side is the ice lattice (all but AvE/EvA), so the repair's sums
        over that side are totals across ranks (``_across``).  The repair's
        sums are one ``books_sum``, its write one ``books_repair``."""
        out = apply_view(bm, f, scale=True, var_factor=var_factor,
                         var_offset=var_offset, fill=math.nan)
        if self.cfg.repair and var_factor is None and var_offset is None:
            out2 = out[None] if out.dim() == 1 else out
            nv = len(out2)
            sums = self._books(Rows(f, w=bm.Mw), Rows(out2, w=bm.wM),
                               Rows(bm.wM))
            m_src, m_dst, wtot = sums[:nv], sums[nv:2 * nv], sums[2 * nv]
            if lattice and not bm.transposed:       # the source is ice
                (m_src,) = self._across(m_src)
            elif lattice:                           # the destination is
                m_dst, wtot = self._across(m_dst, wtot)
            out = books_repair(out2, bm.wM, m_src, m_dst, wtot,
                               weighted_mass=weighted_mass)[0]
            out = out[0] if f.dim() == 1 else out
        return out

    def _books(self, *groups: Rows) -> torch.Tensor:
        """``books_sum`` of ``groups``, its plain version taking this
        module's ``weighted_mass``."""
        return books_sum(*groups, weighted_mass=weighted_mass)

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

    def _conversion(self, dtype: torch.dtype):
        """(factor, offset) device tensors of the input contract's
        conversion, for forcing of ``dtype``."""
        if dtype not in self._conv:
            self._conv[dtype] = (
                torch.as_tensor(self._fac_in, dtype=dtype,
                                device=self.device),
                torch.as_tensor(self._off_in, dtype=dtype,
                                device=self.device))
        return self._conv[dtype]

    def _couple_core(self, ive, evi, avi, state, fE_in, ice_step=None):
        """The device math of one coupling step, with the ice model
        ``ice_step`` (default ``self.ice_step``).  Returns (fI, fE_out,
        fA_out, new_state, stats (15,) f64).  The books take a launch a
        stage on the card (``ops.books``): the forcing repair's sums and
        its write, the step's sums, each harvest apply's sums and write,
        and the ledger row."""
        cfg = self.cfg
        cin = self.contract_in
        fac, off = self._conversion(fE_in.dtype)
        # 1. E -> I forcing transport fused with the unit conversion
        fI = apply_view(ive, fE_in, scale=True, var_factor=fac,
                        var_offset=off, fill=math.nan)
        fI64 = None
        rep = list(cfg.repair_fields)
        dl_names = ("smb_mass", "rain_mass", "rain_enth",
                    *self.ENERGY_IN_FIELDS)
        if cfg.repair:
            # the f64 repaired rows feed the ledger, their f32 downcast
            # the model (its quantization lands in the residual rows)
            irep = [cin.index(n) for n in rep]
            nr = len(irep)
            sums = self._books(Rows(fE_in, irep, w=ive.Mw, scale=fac),
                               Rows(fI, irep, w=ive.wM), Rows(ive.wM))
            m_dst, wtot = self._across(sums[nr:2 * nr], sums[2 * nr])
            fI64, dls = books_repair(
                fI, ive.wM, sums[:nr], m_dst, wtot, rows=irep, into=True,
                sums=[rep.index(n) for n in dl_names],
                weighted_mass=weighted_mass)

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

        # 2. ice model step
        new_state, fx = (ice_step or self.ice_step)(
            self.ice_cfg, state, smbI, tsI, cfg.dt, enthI)

        # the step's sums in one stage: the lattice totals before and after
        # it (pad rows out), the delivered sums where the repair did not
        # take them, and the E-side sources (replicated: not reduced)
        mask = self._active_mask
        irows = [cin.index(n) for n in dl_names]
        sums = self._books(
            *(Rows(x, mask=mask) for x in (state.H, state.enth, smbI, rainI,
                                           enthI)),
            *(() if fI64 is not None else
              (Rows(fI, irows, w=ive.wM, split=True),)),
            Rows(new_state.H, mask=mask), Rows(new_state.enth, mask=mask),
            Rows(fx.runoff, extra=(fx.basal_melt, fx.calving)),
            Rows(fx.mass_clamp),
            Rows(fx.enth_runoff, extra=(fx.enth_basal, fx.enth_calving)),
            Rows(fx.enth_clamp), Rows(fx.latent_pdd),
            Rows(fE_in, irows, w=ive.Mw, scale=fac, split=True))
        k = 5 if fI64 is not None else 12
        if fI64 is None:
            dls = sums[5:12]
        # the ice-lattice totals, in one cross-rank sum on a mesh
        pre, dls, post = self._across(sums[:5], dls, sums[k:k + 7])
        stats = books_stats(pre, dls, post, sums[k + 7:],
                            cell_area=self.cell_area, rho=RHO_ICE, dt=cfg.dt)

        # 3. harvest I -> E/A (flux rows back to the matrix measure)
        inv = torch.where(wMi > 0,
                          self.cell_area / torch.where(wMi > 0, wMi, 1.0),
                          0.0)
        outI = self._ice_outputs(new_state, fx, rainI, rain_enthI, inv)
        fE_out = self._apply_mat(evi, outI)
        fA_out = self._apply_mat(avi, outI)
        return fI, fE_out, fA_out, new_state, stats

    def _mats_hot(self):
        return self.mat("IvE"), self.mat("EvI"), self.mat("AvI")

    def _regen_if_due(self, ledger: Ledger):
        """Regenerate matrices + E1vE0-remap held state when due; returns
        the E1vE0 remap or None."""
        if self.steps_since_regen < self.cfg.regen_every:
            return None
        remap = None
        with span("regen", sheet=self.sheet, path=self.regen.path,
                  grid=self.gr.grid_kind):
            old_rm = self.regen_matrices()
            if old_rm is not None:
                with span("regen.e1ve0", sheet=self.sheet):
                    remap = self.regen.e1ve0(old_rm, self.rm)
                    if self.held_E is not None:
                        self._remap_held(remap, old_rm, ledger)
        return remap

    def topo_fields(self):
        """(fhc, elevE) of the current matrix generation; the generation's
        first call computes them (span ``regen.topo``), later ones read the
        factory's cache."""
        if self._topo_gen != self._gen:
            with span("regen.topo", sheet=self.sheet):
                self.rm.fhc()
                self.rm.elevE()
            self._topo_gen = self._gen
        return self.rm.fhc(), self.rm.elevE()

    def couple_window(self, fE_seq: torch.Tensor):
        """K coupling steps on fixed matrices, the only way a sheet steps
        (the caller bounds K by the regen cadence and regenerates at the
        boundary; a per-step run's window is one step).  fE_seq:
        (K, n_contract_in, nE).  Returns (stats (K, 15) f64 host array,
        dict with the LAST step's fI/fE_out/fA_out, copies that alias no
        buffer of the compiled step).  Compiled, the K steps are K graph
        replays with no host read between them and one fetch at the end (a
        window whose budget fell short runs again from its start at a
        larger budget); eager, the K ``_couple_core`` steps and one fetch.
        ``launch_window`` and ``finish_window`` are its two halves: the
        first reads nothing on the host and moves no state, so a capture
        that fails raises before anything is taken or booked."""
        return self.finish_window(self.launch_window(fE_seq))

    def launch_window(self, fE_seq: torch.Tensor) -> "_Window":
        """Enqueue ``couple_window``'s K steps from the current state, at
        the current budget on the compiled step; ``finish_window`` fetches
        them and takes them as this sheet's."""
        with span("window.launch", sheet=self.sheet):
            if self._fusible():
                return self._window_compiled(fE_seq, self.budget)
            mats = self._mats_hot()
            state, stats = self.state, []
            for fE in fE_seq:
                fI, fE_out, fA_out, state, s = self._couple_core(
                    *mats, state, fE)
                stats.append(s)
            return _Window(fE_seq, None, torch.stack(stats),
                           {"fI": fI, "fE_out": fE_out, "fA_out": fA_out},
                           state)

    def finish_window(self, w: "_Window"):
        """The window's one fetch, and the budget rule: a compiled window
        that fell short runs again at ``min(2 * budget, n_substeps_max)``,
        and the budget rises to the most substeps seen; see
        ``couple_window``."""
        with span("window.fetch", sheet=self.sheet):
            host = w.rows.cpu().numpy()
        if w.budget is not None:
            n_max = self.ice_cfg.n_substeps_max
            if host[:, -2].any() and w.budget < n_max:
                self.reruns += 1
                with span("window.launch", sheet=self.sheet):
                    w = self._window_compiled(w.fE_seq,
                                              min(2 * w.budget, n_max))
                return self.finish_window(w)
            self.budget = max(self.budget, int(host[:, -1].max()))
        self.state = w.state
        self.steps_since_regen += len(host)
        return host[:, :len(self.STAT_KEYS)], w.last

    # -- the compiled step ---------------------------------------------------

    def _model_fusible(self) -> bool:
        """The model half of the reference's ``_fusible``
        (``coupler.py:485-493``): the ice model is the SIA step or marked
        ``jittable``."""
        return (self.ice_step is step_coupled
                or getattr(self.ice_step, "jittable", False))

    def _fusible(self) -> bool:
        """Whether this sheet runs the compiled step: the hot matrices are
        the single-device packs (not a mesh rank's views) and the model is
        fusible (``_model_fusible``)."""
        return (all(isinstance(m, CsrView) for m in self._mats_hot())
                and self._model_fusible())

    def _step_fn(self, substeps: int):
        """The compiled step over flat tensors: fn(H, bed, t, enth, fE_in)
        -> (fI, fE_out, fA_out, H, bed, t, enth, stats, flags): with the SIA
        at ``substeps`` CFL substeps, ``flags`` the (2,) int32 (short,
        active substeps); another model has no budget, and flags (0, 0)."""

        def fn(H, bed, t, enth, fE_in):
            flags = []
            ice = self.ice_step
            if ice is step_coupled:
                def ice(cfg, state, smb, tsurf, dt, enth_flux=None):
                    state, fx, short, n = advance(cfg, state, smb, tsurf,
                                                  dt, enth_flux,
                                                  substeps=substeps)
                    flags.append(torch.stack([short.to(n.dtype), n]))
                    return state, fx
            fI, fE_out, fA_out, st, stats = self._couple_core(
                *self._mats_hot(), IceSheetState(H=H, bed=bed, t=t,
                                                 enth=enth), fE_in,
                ice_step=ice)
            if not flags:
                flags.append(torch.zeros(2, dtype=torch.int32,
                                         device=H.device))
            return (fI, fE_out, fA_out, st.H, st.bed, st.t, st.enth, stats,
                    flags[0])

        return fn

    def _rebind_graphs(self) -> None:
        """Keep the compiled step's graphs for the matrices just built.  On
        the device path the hot packs lie in the buffers the graphs read,
        so each graph's dest-small launches only take the new live counts
        and geometry (``StepGraph.rebind``), and ``rebinds`` counts the
        regeneration.  A host-path regeneration (new tensors), or a hot
        matrix whose live rows appear or vanish (``spmm_dest_small``
        launches nothing over none), leaves every graph to be captured
        again at its next run."""
        if self.regen.path != "device":
            self._stale.update(self._graphs)
            return
        small = [self._mats[n].pack.small for n in HOT]
        live = tuple(c.n_live > 0 for c in small)
        kept, self._live = live == self._live, live
        if not kept:
            self._stale.update(self._graphs)
            return
        graphs = [g for s, g in self._graphs.items() if s not in self._stale]
        for g in graphs:
            g.rebind(small, self.cfg.nv)
        self.rebinds += bool(graphs)

    def _capture(self, substeps: int, inputs) -> StepGraph:
        """The graph of the step at budget ``substeps``, captured (on the
        card on the coupler's side stream); a graph kept at that budget is
        captured again over its own buffers and memory pool."""
        if self._capture_stream is None and inputs[0].is_cuda:
            self._capture_stream = torch.cuda.Stream(inputs[0].device)
        g = self._graphs.pop(substeps, None)
        self._stale.discard(substeps)
        if g is None:
            g = StepGraph(self._step_fn(substeps), inputs,
                          stream=self._capture_stream)
        else:
            g.capture()
        self._graphs[substeps] = g
        if g.capture_ms is not None:
            self.capture_ms.append(g.capture_ms)
        return g

    def _run_compiled(self, substeps: int, state, fE_in):
        """One run of the compiled step at budget ``substeps`` (captured at
        first use: a graph freezes the ice model, the configs and the
        inputs' layout, so a change of any drops the graphs) from ``state``
        ((H, bed, t, enth)); returns the step's static outputs."""
        inputs = (*state, fE_in)
        key = (self.ice_step, self.ice_cfg, self.cfg,
               tuple((x.shape, x.dtype) for x in inputs))
        if key != self._graph_key:
            for g in self._graphs.values():
                g.reset()
            self._graphs, self._stale = {}, set()
            self._graph_key = key
        g = self._graphs.get(substeps)
        if g is None or substeps in self._stale:
            g = self._capture(substeps, inputs)
        out = g.run(inputs)
        if g.graph is not None:
            self.replays += 1
        return out

    def _window_compiled(self, fE_seq, substeps: int) -> "_Window":
        """K compiled steps from ``self.state`` at budget ``substeps``, back
        to back: each step's stats and flags land in one (K, 17) f64
        buffer, and only the last step's outputs and state are copied
        out."""
        rows = torch.empty((len(fE_seq), len(self.STAT_KEYS) + 2),
                           dtype=_F64, device=self.device)
        st = self.state
        state = (st.H, st.bed, st.t, st.enth)
        for i, fE in enumerate(fE_seq):
            out = self._run_compiled(substeps, state, fE)
            rows[i, :-2].copy_(out[7])
            rows[i, -2:].copy_(out[8])
            state = out[3:7]
        H, bed, t, enth = (x.clone() for x in state)
        last = {k: x.clone() for k, x in zip(("fI", "fE_out", "fA_out"),
                                             out[:3])}
        return _Window(fE_seq, substeps, rows, last,
                       IceSheetState(H=H, bed=bed, t=t, enth=enth))

    def _ice_outputs(self, state, fx: IceFluxes, rainI, rain_enthI,
                     inv_mfac) -> torch.Tensor:
        """(n_contract_out, nI) harvest in ice units: elevation, thickness,
        mask, runoff (+ rain), basal melt, calving, their enthalpies, and
        the column specific enthalpy."""
        icy = state.H.reshape(-1) > self.cfg.min_thickness
        if self._active_mask is not None:       # ragged lattice pad rows
            icy = icy & self._active_mask.reshape(-1)
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


@dataclasses.dataclass
class _Window:
    """A window ``launch_window`` enqueued: its forcing, the substep budget
    of the compiled step (None: eager), the device rows (K, 15) of stats,
    or (K, 17) with (short, substeps) after them, the last step's outputs
    and the state after the window."""

    fE_seq: torch.Tensor
    budget: Optional[int]
    rows: torch.Tensor
    last: dict
    state: IceSheetState


class GCMCoupler:
    """Multi-sheet coupling driver over a regridder, on ``device``; with a
    ``mesh`` (``parallel.mesh.IceMesh``) every sheet is decomposed over its
    ranks (``coupler.sharded.MeshIceSheetCoupler``), on the mesh's device,
    and each rank constructs and drives its own ``GCMCoupler``
    (``icebin_tpu/coupler/coupler.py:648-654``)."""

    def __init__(self, gr: GCMRegridder, cfg: CouplerConfig = CouplerConfig(),
                 *, device=None,
                 sheets: Optional[Dict[str, IceSheetCoupler]] = None,
                 writer=None, mesh=None):
        self.gr = gr
        self.cfg = cfg
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"{mesh.device}")
            device = mesh.device
        if device is None:
            raise TypeError("GCMCoupler needs a device (or a mesh)")
        self.device = torch.device(device)
        self.mesh = mesh
        if sheets is None:
            if mesh is not None:
                from icebin_tpu_torch.coupler.sharded import (
                    MeshIceSheetCoupler)
                sheets = {name: MeshIceSheetCoupler(gr, name, cfg, mesh)
                          for name in gr.sheets}
            else:
                sheets = {name: IceSheetCoupler(gr, name, cfg,
                                                device=device)
                          for name in gr.sheets}
        self.sheets = sheets
        self.ledger = Ledger()
        #: optional ``CouplerWriter`` for per-step field dumps
        self.writer = writer
        self.time = 0.0

    def _dump(self, time: float, fE_in: Dict[str, torch.Tensor],
              results) -> None:
        """One writer dump, stamped ``time``, of every sheet's forcing and
        outputs, with the latest ledger row (the reference's fields and
        names); on a mesh every rank gathers the ice fields and rank 0
        writes."""
        fields = {}
        for name, r in results.items():
            fields[f"{name}.fE_in"] = fE_in[name]
            fields[f"{name}.fI"] = self.sheets[name].gather_ice(r["fI"])
            for key in ("fE_out", "fA_out"):
                fields[f"{name}.{key}"] = r[key]
        if self.mesh is None or self.mesh.rank == 0:
            self.writer.dump(time, {k: v.detach().cpu().numpy()
                                    for k, v in fields.items()},
                             self.ledger.to_rows()[-1])

    def _window(self, k: int, fE_seq: Callable[[str], torch.Tensor],
                stamp: Optional[float] = None):
        """Run and book one window of ``k`` steps for every sheet (span
        ``window``); ``fE_seq(name)`` gives the sheet's (k, n_in, nE)
        forcing.  Every sheet's window is launched before any is finished,
        so a compiled window is one host sync (more only where a budget
        fell short); then the k ledger rows are opened and posted, the time
        advances, each sheet regenerates when due (E1vE0, the held state's
        remap) and takes its topography, and the writer dumps the last
        step, stamped ``stamp`` (default: the window's end).  Returns the
        last step's results by sheet."""
        dt = self.cfg.dt
        with span("window"):
            t0 = self.time
            fE_last, pending, stats, results = {}, {}, {}, {}
            for name, sc in self.sheets.items():
                seq = fE_seq(name)
                fE_last[name] = seq[-1]
                pending[name] = sc.launch_window(seq)
            for name, sc in self.sheets.items():
                stats[name], results[name] = sc.finish_window(pending[name])
            for i in range(k):
                self.ledger.open_step(t0 + i * dt)
                for name in self.sheets:
                    for j, key in enumerate(IceSheetCoupler.STAT_KEYS):
                        self.ledger.post(f"{name}.{key}", stats[name][i, j])
            self.time += k * dt
            for name, sc in self.sheets.items():
                results[name]["E1vE0"] = sc._regen_if_due(self.ledger)
                results[name]["fhc"], results[name]["elevE"] = \
                    sc.topo_fields()
            if self.writer is not None:
                self._dump(self.time if stamp is None else stamp, fE_last,
                           results)
        return results

    def couple(self, gcm_ovalsE: Dict[str, torch.Tensor]):
        """One coupling step for every sheet: a window of one
        (``_window``).  gcm_ovalsE maps sheet name -> (n_in, nE) tensor on
        the coupler's device.  The writer's dump is stamped with the
        step's start, as the reference's ``couple`` stamps it."""
        return self._window(1, lambda name: gcm_ovalsE[name][None],
                            stamp=self.time)

    def run_transient(self, forcing_fn: Callable[[float, str], torch.Tensor],
                      n_steps: int, fused: bool = False):
        """N-step transient loop, conservation booked per step.
        forcing_fn(t, sheet) -> (n_in, nE) tensor.  ``fused=True`` runs
        windows bounded by the regeneration cadence (``_window``, each
        sheet's forcing stacked in span ``window.forcing``): ledger rows,
        regeneration and E1vE0 are the same, and the writer dumps each
        window's last step.  Unfused, or where a sheet's ice model the
        reference cannot fuse (``_model_fusible``), it is a loop of
        ``couple``, as there."""
        if not (fused and all(sc._model_fusible()
                              for sc in self.sheets.values())):
            out = None
            for _ in range(n_steps):
                out = self.couple({name: forcing_fn(self.time, name)
                                   for name in self.sheets})
            return out
        results = None
        done = 0
        while done < n_steps:
            k = max(1, min(n_steps - done,
                           *(sc.cfg.regen_every - sc.steps_since_regen
                             for sc in self.sheets.values())))
            t0 = self.time

            def fE_seq(name):
                with span("window.forcing", sheet=name):
                    return torch.stack([forcing_fn(t0 + i * self.cfg.dt,
                                                   name) for i in range(k)])
            results = self._window(k, fE_seq)
            done += k
        return results
