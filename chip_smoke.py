#!/usr/bin/env python3
"""Smoke run of icebin_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs CUDA

The main path is the coupled SeaRISE Greenland 5 km (304 x 544 polar
stereographic cells) x ModelE 2x2.5 (144 x 90, 5 elevation classes) system
that bench.py drives: the exchange grid is built through the clip kernel,
then a GCMCoupler runs 6 stepwise coupling steps in bench.py's production
mode (deferred ledger) with a matrix regeneration (and an E1vE0 remap of
GCM-held state) every 3, then one fused window.
Phases, each of which exits non-zero on failure:

1. build   every kernel of csrc/ with nvcc for sm_90a;
2. clip    the clip kernel against its plain version on all candidate
           pairs of the Greenland build;
3. main    the main path, with every launch counter set to 0 just before
           it and read just after: exchange build, coupler construction,
           6 stepwise steps, one fused window.  The exchange grid must
           match the shared f64 numpy builder and its column sums the cell
           areas; every ledger row's transport identity must hold < 1e-10;
4. spmm    the two regrid kernels on the real EvI/IvE/AvI/IvA at nv = 16
           against their plain version and the f64 scipy oracle (raw error
           < 5e-7), and a repeat run bit-identical;
5. profile torch.profiler over the steady steps before the next
           regeneration: device busy time per step, the device's idle
           share and the largest device operations;
6. toy     a small coupler on the GPU against the same coupler on the CPU
           (the plain versions) over 3 steps.

The last three lines are the kernels' JSON summary, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.  Every timing
line carries the card's name and power limit.
"""
import json
import subprocess
import sys
import time

import numpy as np

SEARISE = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +ellps=WGS84"
HCDEFS = [0.0, 500.0, 1000.0, 2000.0, 3500.0]
DT = 86400.0 * 30
REGEN = 3
TRANSPORT_TOL = 1e-10
RAW_TOL = 5e-7            # tests/test_accuracy_contract.py's 6-pass bound
COLSUM_TOL = 1e-12
CARD = ""


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def say(msg):
    print(f"[{CARD}] {msg}", flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, reps):
    """Device time of one call of ``fn``, CUDA events over ``reps`` calls
    after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_ms(fn):
    """Host time of ``fn`` up to a device synchronisation."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def greenland_specs(res_km=5.0):
    """bench.py's config #3 lattice: 304 x 544 cells at 5 km."""
    from icebin_tpu_torch.grid import GridSpecXY, modele_lonlat_grid
    nx, ny = int(round(1520 / res_km)), int(round(2720 / res_km))
    specI = GridSpecXY(xb=np.linspace(-650e3, 870e3, nx + 1),
                       yb=np.linspace(-3350e3, -630e3, ny + 1),
                       projection=SEARISE, name=f"greenland_{res_km:g}km")
    return modele_lonlat_grid(144, 90), specI


def forcing(nE, seed=0):
    """(8, nE) f32 ModelE-contract forcing (tsurf in degC)."""
    rng = np.random.default_rng(seed)
    f = np.zeros((8, nE), np.float32)
    f[0] = 1e-5 * rng.uniform(0.5, 1.0, nE)      # smb kg m-2 s-1
    f[1] = 5.0                                    # smb enthalpy W m-2
    f[3] = 2.0                                    # heat flux W m-2
    f[4] = -10.0                                  # degC
    f[6] = 2e-6 * rng.uniform(0.0, 1.0, nE)      # rain kg m-2 s-1
    return f


# -- phase 2: the clip kernel against its plain version --------------------

def phase_clip(specA, specI, device):
    import torch
    from icebin_tpu_torch.grid import clip_pairs
    from icebin_tpu_torch.ops.clip import (clip_areas_centroids,
                                           clip_areas_centroids_ref,
                                           recentre_pairs)
    pairA, pairI, subj, rect = clip_pairs(specA, specI, subdiv=2)
    p, r, _ = recentre_pairs(subj, rect)
    p = torch.as_tensor(p, device=device)
    r = torch.as_tensor(r, device=device)
    a, c = clip_areas_centroids(p, r)
    a_ref, c_ref = clip_areas_centroids_ref(p, r)
    cell = torch.as_tensor(specI.cell_areas()[pairI], device=device)
    err_a = ((a.double() - a_ref.double()).abs() / cell).max().item()
    # centroids divide by 6 * area, so f32 noise grows on slivers: compare
    # them where the overlap is at least 1% of its cell
    pos = a_ref.abs() > 1e-2 * cell.float()
    h = torch.maximum(r[:, 2], r[:, 3])[:, None]
    err_c = ((c - c_ref).abs() / h)[pos].max().item()
    abs_err = (a - a_ref).abs().max().item()             # m2
    say(f"clip: {len(pairA)} pairs at V0={p.shape[1]}, max |area - plain| / "
        f"cell area {err_a:.3e} (limit 1e-5), max |centroid - plain| / half "
        f"extent {err_c:.3e} (limit 1e-4, area > 1% of the cell)")
    # the plain version sums its 128-slot shoelace in f32, the kernel its
    # compacted ring in f64: they differ by the plain version's rounding
    check(err_a < 1e-5, f"clip areas disagree with the plain version "
                        f"({err_a:.3e})")
    check(err_c < 1e-4, f"clip centroids disagree ({err_c:.3e})")
    ms = time_ms(lambda: clip_areas_centroids(p, r), 20)
    plain_ms = time_ms(lambda: clip_areas_centroids_ref(p, r), 3)
    say(f"clip: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
        f"{len(pairA)} pairs")
    return {"pairs": len(pairA), "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms}


# -- phase 3: the main path ------------------------------------------------

def compare_exchange(xg, xo, specI):
    """Port exchange grid vs the shared f64 numpy builder: the same pairs
    except those within f32 noise of the min_area_frac cut."""
    areas = specI.cell_areas()
    col = xg.area_sums_I()
    rel = np.abs(col - areas) / areas
    say(f"exchange: {xg.ncells} overlaps, max |column sum - cell area| / "
        f"cell area {rel.max():.3e} (limit {COLSUM_TOL:g})")
    check(rel.max() < COLSUM_TOL, f"column sums off by {rel.max():.3e}")
    kg = xg.iA.astype(np.int64) * xg.nI + xg.iI
    ko = xo.iA.astype(np.int64) * xo.nI + xo.iI
    only_g = ~np.isin(kg, ko)
    only_o = ~np.isin(ko, kg)
    # f32 noise of the recentred clip: an A cell's vertices lie up to
    # ~100 km from the ice cell's centre, so f32 rounds them at ~6 mm, about
    # 1e-6 of a 5 km cell's area; a pair present on one side only must be
    # near-degenerate there
    noise = 1e-5
    odd = (np.sum(xg.area[only_g] > noise * areas[xg.iI[only_g]])
           + np.sum(xo.area[only_o] > noise * areas[xo.iI[only_o]]))
    og, oo = np.argsort(kg), np.argsort(ko)
    common_g = og[np.isin(kg[og], ko)]
    common_o = oo[np.isin(ko[oo], kg)]
    d = (np.abs(xg.area[common_g] - xo.area[common_o])
         / areas[xg.iI[common_g]])
    say(f"exchange vs numpy builder: {len(common_g)} common pairs, "
        f"{only_g.sum()} port-only and {only_o.sum()} numpy-only pairs "
        f"below {noise:g} of their cell, max |area diff| / cell area "
        f"{d.max():.3e} (limit {noise:g})")
    check(odd == 0, f"{odd} pairs differ above f32 noise")
    check(d.max() < noise, f"overlap areas differ by {d.max():.3e}")


def phase_main(specA, specI, device, counters):
    import torch
    from icebin_tpu_torch import CouplerConfig, GCMCoupler, GCMRegridder
    from icebin_tpu_torch.grid import make_exchange_grid_host

    for k in counters:
        k.launches = 0
    gr = GCMRegridder(specA, HCDEFS, device=device)
    _, build_ms = wall_ms(lambda: gr.add_sheet("greenland", specI, subdiv=2))
    # the production stepwise mode (bench.py's): ledger rows stay device
    # tensors until one batched fetch
    cfg = CouplerConfig(dt=DT, regen_every=REGEN, defer_ledger=True)
    cp, init_ms = wall_ms(lambda: GCMCoupler(gr, cfg, device=device))
    sc = cp.sheets["greenland"]
    held = np.random.default_rng(1).uniform(0.5, 2.0, (2, gr.nE))
    sc.set_held_state(held)
    m_held = sc.held_mass()
    step_ms, out = [], None
    for k in range(2 * REGEN):
        fE = torch.as_tensor(forcing(gr.nE, seed=k), device=device)
        out, ms = wall_ms(lambda: cp.couple({"greenland": fE})["greenland"])
        step_ms.append(ms)
    fused = lambda t, s: torch.as_tensor(forcing(gr.nE, seed=int(t // DT)),
                                         device=device)
    _, fused_ms = wall_ms(lambda: cp.run_transient(fused, REGEN, fused=True))
    launches = {k.__name__: k.launches for k in counters}

    say(f"phase ms: exchange build {build_ms:.1f}, coupler init (matrices + "
        f"packs) {init_ms:.1f}, stepwise steps "
        f"{', '.join(f'{m:.1f}' for m in step_ms)} (regeneration in steps "
        f"{REGEN} and {2 * REGEN}), fused window of {REGEN} {fused_ms:.1f}")
    plain = [m for i, m in enumerate(step_ms) if (i + 1) % REGEN]
    say(f"coupler: {1e3 / np.median(plain):.2f} steps/s stepwise with the "
        f"deferred ledger (median of steps without regeneration), "
        f"{1e3 * REGEN / fused_ms:.2f} steps/s in the fused window (its "
        f"closing regeneration included)")
    say(f"launch counts in the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")

    check(len(cp.ledger._pending) == 2 * REGEN,
          "the stepwise rows did not go through the deferred ledger")
    rows = cp.ledger.to_rows()
    check(len(rows) == 3 * REGEN, f"{len(rows)} ledger rows")
    worst = 0.0
    for r in rows:
        for book in ("mass", "energy"):
            a = r[f"greenland.{book}_in_E"]
            b = r[f"greenland.{book}_delivered_I"]
            check(np.isfinite(a) and abs(a) > 0, f"{book}_in_E is {a}")
            worst = max(worst, abs(a - b) / abs(a))
    say(f"ledger: {len(rows)} rows, max |in_E - delivered_I| / |in_E| "
        f"{worst:.3e} (mass and energy; limit {TRANSPORT_TOL:g})")
    check(worst < TRANSPORT_TOL, f"transport identity {worst:.3e}")
    regen_rows = [r for r in rows if "greenland.held_mass" in r]
    check(len(regen_rows) == 3, f"{len(regen_rows)} E1vE0 remaps")
    m_prev = m_held
    for r in regen_rows:
        budget = (m_prev - r["greenland.held_mass_dropped"]
                  + r["greenland.held_mass_gained"])
        check(abs(r["greenland.held_mass"] - budget) < 1e-10 * abs(m_prev),
              "held state books do not close across E1vE0")
        m_prev = r["greenland.held_mass"]

    nI, nA = specI.ncells, specA.ncells
    check(tuple(out["fI"].shape) == (8, nI), f"fI {tuple(out['fI'].shape)}")
    check(tuple(out["fE_out"].shape) == (10, gr.nE), "fE_out shape")
    check(tuple(out["fA_out"].shape) == (10, nA), "fA_out shape")
    evi = sc.mat("EvI")
    live = evi.wM > 0
    check(bool(torch.isfinite(out["fE_out"][3:9, live]).all()),
          "non-finite flux harvest on live E cells")
    check(bool(torch.isfinite(sc.state.H).all()), "non-finite ice state")

    xo, np_ms = wall_ms(lambda: make_exchange_grid_host(specA, specI,
                                                        subdiv=2))
    say(f"shared numpy exchange build (host f64, for comparison) "
        f"{np_ms:.1f} ms")
    compare_exchange(gr.sheets["greenland"].exchange, xo, specI)
    return cp, launches, float(np.median(plain))


# -- phase 4: the regrid kernels on the real matrices ----------------------

def phase_spmm(cp, device):
    import scipy.sparse as sp
    import torch
    from icebin_tpu_torch.ops.apply import (spmm_dest_ice, spmm_dest_small,
                                            spmm_ref)
    sc = cp.sheets["greenland"]
    rng = np.random.default_rng(2)
    res = {"spmm_dest_small": [], "spmm_dest_ice": []}
    for name in ("EvI", "AvI"):
        M = sc.rm.matrix(name, cp.cfg.params)
        S = sp.csr_matrix((M.vals, (M.rows, M.cols)), shape=M.shape)
        pack = sc.mat(name).pack
        for kern, csr, A, w, tag in (
                (spmm_dest_small, pack.small, S, M.wM, name),
                (spmm_dest_ice, pack.ice, S.T.tocsr(), M.Mw,
                 "Iv" + name[0])):
            x = (260.0 + 30.0 * rng.uniform(size=(csr.n_src, 16))
                 ).astype(np.float32)
            xt = torch.as_tensor(x, device=device)
            got = kern(csr, xt)
            again = kern(csr, xt)
            plain = spmm_ref(csr, xt)
            torch.cuda.synchronize()
            want = np.asarray(A @ x.astype(np.float64))
            live = w > 0
            want[live] /= w[live, None]
            g = got.cpu().numpy().astype(np.float64)
            raw = (np.abs(g[live] - want[live]).max()
                   / np.abs(want[live]).max())
            d_plain = (got - plain).abs().max().item()
            ident = bool(torch.equal(got, again))
            ms = time_ms(lambda: kern(csr, xt), 50)
            plain_ms = time_ms(lambda: spmm_ref(csr, xt), 10)
            per_row = (csr.rowptr[1:] - csr.rowptr[:-1])
            say(f"{kern.__name__} {tag}: ({csr.n_src} x 16) -> ({csr.n_dst} "
                f"x 16), {csr.vals.numel()} nnz in "
                f"{int((per_row > 0).sum())} live rows of at most "
                f"{int(per_row.max())}: raw error vs f64 oracle {raw:.3e} "
                f"(limit {RAW_TOL:g}), max |kernel - plain| {d_plain:.3e} "
                f"(limit 1e-4), repeat bit-identical {ident}; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            check(raw < RAW_TOL, f"{tag} raw error {raw:.3e}")
            check(ident, f"{tag} repeat run is not bit-identical")
            check(d_plain < 1e-4, f"{tag} kernel vs plain {d_plain:.3e}")
            res[kern.__name__].append((tag, d_plain, ms, plain_ms))
    return res


# -- phase 5: where a coupler step's time goes -----------------------------

def phase_profile(cp, step_ms, device):
    """torch.profiler over the steps left before the next regeneration:
    device busy time per step is the sum of every kernel, copy and fill
    the profiler traced on the card (one stream, so they do not overlap);
    the idle share is taken against the unprofiled step time of phase 3."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sc = cp.sheets["greenland"]
    n = REGEN - 1 - sc.steps_since_regen
    check(n >= 1, "no steady step left before the next regeneration")
    fE = [torch.as_tensor(forcing(cp.gr.nE, seed=10 + k), device=device)
          for k in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for f in fE:
            cp.couple({"greenland": f})
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t) / n
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        say(f"profile: {n} steps, {prof_ms:.3f} ms per step under the "
            f"profiler; device time not measured (no device event traced)")
        return
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in dev) / n
    by_name = {}
    for e in dev:
        us, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    say(f"profile: {n} steady steps, {prof_ms:.3f} ms per step under the "
        f"profiler ({step_ms:.3f} ms without it, phase 3); device busy "
        f"{busy_ms:.3f} ms per step in {len(dev) / n:.0f} device operations, "
        f"so the device is idle {100 * (1 - busy_ms / step_ms):.1f}% of an "
        f"unprofiled step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, k) in top:
        say(f"profile:   {us / n:9.1f} us per step in {k / n:5.1f} calls: "
            f"{name[:70]}")


# -- phase 6: small-input parity, GPU kernels vs CPU plain versions --------

def phase_toy(device):
    import torch
    from icebin_tpu_torch import CouplerConfig, GCMCoupler, GCMRegridder
    from icebin_tpu_torch.grid import GridSpecLonLat, GridSpecXY, PlateCarree

    scale = 25e3
    specA = GridSpecLonLat(lonb=np.linspace(0.0, 40.0, 7),
                           latb=np.linspace(30.0, 80.0, 7))
    specI = GridSpecXY(xb=np.linspace(0.0, 40.0 * scale, 41),
                       yb=np.linspace(30.0 * scale, 80.0 * scale, 41),
                       projection=PlateCarree(scale=scale))
    runs = []
    for dev in (device, torch.device("cpu")):
        gr = GCMRegridder(specA, [0.0, 500.0, 1000.0, 2000.0, 3000.0],
                          device=dev)
        gr.add_sheet("toy", specI, subdiv=1)
        cp = GCMCoupler(gr, CouplerConfig(dt=DT, regen_every=2), device=dev)
        for k in range(3):
            cp.couple({"toy": torch.as_tensor(forcing(gr.nE, seed=k),
                                              device=dev)})
        runs.append(cp)
    g, c = runs
    dH = ((g.sheets["toy"].state.H.cpu() - c.sheets["toy"].state.H).abs()
          .max() / c.sheets["toy"].state.H.abs().max()).item()
    worst = 0.0
    for rg, rc in zip(g.ledger.to_rows(), c.ledger.to_rows()):
        for key in ("mass_in_E", "mass_delivered_I", "ice_mass",
                    "energy_in_E", "energy_delivered_I"):
            a, b = rg[f"toy.{key}"], rc[f"toy.{key}"]
            worst = max(worst, abs(a - b) / max(abs(b), 1e-300))
    say(f"toy coupler (40 x 40 ice, 6 x 6 atmosphere), GPU vs CPU plain "
        f"versions over 3 steps: max H diff / max H {dH:.3e} (limit 1e-5), "
        f"max ledger row diff {worst:.3e} (limit 1e-6)")
    check(dH < 1e-5, f"toy ice state differs ({dH:.3e})")
    check(worst < 1e-6, f"toy ledger differs ({worst:.3e})")


def main():
    global CARD
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        from icebin_tpu_torch.ops import _build
        from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_dest_small
        from icebin_tpu_torch.ops.clip import clip_areas_centroids
    except ImportError as e:
        fail(f"run from the root of a checkout ({e})")
    device = torch.device("cuda", 0)
    CARD = nvidia_smi()
    t = time.perf_counter()
    _build.library()
    say(f"build: {1e3 * (time.perf_counter() - t):.1f} ms, "
        f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            say(f"ptxas: {line.strip()}")

    specA, specI = greenland_specs()
    clip = phase_clip(specA, specI, device)
    counters = (clip_areas_centroids, spmm_dest_ice, spmm_dest_small)
    cp, launches, step_ms = phase_main(specA, specI, device, counters)
    spmm = phase_spmm(cp, device)
    phase_profile(cp, step_ms, device)
    phase_toy(device)
    check("jax" not in sys.modules, "JAX was imported")

    def row(name, source, replaces, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # timings at the main path's hot shapes: IvE (K1) and EvI (K2)
    ice = dict((t[0], t) for t in spmm["spmm_dest_ice"])["IvE"]
    small = dict((t[0], t) for t in spmm["spmm_dest_small"])["EvI"]
    kernels = [
        row("spmm_dest_ice", "icebin_tpu_torch/csrc/spmm.cu",
            "icebin_tpu/ops/pallas_bdt.py:903",
            max(t[1] for t in spmm["spmm_dest_ice"]), ice[2], ice[3]),
        row("spmm_dest_small", "icebin_tpu_torch/csrc/spmm.cu",
            "icebin_tpu/ops/pallas_bdt.py:807",
            max(t[1] for t in spmm["spmm_dest_small"]), small[2], small[3]),
        row("clip_areas_centroids", "icebin_tpu_torch/csrc/clip.cu",
            "icebin_tpu/ops/pallas_clip.py:142", clip["max_abs_err"],
            clip["ms"], clip["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
