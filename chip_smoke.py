#!/usr/bin/env python3
"""Smoke run of icebin_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs CUDA

The main path is the coupled SeaRISE Greenland 5 km (304 x 544 polar
stereographic cells) x ModelE 2x2.5 (144 x 90, 5 elevation classes) system
that bench.py drives: the exchange grid is built through the clip kernel,
then a GCMCoupler runs 6 stepwise coupling steps (each a window of one
step) with a matrix regeneration (and an E1vE0 remap of
GCM-held state) every 3, then one fused window.  Phases 10 and 11 add
Antarctica 5 km (config #5) and drive both sheets through the ModelE C
ABI.  On the card every single-device SIA sheet runs the compiled step (a
CUDA graph of the step, replayed); phase 18 holds it to the eager step.
Phases, each of which exits non-zero on failure:

1. build   every kernel of csrc/ with nvcc for sm_90a; each clip
           instance's registers, stack frame and spills from the build
           log, failing if a stage-2 clip instance has a stack frame or
           spills;
2. clip    the clip kernel (stage 2, the register pipeline) against its
           plain version on all candidate pairs of the Greenland build,
           bit for bit clip_stream_model on 4,096 seeded pairs, within
           1e-5 of the f64 oracle on them, and within 1e-6 of the cell
           area of the stage-1 kernel on every pair (the pairs whose areas
           differ in any bit counted), timed beside stage 1;
3. main    the main path, with every launch counter set to 0 just before
           it and read just after: exchange build, coupler construction,
           6 stepwise steps, one fused window (steps/s from the steps that
           neither regenerate nor capture the compiled step).  The exchange grid must
           match the f64 numpy builder and its column sums the cell
           areas; every ledger row's transport identity must hold < 1e-10;
4. spmm    the two regrid kernels on the real EvI/IvE/AvI/IvA at nv = 16
           and 64 against their plain versions (K2 bit for bit the plain
           version of its own order, K1 bit for bit the stage-1 K1 in both
           field layouts) and the f64 scipy oracle (raw error < 5e-7), and
           a repeat run bit-identical, timed beside cuSPARSE
           (torch.sparse.mm) and the stage-1 kernels on the same matrices,
           K1 in the (nv, n) layout apply_ice runs, on (n, nv) and through
           the stage-1 apply_ice's transposes;
5. profile torch.profiler over the steady steps before the next
           regeneration (after one unprofiled step that captures):
           device busy time per step, the device's idle share and the
           largest device operations;
6. toy     a small coupler on the GPU against the same coupler on the CPU
           (the plain versions) over 3 steps;
7. polyclip the generic-polygon path: Greenland as ~165,500 hexagons of
           25 km2 (the 5 km cells' area) in the SeaRISE plane x ModelE
           2x2.5 at subdiv 2, with every launch counter set to 0 just
           before make_exchange_grid builds it through the convex-clip
           kernel and read just after.  Column sums (repaired and raw),
           the convex-clip kernel against its plain version on every pair
           and a seeded sample against the f64 oracle, against
           clip_stream_model and the stage-1 kernel as phase 2 holds the
           clip kernel, concave cells, the
           exchange grid's AvI/IvA through the regrid kernels, and the
           overlap CLI against the in-process build;
8. run     the standalone run CLI (icebin_tpu_torch.cli.run.main) at full
           width on grid and exchange-grid files and a RunConfig with
           checkpoints every 3 steps and per-step dumps: stepwise, --fused
           and --ice dismal, each with the launch counters set to 0 just
           before and read just after (transport identity < 1e-10, the
           dumps and checkpoints on disk); then a checkpoint resumed
           through the API, bit for bit the run that was not interrupted;
9. roof    the stream-reduce kernel at 34 MB (inside the 50 MB L2) and
           268 MB (from HBM) against its plain version and torch.sum, with
           its launch counter set to 0 just before the timed runs;
10. multisheet  BASELINE config #5 as bench.py:413-496 builds it:
           Antarctica 5 km (1120 x 1120 south polar stereographic cells)
           beside Greenland under one ModelE regridder.  Phase 2's checks
           on all of Antarctica's pairs; its
           exchange build with the launch counters set to 0 just before
           and read just after, against the f64 host build; one
           GCMCoupler on both sheets (6 stepwise steps,
           then a fused window, counters likewise); steps/s as bench.py
           measures them (each sheet alone, then both); Antarctica's
           EvI/IvE/AvI/IvA through phase 4's checks at nv = 16 and 64;
11. modele the port's gcmce_* C ABI through ctypes on config #5's files:
           two steps of forcing in ModelE's layout from two 'ranks', the
           TOPO buffers, ledger rows and ice state bit for bit the
           directly driven coupler's, and the regrid kernels' launches
           counted around each gcmce_couple_native call alone;
12. floors the stream-only floors beside the regrid kernels on both
           sheets' EvI/IvE, and the tile product at Greenland and
           Antarctica depth beside its plain version and torch.bmm, their
           counters set to 0 just before the timed runs;
13. k2probe the dest-small probe kernels (csrc/k2probe.cu: slots, group,
           batch and ablate variants of K2) on both sheets' EvI at nv = 16
           and 64 through icebin_tpu_torch.tools.probe_k2, beside K2, its
           stream floor and cuSPARSE, each counter set to 0 just before its
           timed runs; every variant bit for bit its plain version and its
           rerun, slots(1) and group(1) bit for bit the stage-1 K2's order,
           K2 on its live rows alone bit for bit K2, raw error < 5e-7; then
           how the stage-1 K2's time (slots(1)) divides, with the stage-2
           K2 beside it;
14. k1probe the dest-ice probe kernels (csrc/k1probe.cu: slots, batch,
           ablate, stage and store variants of K1) on both sheets' IvE at
           nv = 16 and 64 through icebin_tpu_torch.tools.probe_k1, beside
           K1, K1 through the stage-1 apply_ice's transposes, its
           stream floor and cuSPARSE (for K1's function and for each lower
           stage's), each counter set to 0 just before its timed runs;
           every variant bit for bit its plain version and its rerun (also
           on cancelling data), the variants in K1's order bit for bit K1,
           raw error < 5e-7; then how K1's time divides;
15. smemfold the fold and capacity probes through
           icebin_tpu_torch.tools.probe_fold_ops and tools.probe_vmem: every
           fold (reshape down and up, the V1 fold and its inverse) by both
           routes (shared memory, warp shuffles) in f32 and f64 at B = 1,
           64, 16,384 and 64,800 tiles (csrc/foldprobe.cu), bit for bit its
           plain version, the library copy and its rerun, each counter set
           to 0 just before its timed runs; the TPU probe's semantic checks;
           then the largest (n, 128) f32 in + out pair held in one block's
           shared memory and in a cluster of 2, 4, 8 and 16 blocks
           (csrc/smemprobe.cu), bisected (a size fits only if the launch is
           accepted and the result is bit for bit x * 2.0), with the
           cluster occupancy the card reports;
16. mesh  the main path decomposed over ranks (icebin_tpu_torch.parallel,
           coupler/sharded.py) at config #3's full width, at world size 1
           over NCCL and world size 2 over gloo with both ranks on cuda:0
           (gloo's send/recv staged through pinned host memory), each
           rank a process of parallel.distributed.launch with every launch
           counter set to 0 just before its path and read just after: the
           sharded exchange build (K3 on each rank's pairs, A-polygon
           blocks round a send/recv ring) bit for bit phase 3's build; 6
           mesh coupler steps with a regeneration every 3, every rank's
           ledger the same, the transport identity < 1e-10 every step, H
           and fE_out within the JAX package's mesh tolerances
           (tests/test_mesh_coupler.py:111-116) of the single-device
           coupler on the same forcing, and at world size 1 H, fE_out and
           the ledger bit for bit its; step ms over 18 steps with the
           mesh's timers off beside the single-device coupler's, then 6
           steps with the timers on for halo, collective and staging ms,
           substeps, gathers and exchanges per step; K1/K2/K3 launches per
           rank and build ms; and parallel/dryrun.py at world size 1
           (NCCL);
17. topo  the ModelE input toolchain a modeller runs before a coupled
           Greenland run, at config #3's widths, with every launch counter
           set to 0 just before the phase and read just after: a SeaRISE
           file of the 304 x 544 lattice written and read back; a synthetic
           1/4-degree TOPO base (1440 x 720) written as a GISS file,
           converted by giss2nc (values bit for bit) and taken by the
           make_topoo CLI onto the ModelE ocean grid O (288 x 180, nested
           in ModelE 2x2.5: each O cell in one A cell); the O-level
           exchange grid clipped on the card (K3) against the f64 numpy
           builder; GCMRegridderModelE's mismatched AvI/EvI/IvA/IvE
           (the conservation identity < 1e-12), EvI and AvI through K2 and
           IvE and IvA through K1 at nv = 16 against their plain versions
           and WeightedMatrix.apply in f64 (raw error < 5e-7); the
           regridder file through the global_ec CLI (every zarray blob bit
           for bit its matrix) and make_topoo --merge (fractions sum to 1,
           FGICE changed only under the sheet); the coupled Greenland
           example's twin at 5 km for 3 steps, with its plot where
           matplotlib is installed (transport < 1e-10 every step, K1 and
           K2 launched); a Roofline of the K2 apply.  Each stage's ms,
           the launches and the phase's seconds;
18. compiled the compiled step (coupler/step_graph.py: _couple_core with the
           SIA at a fixed substep budget as one CUDA graph a budget, kept
           and rebound across regenerations) against the eager
           _couple_core: at config
           #3's full width 10 stepwise steps and a fused
           window of 5, regenerating every 5, every step's fI, fE_out,
           fA_out, H, enth and all 15 ledger entries bit for bit; one
           steady step of each under torch.profiler (device busy ms,
           device operations, idle share) with K1's and K2's launches
           counted around it (a replay's counts the eager step's); a fused
           window of 2 enqueued under torch.cuda.set_sync_debug_mode
           ("error"), its one fetch after it, bit for bit; 1-year steps,
           whose 10 substeps make the budget rerun on the card, bit for
           bit; config #5's two sheets, 4 steps and a window of 2, bit for
           bit, one graph and budget a sheet.  Step ms compiled and eager
           (medians of the steps that neither capture nor regenerate),
           the windows' ms, capture ms, replays and reruns;
19. regen  regeneration on the card (regrid/device.py) against the host
           factory, at config #5 (Antarctica's 2.9 M exchange cells beside
           Greenland): for each sheet a coupler of each path regenerates
           REGEN_TIMES times from alternating masks (a seeded fifth of the
           ice removed and the surface raised, then the dome again) with
           two held fields; the packs of EvI/AvI (both CSRs, weights), the
           E1vE0 returned, the held state, the ledger's held-mass rows,
           fhc and elevE bit for bit; each regeneration's ms on both paths
           and the path counters; then the ordered segment-sum kernel
           (csrc/segsum.cu) on Antarctica's EvI row and column sums, bit
           for bit its plain version, timed beside it and
           torch.segment_reduce.  The kernel's launch count is the
           regenerations' own (set to 0 before them), not the timing's;
20. rebind the compiled step's graph kept across a regeneration, at config
           #5: for each sheet, REBIND_TIMES times, a new generation's packs
           (a seeded fifth of the ice removed, the surface raised) loaded
           into the buffers the graph reads and its dest-small launches
           rebound (ms of the copies, synchronised, and of the node
           updates, the first of which walks the graph for them; the
           launches updated must be the graph's), one step replayed, then
           the same step through a graph captured afresh: bit for bit the
           rebound graph's; a capture's ms beside the rebind's;
21. books  the books' kernel (csrc/books.cu: books_reduce_kernel<double>)
           alone on each sheet's step stages at their real widths and
           weights (the forcing repair's sums, the step's sums, the
           repair's write): within 1e-14 of sum |f w| of the plain version
           (the torch chain it replaced; the write bit for bit), two
           launches the same bits, its ms beside the plain chain's and its
           byte bound.  Phase 18 counts the books' launches a replay
           (at most 8 a step and sheet) beside the eager step's.

The timing helpers, the bound and the config #3 and #5 lattices come from
icebin_tpu_torch.tools.common, which the port's probes share.

The last three lines are the kernels' JSON summary (each kernel's launches
on its path, error against its plain version, ms beside the plain
version's, the one PyTorch call that computes the same function where there
is one, and the least time the card could take: bytes over 3.35 TB/s or
f32 operations over 67 TFLOP/s, the H100 SXM data sheet at 700 W), the
card's name and power limit (nvidia-smi), and {"ok": true, "device":
{...}}.  Every timing line carries the card's name and power limit.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from icebin_tpu_torch.tools.common import (HCDEFS, HEX_R, PEAK_BYTES_S,
                                           antarctica_spec, bound, card_name,
                                           clip_bound, greenland_specs,
                                           hex_mesh, library_spmm, same,
                                           spmm_bound, time_ms)
from icebin_tpu_torch.tools.probe_k1 import APPLY
from icebin_tpu_torch.tools.probe_k2 import LIVE

DT = 86400.0 * 30
REGEN = 3
TRANSPORT_TOL = 1e-10
RAW_TOL = 5e-7            # tests/test_accuracy_contract.py's 6-pass bound
COLSUM_TOL = 1e-12
ROOF_SHAPES = ((2048, 32 * 128), (524288, 128))   # 34 MB and 268 MB f32
SHEETS = ("greenland", "antarctica")
MS_N1, MS_N2 = 16, 48     # steps of the two-point steps/s, as bench.py
PRODS_ROWS = (2048, 15360)   # tools/probe_prods_scale.py: 44 and 330 MB
PRODS_TOL = 130 * 2.0 ** -24  # f32 FMA chain of 128 terms, of sum |T * F|
MODEL_PAIRS = 4096        # seeded pairs a build's stage-2 clip is held to
                          # clip_stream_model on, bit for bit
BOOKS_LAUNCHES = 8        # the books' launches a step and sheet, at most
BOOKS_TOL = 1e-14         # kernel sums against the plain version, of
                          # sum |f w|: another order of f64 adds
CARD = ""


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def say(msg):
    print(f"[{CARD}] {msg}", flush=True)


def wall_ms(fn):
    """Host time of ``fn`` up to a device synchronisation."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


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

def check_stage2(tag, a, c, p, q, compact, cell, idx):
    """The stage-2 clip's areas ``a`` and centroids ``c`` on inputs (p, q):
    bit for bit ``clip_stream_model`` on the seeded pairs ``idx``, and
    within 1e-6 of the cell areas ``cell`` of the stage-1 kernel
    ``compact`` on every pair, with the pairs whose areas differ in any bit
    counted.  Returns the stage-1 kernel's ms."""
    import torch
    from icebin_tpu_torch.ops.clip import clip_stream_model
    from icebin_tpu_torch.tools.common import same
    it = torch.as_tensor(idx, device=p.device)
    a_m, c_m = clip_stream_model(p[it].cpu().numpy(), q[it].cpu().numpy())
    model = (same(a[it].cpu(), torch.as_tensor(a_m))
             and same(c[it].cpu(), torch.as_tensor(c_m)))
    a1, _ = compact(p, q)
    differ = int((a.view(torch.int32) != a1.view(torch.int32)).sum())
    rel1 = ((a.double() - a1.double()).abs() / cell).max().item()
    stage1_ms = time_ms(lambda: compact(p, q), 20)
    say(f"{tag}: stage 2 bit for bit clip_stream_model on {len(idx)} seeded "
        f"pairs {model}; against stage 1 {differ} of {p.shape[0]} pairs "
        f"differ in some bit of the area, max |area - stage 1| / cell area "
        f"{rel1:.3e} (limit 1e-6); stage 1 {stage1_ms:.4f} ms")
    check(model, f"{tag}: stage 2 is not bit for bit clip_stream_model")
    check(rel1 < 1e-6, f"{tag}: stage 2 off stage 1 by {rel1:.3e}")
    return stage1_ms


def sample(n, seed):
    """MODEL_PAIRS seeded pair indices of n, sorted."""
    return np.sort(np.random.default_rng(seed).choice(
        n, min(MODEL_PAIRS, n), replace=False))


def phase_clip(specA, specI, device, tag="clip"):
    import torch
    from icebin_tpu_torch.grid import clip_pairs
    from icebin_tpu_torch.grid.exchange import clip_rect_host
    from icebin_tpu_torch.ops.clip import (clip_areas_centroids,
                                           clip_areas_centroids_compact,
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
    say(f"{tag}: {len(pairA)} pairs at V0={p.shape[1]}, max |area - plain| / "
        f"cell area {err_a:.3e} (limit 1e-5), max |centroid - plain| / half "
        f"extent {err_c:.3e} (limit 1e-4, area > 1% of the cell)")
    # the plain version sums its 128-slot shoelace in f32, the kernel its
    # compacted ring in f64: they differ by the plain version's rounding
    check(err_a < 1e-5, f"clip areas disagree with the plain version "
                        f"({err_a:.3e})")
    check(err_c < 1e-4, f"clip centroids disagree ({err_c:.3e})")
    idx = sample(len(pairA), 5)
    a_o, _ = clip_rect_host(subj[idx], rect[idx])
    err_o = np.max(np.abs(np.abs(a.cpu().numpy()[idx].astype(np.float64))
                          - a_o) / specI.cell_areas()[pairI[idx]])
    say(f"{tag}: max |area - f64 oracle| / cell area {err_o:.3e} on "
        f"{len(idx)} seeded pairs (limit 1e-5)")
    check(err_o < 1e-5, f"clip areas vs f64 oracle {err_o:.3e}")
    stage1_ms = check_stage2(tag, a, c, p, r, clip_areas_centroids_compact,
                             cell, idx)
    ms = time_ms(lambda: clip_areas_centroids(p, r), 20)
    plain_ms = time_ms(lambda: clip_areas_centroids_ref(p, r), 3)
    bound_ms, bound_by = clip_bound(p, r)
    say(f"{tag}: kernel {ms:.4f} ms (stage 1 {stage1_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) per "
        f"{len(pairA)} pairs; no single PyTorch call clips polygons")
    return {"pairs": len(pairA), "max_abs_err": abs_err, "ms": ms,
            "stage1_ms": stage1_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


# -- phase 3: the main path ------------------------------------------------

def compare_exchange(xg, xo, specI, tag="exchange"):
    """Port exchange grid vs the f64 numpy builder: the same pairs
    except those within f32 noise of the min_area_frac cut."""
    areas = specI.cell_areas()
    col = xg.area_sums_I()
    rel = np.abs(col - areas) / areas
    say(f"{tag}: {xg.ncells} overlaps, max |column sum - cell area| / "
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
    say(f"{tag} vs numpy builder: {len(common_g)} common pairs, "
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
    # per-step windows (one window of one step each), then a fused window
    cfg = CouplerConfig(dt=DT, regen_every=REGEN)
    cp, init_ms = wall_ms(lambda: GCMCoupler(gr, cfg, device=device))
    sc = cp.sheets["greenland"]
    held = np.random.default_rng(1).uniform(0.5, 2.0, (2, gr.nE))
    sc.set_held_state(held)
    m_held = sc.held_mass()
    step_ms, out, steady = [], None, []
    for k in range(2 * REGEN):
        fE = torch.as_tensor(forcing(gr.nE, seed=k), device=device)
        n_cap = len(sc.capture_ms)
        out, ms = wall_ms(lambda: cp.couple({"greenland": fE})["greenland"])
        step_ms.append(ms)
        # a step that regenerates or captures the compiled step's graph
        steady.append((k + 1) % REGEN and len(sc.capture_ms) == n_cap)
    n_stepwise = len(cp.ledger.to_rows())
    fused = lambda t, s: torch.as_tensor(forcing(gr.nE, seed=int(t // DT)),
                                         device=device)
    _, fused_ms = wall_ms(lambda: cp.run_transient(fused, REGEN, fused=True))
    launches = {k.__name__: k.launches for k in counters}

    say(f"phase ms: exchange build {build_ms:.1f}, coupler init (matrices + "
        f"packs) {init_ms:.1f}, stepwise steps "
        f"{', '.join(f'{m:.1f}' for m in step_ms)} (regeneration in steps "
        f"{REGEN} and {2 * REGEN}; capture ms {sc.capture_ms}), fused "
        f"window of {REGEN} {fused_ms:.1f}")
    plain = [m for m, ok in zip(step_ms, steady) if ok]
    say(f"coupler: {1e3 / np.median(plain):.2f} steps/s stepwise (median "
        f"of the steps that neither regenerate nor capture the compiled "
        f"step), "
        f"{1e3 * REGEN / fused_ms:.2f} steps/s in the fused window (its "
        f"closing regeneration included)")
    say(f"launch counts in the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")

    check(n_stepwise == 2 * REGEN,
          f"{n_stepwise} ledger rows from {2 * REGEN} stepwise steps")
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
    say(f"f64 numpy exchange build (host, for comparison) {np_ms:.1f} ms")
    compare_exchange(gr.sheets["greenland"].exchange, xo, specI)
    return cp, launches, float(np.median(plain))


# -- phase 4: the regrid kernels on the real matrices ----------------------

def check_spmm(kern, csr, A, w, tag, rng, nv=16):
    """``kern`` on ``csr`` (the pack of sparse matrix ``A``, destination
    weights ``w``) at ``nv`` fields against its plain versions and the f64
    scipy product, timed beside cuSPARSE (``torch.sparse.mm`` on the CSR
    with ``winv`` folded into its values, on the pre-cleaned field) and
    the stage-1 kernel of the same function.  K2 is held bit for bit to
    spmm_dest_small_ref (its own order); K1, in both field layouts, bit for
    bit to the stage-1 K1 (k1probe's slots(1), a thread an output, and
    ablate row, a thread a row), whose order it keeps.  K1's ``ms`` is the
    (nv, n) layout apply_ice runs; it is also timed on (n, nv) and through
    the transposes the stage-1 apply_ice made.  Returns {max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by, stage1_ms}."""
    import torch
    from icebin_tpu_torch.ops import k1probe, k2probe
    from icebin_tpu_torch.ops.apply import (spmm_dest_ice,
                                            spmm_dest_small_ref, spmm_ref)
    from icebin_tpu_torch.utils.profiling import csr_apply_bytes
    device = csr.device
    x = (260.0 + 30.0 * rng.uniform(size=(csr.n_src, nv))).astype(np.float32)
    xt = torch.as_tensor(x, device=device)
    xf = xt.t().contiguous()
    ice = kern is spmm_dest_ice
    got = kern(csr, xt)
    again = kern(csr, xt)
    plain = spmm_ref(csr, xt)
    if ice:
        fields = kern(csr, xf, fields=True)
        stage1 = {"slots(1)": lambda: k1probe.spmm_ice_slots(csr, xt, 1),
                  "ablate row": lambda: k1probe.spmm_ice_ablate(csr, xt,
                                                                 "row")}
        exact = {name: fn() for name, fn in stage1.items()}
        exact_ok = all(same(got, e) and same(fields.t(), e)
                       for e in exact.values())
        what = ("bit for bit the stage-1 K1 (slots(1), ablate row) in both "
                "layouts")
    else:
        stage1 = {"slots(1)": lambda: k2probe.spmm_small_slots(csr, xt, 1)}
        exact_ok = same(got, spmm_dest_small_ref(csr, xt))
        what = "bit for bit spmm_dest_small_ref"
    torch.cuda.synchronize()
    want = np.asarray(A @ x.astype(np.float64))
    live = w > 0
    want[live] /= w[live, None]
    g = got.cpu().numpy().astype(np.float64)
    raw = np.abs(g[live] - want[live]).max() / np.abs(want[live]).max()
    d_plain = (got - plain).abs().max().item()
    ident = bool(torch.equal(got, again))
    rows_ms = time_ms(lambda: kern(csr, xt), 50)
    stage1_ms = {name: time_ms(fn, 50) for name, fn in stage1.items()}
    plain_ms = time_ms(lambda: spmm_ref(csr, xt), 10)
    per_row = (csr.rowptr[1:] - csr.rowptr[:-1])
    spmm = library_spmm(csr, xt)
    d_lib = (spmm() - got).abs().max().item()
    lib_ms = time_ms(spmm, 50)
    bound_ms, bound_by = spmm_bound(csr, nv)
    if ice:
        ms = time_ms(lambda: kern(csr, xf, fields=True), 50)
        via = time_ms(lambda: kern(csr, xf.t().contiguous()).t(), 50)
        times = (f"K1 (nv, n) as apply_ice runs it {ms:.4f} ms, (n, nv) "
                 f"{rows_ms:.4f} ms, through the stage-1 apply_ice's "
                 f"transposes {via:.4f} ms ({1e3 * (via - ms):+.1f} us)")
    else:
        ms = rows_ms
        # the same kernel writing its f64 sums unrounded (a mesh rank's
        # partials): its own time, plain version and bound (f64 outputs)
        f64 = {"ms": time_ms(lambda: kern(csr, xt, dtype=torch.float64), 50),
               "plain_ms": time_ms(lambda: spmm_ref(csr, xt,
                                                    dtype=torch.float64), 10),
               "bound_ms": bound(csr_apply_bytes(csr, nv)
                                 + 4 * nv * csr.n_dst,
                                 2 * csr.vals.numel() * nv)[0]}
        f64_ok = same(kern(csr, xt, dtype=torch.float64),
                      spmm_dest_small_ref(csr, xt, dtype=torch.float64))
        check(f64_ok, f"{tag} spmm_dest_small_f64 is not bit for bit "
                      f"spmm_dest_small_ref(dtype=float64)")
        times = (f"stage-2 K2 {ms:.4f} ms; with f64 outputs "
                 f"(spmm_dest_small_f64) {f64['ms']:.4f} ms, plain "
                 f"{f64['plain_ms']:.4f} ms, bound {f64['bound_ms']:.4f} ms "
                 f"(bytes), bit for bit its plain version of its order "
                 f"{f64_ok}")
    stage = ", ".join(f"{n} {t:.4f} ms" for n, t in stage1_ms.items())
    say(f"{kern.__name__} {tag}: ({csr.n_src} x {nv}) -> ({csr.n_dst} x "
        f"{nv}), "
        f"{csr.vals.numel()} nnz in {int((per_row > 0).sum())} live rows of "
        f"at most {int(per_row.max())}: raw error vs f64 oracle {raw:.3e} "
        f"(limit {RAW_TOL:g}), max |kernel - plain| {d_plain:.3e} (limit "
        f"1e-4), {what} {exact_ok}, repeat bit-identical {ident}; {times}; "
        f"stage 1: {stage}; cuSPARSE {lib_ms:.4f} ms (max |kernel - "
        f"cuSPARSE| {d_lib:.3e}), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    check(raw < RAW_TOL, f"{tag} raw error {raw:.3e}")
    check(ident, f"{tag} repeat run is not bit-identical")
    check(d_plain < 1e-4, f"{tag} kernel vs plain {d_plain:.3e}")
    check(exact_ok, f"{tag} {kern.__name__} is not {what}")
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "stage1_ms": stage1_ms["slots(1)"],
            **({} if ice else {f"f64_{k}": v for k, v in f64.items()})}


def check_pack(M, pack, names, rng, nv=16):
    """Both directions of ``pack`` (the pack of WeightedMatrix ``M``, rows
    the small side) through check_spmm at ``nv`` fields; ``names`` tags
    (small <- ice, ice <- small).  Returns {kernel name: [(tag,
    check_spmm's dict)]}."""
    import scipy.sparse as sp
    from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_dest_small
    S = sp.csr_matrix((M.vals, (M.rows, M.cols)), shape=M.shape)
    return {kern.__name__: [(tag, check_spmm(kern, csr, A, w, tag, rng, nv))]
            for kern, csr, A, w, tag in (
                (spmm_dest_small, pack.small, S, M.wM, names[0]),
                (spmm_dest_ice, pack.ice, S.T.tocsr(), M.Mw, names[1]))}


def phase_spmm(cp):
    """Greenland's EvI/IvE and AvI/IvA through check_pack at nv = 16 (the
    main path's pack; tags "EvI", "IvE", ...) and 64."""
    from icebin_tpu_torch.ops.csr import csr_pack
    sc = cp.sheets["greenland"]
    rng = np.random.default_rng(2)
    res = {"spmm_dest_small": [], "spmm_dest_ice": []}
    for name in ("EvI", "AvI"):
        M = sc.rm.matrix(name, cp.cfg.params)
        for nv in (16, 64):
            pack = (sc.mat(name).pack if nv == cp.cfg.nv
                    else csr_pack(M, nv=nv, device=sc.device))
            sfx = "" if nv == cp.cfg.nv else f" nv={nv}"
            for kern, rows in check_pack(M, pack, (name + sfx,
                                                   "Iv" + name[0] + sfx),
                                         rng, nv).items():
                res[kern] += rows
    return res


# -- phase 5: where a coupler step's time goes -----------------------------

def phase_profile(cp, step_ms, device, n=None, tag="profile"):
    """torch.profiler over ``n`` steady steps of every sheet of ``cp`` (by
    default the steps left before the next regeneration after one that
    runs unprofiled, since it captures the compiled step): device busy time
    per step is the sum of every kernel, copy and fill the profiler traced
    on the card (one stream, so they do not overlap); the idle share is
    taken against the unprofiled step time ``step_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if n is None:
        # the first step after a regeneration runs before the profiler
        # starts (a coupler's first step captures the compiled step)
        n = min(REGEN - 2 - sc.steps_since_regen
                for sc in cp.sheets.values())
        cp.couple({name: torch.as_tensor(forcing(cp.gr.nE, seed=9),
                                         device=device)
                   for name in cp.sheets})
    check(n >= 1, "no steady step left before the next regeneration")
    fE = [torch.as_tensor(forcing(cp.gr.nE, seed=10 + k), device=device)
          for k in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for f in fE:
            cp.couple({name: f for name in cp.sheets})
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t) / n
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        say(f"{tag}: {n} steps, {prof_ms:.3f} ms per step under the "
            f"profiler; device time not measured (no device event traced)")
        return
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in dev) / n
    by_name = {}
    for e in dev:
        us, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    say(f"{tag}: {n} steady steps of {sorted(cp.sheets)}, {prof_ms:.3f} ms "
        f"per step under the profiler ({step_ms:.3f} ms without it); device "
        f"busy {busy_ms:.3f} ms per step in {len(dev) / n:.0f} device "
        f"operations, so the device is idle "
        f"{100 * (1 - busy_ms / step_ms):.1f}% of an unprofiled step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, k) in top:
        say(f"{tag}:   {us / n:9.1f} us per step in {k / n:5.1f} calls: "
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


# -- phase 7: the generic-polygon path -------------------------------------

def tri_grid(x0, x1, y0, y1, n):
    """2 n^2 triangles tiling [x0, x1] x [y0, y1] (lon/lat degrees)."""
    xs, ys = np.linspace(x0, x1, n + 1), np.linspace(y0, y1, n + 1)
    tris = []
    for j in range(n):
        for i in range(n):
            a, b, c, d = xs[i], xs[i + 1], ys[j], ys[j + 1]
            tris += [[[a, c], [b, c], [b, d]], [[a, c], [b, d], [a, d]]]
    return np.asarray(tris)


def check_concave(device):
    """Concave clip cells (tests/test_grid_generality.py:317-321, :399-400)
    through the convex-clip kernel: an L and a dart, and an L padded at its
    reflex corner, ear-clipped into triangles whose overlaps sum back to
    the cell; raw column sums against the exact areas."""
    from icebin_tpu_torch.grid import (GridSpecGeneric, PlateCarree,
                                       make_exchange_grid)
    L = [[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [1.0, 1.0], [1.0, 3.0],
         [0.0, 3.0]]
    dart = [[5.0, 0.0], [7.0, 1.0], [9.0, 0.0], [7.0, 3.0], [7.0, 3.0],
            [7.0, 3.0]]
    L_pad = [[1.0, 3.0], [0.0, 3.0], [0.0, 0.0], [3.0, 0.0], [3.0, 1.0],
             [1.0, 1.0], [1.0, 1.0], [1.0, 1.0]]
    worst = 0.0
    for cells, subj, want in (
            ([L, dart], tri_grid(-1.0, 10.0, -1.0, 4.0, 12), [5e6, 4e6]),
            ([L_pad], tri_grid(-1.0, 4.0, -1.0, 4.0, 10), [5e6])):
        clip = GridSpecGeneric(polygons=np.asarray(cells),
                               projection=PlateCarree(scale=1e3))
        xg = make_exchange_grid(GridSpecGeneric(polygons=subj), clip,
                                device=device, repair=False)
        worst = max(worst, np.max(np.abs(xg.area_sums_I() - want) / want))
    say(f"polyclip: concave and pad-corner cells, max |raw column sum - "
        f"exact area| / area {worst:.3e} (limit 2e-5)")
    check(worst < 2e-5, f"concave cells off by {worst:.3e}")


def check_overlap_cli(specA, specI, device):
    """python -m icebin_tpu_torch.cli.overlap on grid files against the
    in-process build: the same exchange grid bit for bit."""
    from icebin_tpu_torch.grid import make_exchange_grid
    from icebin_tpu_torch.io import read_exchange, write_grid
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        a, i, x = (os.path.join(d, f) for f in ("a.nc", "i.nc", "x.nc"))
        write_grid(a, specA)
        write_grid(i, specI)
        t = time.perf_counter()
        # python -m puts its working directory, the checkout, on sys.path
        out = subprocess.run([sys.executable, "-m",
                              "icebin_tpu_torch.cli.overlap", a, i, x,
                              "--device", str(device)],
                             cwd=root, capture_output=True, text=True,
                             timeout=600)
        cli_ms = 1e3 * (time.perf_counter() - t)
        check(out.returncode == 0, f"overlap CLI failed: {out.stderr}")
        xc = read_exchange(x)
    xg = make_exchange_grid(specA, specI, subdiv=2, device=device)
    same = all(np.array_equal(getattr(xc, k), getattr(xg, k))
               for k in ("iA", "iI", "area", "centroid"))
    say(f"overlap CLI on {specA.ncells} x {specI.ncells} cell grid files: "
        f"{out.stdout.strip()}; {cli_ms:.1f} ms with its interpreter; the "
        f"same {xc.ncells} overlaps as the in-process build bit for bit "
        f"{same}")
    check(same, "the overlap CLI's exchange grid differs from the build's")


def phase_polyclip(specA, specI, device, counters):
    import torch
    from icebin_tpu_torch.grid import (assemble_polyclip, clip_poly_host,
                                       make_exchange_grid, polyclip_pairs,
                                       polyclip_pieces)
    from icebin_tpu_torch.ops.clip import (
        clip_areas_centroids_poly, clip_areas_centroids_poly_compact,
        clip_areas_centroids_poly_ref, make_polyclip_engine,
        recentre_poly_pairs)
    from icebin_tpu_torch.ops.csr import csr_pack
    from icebin_tpu_torch.regrid import WeightedMatrix

    hexes, mesh_ms = wall_ms(lambda: hex_mesh(specI, HEX_R))
    areas = np.abs(hexes.plane_areas())
    _, pieces_ms = wall_ms(lambda: polyclip_pieces(hexes))
    (pairA, pairI, subj, clip, p2c), pairs_ms = wall_ms(
        lambda: polyclip_pairs(specA, hexes, 2))
    (a_w, c_w), engine_ms = wall_ms(
        lambda: make_polyclip_engine(device=device)(subj, clip))
    xr, assemble_ms = wall_ms(lambda: assemble_polyclip(
        pairA, pairI, a_w, c_w, p2c, specA, hexes, repair=False))
    say(f"polyclip: {hexes.ncells} hexagons of {areas.mean() / 1e6:.4f} km2 "
        f"x {specA.ncells} ModelE cells at subdiv 2: {len(pairA)} candidate "
        f"pairs, {len(p2c)} clip pieces; host ms: mesh {mesh_ms:.1f}, pieces "
        f"(projection + decomposition) {pieces_ms:.1f}, pairs (pieces "
        f"included) {pairs_ms:.1f}, convex-clip engine (recentring, copies, "
        f"kernel) {engine_ms:.1f}, assembly {assemble_ms:.1f}")

    for k in counters:
        k.launches = 0
    xg, build_ms = wall_ms(lambda: make_exchange_grid(
        specA, hexes, subdiv=2, device=device))
    launches = {k.__name__: k.launches for k in counters}
    col = xg.area_sums_I()
    rel = np.max(np.abs(col - areas) / areas)
    raw = np.max(np.abs(xr.area_sums_I() - areas) / areas)
    key = xg.iA.astype(np.int64) * xg.nI + xg.iI
    dup = len(key) - len(np.unique(key))
    say(f"polyclip: make_exchange_grid {build_ms:.1f} ms, {xg.ncells} "
        f"overlaps, launch counts {launches}; max |column sum - hexagon "
        f"area| / area {rel:.3e} repaired (limit {COLSUM_TOL:g}), "
        f"{raw:.3e} raw (limit 1e-5); {dup} duplicate (iA, iI) pairs")
    check(launches["clip_areas_centroids_poly"] > 0,
          "the generic build did not launch the convex-clip kernel")
    check(rel < COLSUM_TOL, f"repaired column sums off by {rel:.3e}")
    check(raw < 1e-5, f"raw column sums off by {raw:.3e}")
    check(dup == 0, f"{dup} duplicate (iA, iI) pairs")

    p, q, _ = recentre_poly_pairs(subj, clip)
    p = torch.as_tensor(p, device=device)
    q = torch.as_tensor(q, device=device)
    a, c = clip_areas_centroids_poly(p, q)
    a_ref, _ = clip_areas_centroids_poly_ref(p, q)
    cell = torch.as_tensor(areas[p2c[pairI]], device=device)
    err = ((a.double() - a_ref.double()).abs() / cell).max().item()
    abs_err = (a - a_ref).abs().max().item()              # m2
    rng = np.random.default_rng(7)
    idx = np.sort(rng.choice(len(pairA), min(8192, len(pairA)),
                             replace=False))
    a_o, _ = clip_poly_host(subj[idx], clip[idx])
    err_o = np.max(np.abs(np.abs(a.cpu().numpy()[idx].astype(np.float64))
                          - a_o) / areas[p2c[pairI[idx]]])
    stage1_ms = check_stage2("polyclip", a, c, p, q,
                             clip_areas_centroids_poly_compact, cell,
                             sample(len(pairA), 5))
    ms = time_ms(lambda: clip_areas_centroids_poly(p, q), 20)
    plain_ms = time_ms(lambda: clip_areas_centroids_poly_ref(p, q), 2)
    bound_ms, bound_by = clip_bound(p, q)
    say(f"polyclip: convex-clip kernel on {len(pairA)} pairs at V0="
        f"{p.shape[1]}, Vc={q.shape[1]}: max |area - plain| / hexagon area "
        f"{err:.3e} (limit 1e-5), max |area - f64 oracle| / hexagon area "
        f"{err_o:.3e} on {len(idx)} seeded pairs (limit 1e-5); kernel "
        f"{ms:.4f} ms (stage 1 {stage1_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    check(err < 1e-5, f"convex-clip kernel vs plain {err:.3e}")
    check(err_o < 1e-5, f"convex-clip kernel vs f64 oracle {err_o:.3e}")

    check_concave(device)
    M = WeightedMatrix(rows=xg.iA, cols=xg.iI, vals=xg.area,
                       shape=(xg.nA, xg.nI))
    check_pack(M, csr_pack(M, nv=16, device=device), ("AvI", "IvA"),
               np.random.default_rng(3))
    check_overlap_cli(specA, specI, device)
    return {"max_abs_err": abs_err, "ms": ms, "stage1_ms": stage1_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "launches": launches["clip_areas_centroids_poly"]}


# -- phase 8: the standalone run CLI at full width -------------------------

def run_cli(cfg, flags, device, counters):
    """``icebin_tpu_torch.cli.run.main`` on ``cfg`` in the config's
    directory (where it writes its checkpoints), with the launch counters
    set to 0 just before and read just after; returns (stdout lines, wall
    ms, launches)."""
    import contextlib
    import io
    from icebin_tpu_torch.cli.run import main as run_main
    for k in counters:
        k.launches = 0
    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(os.path.dirname(cfg))
    try:
        with contextlib.redirect_stdout(buf):
            rc, ms = wall_ms(lambda: run_main([cfg, "--device", str(device),
                                               *flags]))
    finally:
        os.chdir(cwd)
    check(rc == 0, f"run CLI {flags} returned {rc}")
    return (buf.getvalue().strip().splitlines(), ms,
            {k.__name__: k.launches for k in counters})


def check_resume(gr, device):
    """Through the API, with forcing fixed by the step: 3 steps, a
    checkpoint, 3 more; the checkpoint loaded into a fresh coupler runs the
    same 3 steps.  H, enth, t and every ledger row agree bit for bit (the
    regeneration at step 3 rebuilds the matrices from the saved
    elevmask)."""
    import torch
    from icebin_tpu_torch import CouplerConfig, GCMCoupler
    from icebin_tpu_torch.coupler.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    def fn(t, sheet):
        return torch.as_tensor(forcing(gr.nE, seed=int(t // DT)),
                               device=device)

    cfg = CouplerConfig(dt=DT, regen_every=REGEN)
    a = GCMCoupler(gr, cfg, device=device)
    a.run_transient(fn, REGEN)
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "checkpoint.npz")
        save_checkpoint(ck, a)
        a.run_transient(fn, REGEN)
        b = GCMCoupler(gr, cfg, device=device)
        load_checkpoint(ck, b)
        b.run_transient(fn, REGEN)
    sa, sb = a.sheets["greenland"].state, b.sheets["greenland"].state
    same = {k: bool(torch.equal(getattr(sa, k), getattr(sb, k)))
            for k in ("H", "enth", "t")}
    rows = a.ledger.to_rows() == b.ledger.to_rows()
    replays = [cp.sheets["greenland"].replays for cp in (a, b)]
    say(f"run: resume from a checkpoint after step {REGEN}, {REGEN} more "
        f"steps: bit for bit {same}, ledger rows {rows}; compiled-step "
        f"replays {replays}")
    check(all(same.values()) and rows, "resumed run is not bit-identical")
    check(min(replays) > 0, "the resumed run did not replay the compiled "
                            "step")


def phase_run(specA, specI, xg, device, counters):
    """Grid files and the exchange grid in a temporary directory, a
    RunConfig with checkpoints and dumps, and the run CLI stepwise, --fused
    and --ice dismal; then a bit-identical resume."""
    from icebin_tpu_torch import GCMRegridder
    from icebin_tpu_torch.io import write_exchange, write_grid
    from icebin_tpu_torch.utils.config import RunConfig, SheetConfig
    # dumps: every step, or each fused window's last step
    modes = (("stepwise", [], 2 * REGEN), ("fused", ["--fused"], 2),
             ("dismal", ["--ice", "dismal"], 2 * REGEN))
    with tempfile.TemporaryDirectory() as d:
        a, i, x = (os.path.join(d, f) for f in ("a.nc", "i.nc", "x.nc"))
        write_grid(a, specA)
        write_grid(i, specI)
        write_exchange(x, xg)
        for mode, flags, n_dumps in modes:
            run_dir = os.path.join(d, mode)
            os.mkdir(run_dir)
            cfg = os.path.join(run_dir, "run.json")
            RunConfig(gridA_file=a, hcdefs=HCDEFS, sheets=[SheetConfig(
                name="greenland", grid_file=i, exchange_file=x)],
                dt_seconds=DT, n_steps=2 * REGEN, regen_every=REGEN,
                checkpoint_every=REGEN,
                dump_dir=os.path.join(run_dir, "dumps")).to_json(cfg)
            lines, ms, launches = run_cli(cfg, flags, device, counters)
            worst = float(lines[-1].rsplit(" ", 1)[-1])
            dumps = sorted(os.listdir(os.path.join(run_dir, "dumps")))
            cks = [f"checkpoint_{k:06d}.npz" for k in (REGEN, 2 * REGEN)]
            have = all(os.path.exists(os.path.join(run_dir, f)) for f in cks)
            say(f"run CLI {mode}: {lines[-1]}; main() {ms:.1f} ms for "
                f"{2 * REGEN} steps, {ms / (2 * REGEN):.1f} ms per step with "
                f"the set-up (grid and exchange files, matrices), dumps and "
                f"checkpoints; {len(dumps)} dumps, checkpoints {cks} "
                f"{have}; launch counts {launches}")
            check(worst < TRANSPORT_TOL, f"run CLI {mode}: transport "
                                         f"conservation {worst:.3e}")
            check(len(dumps) == n_dumps, f"run CLI {mode}: {len(dumps)} "
                                         f"dumps, not {n_dumps}")
            check(have, f"run CLI {mode}: missing checkpoints")
            for name in ("spmm_dest_ice", "spmm_dest_small"):
                check(launches[name] > 0, f"run CLI {mode} did not launch "
                                          f"{name}")
    gr = GCMRegridder(specA, HCDEFS, device=device)
    gr.add_sheet("greenland", specI, exchange=xg, subdiv=2)
    check_resume(gr, device)


# -- phase 9: the stream-reduce kernel, the card's read rate ---------------

def phase_roof(device):
    """stream_reduce on seeded arrays of 34 MB (under the 50 MB L2) and
    268 MB, timed with the launch counter set to 0 just before and read
    just after, then held against its plain version and torch.sum."""
    import torch
    from icebin_tpu_torch.ops.roof import stream_reduce, stream_reduce_ref
    g = torch.Generator(device=device)
    g.manual_seed(0)
    arrays = [(torch.rand((R, W), generator=g, device=device) * 2 - 1,
               torch.rand(W, generator=g, device=device))
              for R, W in ROOF_SHAPES]
    stream_reduce.launches = 0
    times = [time_ms(lambda: stream_reduce(x, c), 50) for x, c in arrays]
    launches = stream_reduce.launches
    res = None
    for (x, c), ms in zip(arrays, times):
        y, again = stream_reduce(x, c), stream_reduce(x, c)
        plain = stream_reduce_ref(x, c)
        torch.cuda.synchronize()
        err = ((y.double() - plain.double()).abs()
               / x.abs().double().sum(0)).max().item()
        ident = bool(torch.equal(y, again))
        plain_ms = time_ms(lambda: stream_reduce_ref(x, c), 50)
        lib_ms = time_ms(lambda: torch.sum(x, 0), 50)
        nbytes = 4 * (x.numel() + 2 * x.shape[1])
        bound_ms, bound_by = bound(nbytes, x.numel())
        where = ("fits in the 50 MB L2: an L2 rate" if nbytes < 50e6
                 else "streams from HBM: the read roof")
        say(f"roof: stream_reduce {tuple(x.shape)} f32, {nbytes / 1e6:.1f} "
            f"MB ({where}): kernel {ms:.4f} ms = {nbytes / ms / 1e6:.1f} "
            f"GB/s, torch.sum {lib_ms:.4f} ms = {nbytes / lib_ms / 1e6:.1f} "
            f"GB/s, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {PEAK_BYTES_S / 1e12:g} TB/s); max |kernel - "
            f"plain| / sum |x| {err:.3e} (limit 1e-5), rerun bit-identical "
            f"{ident}")
        check(err < 1e-5, f"stream_reduce vs plain {err:.3e}")
        check(ident, "stream_reduce rerun is not bit-identical")
        # the JSON row keeps the last array's: 268 MB, the HBM read roof
        res = {"max_abs_err": (y - plain).abs().max().item(), "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
    say(f"roof: launch count in the timed runs {launches}")
    check(launches > 0, "stream_reduce was not launched")
    res["launches"] = launches
    return res


# -- phase 10: BASELINE config #5, Greenland + Antarctica on one A grid ----

def check_ledger(rows, sheets, what):
    """Every row's transport identity, mass and energy, for every sheet."""
    worst = 0.0
    for r in rows:
        for name in sheets:
            for book in ("mass", "energy"):
                a = r[f"{name}.{book}_in_E"]
                b = r[f"{name}.{book}_delivered_I"]
                check(np.isfinite(a) and abs(a) > 0,
                      f"{what}: {name} {book}_in_E is {a}")
                worst = max(worst, abs(a - b) / abs(a))
    say(f"{what}: {len(rows)} ledger rows of {len(sheets)} sheets, max "
        f"|in_E - delivered_I| / |in_E| {worst:.3e} (mass and energy; limit "
        f"{TRANSPORT_TOL:g})")
    check(worst < TRANSPORT_TOL, f"{what}: transport identity {worst:.3e}")


def multisheet_rates(gr, cfg, device):
    """Steps/s as bench.py:454-483 measures them: a coupler of both sheets
    that never regenerates, sub-couplers sharing its sheet objects for each
    sheet alone, one forcing for both; per configuration a warm loop, then
    the two-point difference of the fastest of 3 loops of MS_N1 and of
    MS_N2 steps, each step booking its row from its own fetch; the
    spread is the range of the 3 pairs' own differences.  The timed rows
    must keep the transport identity."""
    import dataclasses
    import torch
    from icebin_tpu_torch import GCMCoupler
    tcfg = dataclasses.replace(cfg, regen_every=1 << 30)
    both = GCMCoupler(gr, tcfg, device=device)
    fE = torch.as_tensor(forcing(gr.nE, seed=30), device=device)

    def run_loop(n, c):
        t = time.perf_counter()
        for _ in range(n):
            c.couple({name: fE for name in c.sheets})
        return time.perf_counter() - t

    run_loop(MS_N1, both)
    rates = {}
    for key, names in (("greenland", ("greenland",)),
                       ("antarctica", ("antarctica",)),
                       ("both", tuple(SHEETS))):
        c = both if key == "both" else GCMCoupler(
            gr, tcfg, device=device,
            sheets={n: both.sheets[n] for n in names})
        run_loop(MS_N1, c)
        t1 = [run_loop(MS_N1, c) for _ in range(3)]
        t2 = [run_loop(MS_N2, c) for _ in range(3)]
        rate = lambda a, b: (MS_N2 - MS_N1) / max(b - a, 1e-9)
        rates[key] = rate(min(t1), min(t2))
        spread = sorted(rate(a, b) for a, b in zip(t1, t2))
        say(f"multisheet {key}: {rates[key]:.2f} steps/s (fastest of 3); "
            f"the 3 pairs' own differences "
            f"{', '.join(f'{r:.2f}' for r in spread)} steps/s; loops of "
            f"{MS_N1}: "
            f"{', '.join(f'{1e3 * t:.1f}' for t in t1)} ms, of {MS_N2}: "
            f"{', '.join(f'{1e3 * t:.1f}' for t in t2)} ms")
        check_ledger(c.ledger.to_rows()[-MS_N2:], names,
                     f"multisheet timed steps, {key}")
        phase_profile(c, 1e3 / rates[key], device, n=2,
                      tag=f"multisheet profile, {key}")
    say(f"multisheet: {rates['greenland']:.2f} steps/s Greenland alone, "
        f"{rates['antarctica']:.2f} Antarctica alone, {rates['both']:.2f} "
        f"both (stepwise, no regeneration; two-point over "
        f"{MS_N1} and {MS_N2} steps, fastest of 3)")
    return rates


def phase_multisheet(specA, specG, xg_green, device, counters):
    """Config #5: Antarctica's exchange grid through the clip kernel (all
    pairs against its plain version, then the build with the launch
    counters set to 0 just before and read just after, against the f64
    host build), one GCMCoupler on both sheets driven as phase 3 drives
    Greenland, steps/s as bench.py measures them, and Antarctica's
    EvI/IvE/AvI/IvA through the regrid kernels at nv = 16 and 64."""
    import torch
    from icebin_tpu_torch import CouplerConfig, GCMCoupler, GCMRegridder
    from icebin_tpu_torch.grid import make_exchange_grid_host
    from icebin_tpu_torch.ops.csr import csr_pack

    specAnt = antarctica_spec()
    phase_clip(specA, specAnt, device, "clip antarctica")
    gr = GCMRegridder(specA, HCDEFS, device=device)
    gr.add_sheet("greenland", specG, exchange=xg_green, subdiv=2)
    for k in counters:
        k.launches = 0
    _, build_ms = wall_ms(lambda: gr.add_sheet("antarctica", specAnt,
                                               subdiv=2))
    built = {k.__name__: k.launches for k in counters}
    say(f"multisheet: Antarctica {specAnt.nx} x {specAnt.ny} = "
        f"{specAnt.ncells} cells, exchange build {build_ms:.1f} ms, launch "
        f"counts {built}")
    check(built["clip_areas_centroids"] > 0,
          "the Antarctica build did not launch the clip kernel")
    xo, np_ms = wall_ms(lambda: make_exchange_grid_host(specA, specAnt,
                                                        subdiv=2))
    say(f"f64 numpy exchange build of Antarctica (host, for comparison) "
        f"{np_ms:.1f} ms")
    compare_exchange(gr.sheets["antarctica"].exchange, xo, specAnt,
                     "exchange antarctica")
    del xo

    for k in counters:
        k.launches = 0
    cfg = CouplerConfig(dt=DT, regen_every=REGEN)
    cp, init_ms = wall_ms(lambda: GCMCoupler(gr, cfg, device=device))
    step_ms = []
    for k in range(2 * REGEN):
        fE = torch.as_tensor(forcing(gr.nE, seed=k), device=device)
        out, ms = wall_ms(lambda: cp.couple({n: fE for n in SHEETS}))
        step_ms.append(ms)
    n_stepwise = len(cp.ledger.to_rows())
    fused = lambda t, s: torch.as_tensor(forcing(gr.nE, seed=int(t // DT)),
                                         device=device)
    out, fused_ms = wall_ms(lambda: cp.run_transient(fused, REGEN,
                                                     fused=True))
    launches = {k.__name__: k.launches for k in counters}
    say(f"multisheet phase ms: coupler init (both sheets' matrices + packs) "
        f"{init_ms:.1f}, stepwise steps "
        f"{', '.join(f'{m:.1f}' for m in step_ms)} (regeneration in steps "
        f"{REGEN} and {2 * REGEN}), fused window of {REGEN} {fused_ms:.1f}; "
        f"launch counts {launches}")
    for name in ("spmm_dest_ice", "spmm_dest_small"):
        check(launches[name] > 0, f"the two-sheet coupler did not launch "
                                  f"{name}")
    check(n_stepwise == 2 * REGEN,
          f"{n_stepwise} ledger rows from {2 * REGEN} two-sheet steps")
    rows = cp.ledger.to_rows()
    check(len(rows) == 3 * REGEN, f"{len(rows)} ledger rows")
    check_ledger(rows, SHEETS, "multisheet")
    for name, specI in (("greenland", specG), ("antarctica", specAnt)):
        o = out[name]
        check(tuple(o["fI"].shape) == (8, specI.ncells), f"{name} fI shape")
        check(tuple(o["fE_out"].shape) == (10, gr.nE), f"{name} fE_out")
        check(tuple(o["fA_out"].shape) == (10, specA.ncells),
              f"{name} fA_out")
        live = cp.sheets[name].mat("EvI").wM > 0
        check(bool(torch.isfinite(o["fE_out"][3:9, live]).all()),
              f"{name}: non-finite flux harvest on live E cells")
        check(bool(torch.isfinite(cp.sheets[name].state.H).all()),
              f"{name}: non-finite ice state")
    multisheet_rates(gr, cfg, device)

    sc = cp.sheets["antarctica"]
    rng = np.random.default_rng(4)
    for name in ("EvI", "AvI"):
        M = sc.rm.matrix(name, cp.cfg.params)
        say(f"antarctica {name}: {M.shape[0]} x {M.shape[1]}, {M.nnz} nnz")
        for nv in (16, 64):
            pack = (sc.mat(name).pack if nv == cp.cfg.nv
                    else csr_pack(M, nv=nv, device=device))
            check_pack(M, pack, (f"antarctica {name} nv={nv}",
                                 f"antarctica Iv{name[0]} nv={nv}"), rng, nv)
    return cp


# -- phase 11: the ModelE C ABI driving config #5 --------------------------

def phase_modele(gr, device, counters):
    """Config #5's grid and exchange-grid files and a RunConfig naming both
    sheets; the port's gcmce_* C ABI opened through ctypes, two steps of
    forcing fed in ModelE's ihc-major layout in two 'rank' pieces, and
    gcmce_couple_native filling the TOPO buffers.  Buffers, ledger rows and
    ice state are bit for bit those of the port's coupler driven directly
    on the same forcing."""
    import ctypes
    import torch
    from icebin_tpu_torch import CouplerConfig
    from icebin_tpu_torch.io import write_exchange, write_grid
    from icebin_tpu_torch.models import gcmce_shim
    from icebin_tpu_torch.models.modele_adapter import (ModelEAdapter,
                                                        to_modele_E)
    from icebin_tpu_torch.ops._build_gcmce import gcmce_library
    from icebin_tpu_torch.utils.config import RunConfig, SheetConfig

    path, lib_ms = wall_ms(gcmce_library)
    lib = ctypes.CDLL(str(path))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.gcmce_new.argtypes, lib.gcmce_new.restype = [ctypes.c_char_p], \
        ctypes.c_int
    lib.gcmce_dims.argtypes = [ctypes.c_int, P, P, P]
    lib.gcmce_set_start_time.argtypes = [ctypes.c_int, ctypes.c_double]
    lib.gcmce_add_gcm_outpute.argtypes = [ctypes.c_int, P, P, I64,
                                          ctypes.c_int]
    lib.gcmce_couple_native.argtypes = [ctypes.c_int, ctypes.c_double, P, P,
                                        P, I64]
    lib.gcmce_delete.argtypes = [ctypes.c_int]
    nA, nhc, nE = gr.nA, gr.nhc, gr.nE
    with tempfile.TemporaryDirectory() as d:
        a = os.path.join(d, "a.nc")
        write_grid(a, gr.specA)
        sheets = []
        for name, sh in gr.sheets.items():
            i, x = (os.path.join(d, f"{name}_{f}.nc") for f in ("grid", "x"))
            write_grid(i, sh.gridI)
            write_exchange(x, sh.exchange)
            sheets.append(SheetConfig(name=name, grid_file=i,
                                      exchange_file=x))
        rc = RunConfig(gridA_file=a, hcdefs=HCDEFS, sheets=sheets,
                       dt_seconds=DT, regen_every=REGEN)
        cfg = os.path.join(d, "run.json")
        rc.to_json(cfg)
        h, new_ms = wall_ms(lambda: lib.gcmce_new(cfg.encode()))
    check(h > 0, f"gcmce_new returned {h}")
    dims = [ctypes.c_int() for _ in range(3)]
    check(lib.gcmce_dims(h, *map(ctypes.byref, dims)) == 0, "gcmce_dims")
    dims = tuple(v.value for v in dims)
    check(dims == gr.specA.shape + (nhc,), f"gcmce_dims {dims}")
    lib.gcmce_set_start_time(h, 0.0)
    direct = ModelEAdapter(gr, CouplerConfig(
        dt=rc.dt_seconds, regen_every=rc.regen_every,
        min_thickness=rc.min_thickness, params=rc.regrid_params()),
        device=device)
    direct.set_start_time(0.0)
    same, couple_ms = [], []
    launches = dict.fromkeys((k.__name__ for k in counters), 0)
    for step in range(2):
        f = forcing(nE, seed=40 + step)
        fm = to_modele_E(f.astype(np.float64), nA, nhc)
        for lo, hi in ((0, nE // 2), (nE // 2, nE)):      # two 'ranks'
            idx = np.arange(lo, hi, dtype=np.int64)
            vals = np.ascontiguousarray(fm[:, lo:hi])
            lib.gcmce_add_gcm_outpute(h, idx.ctypes.data, vals.ctypes.data,
                                      hi - lo, vals.shape[0])
        bufs = (np.zeros(nE), np.zeros(nE), np.zeros(nE, np.int32))
        for k in counters:
            k.launches = 0
        rc_, ms = wall_ms(lambda: lib.gcmce_couple_native(
            h, float(step) * DT, *(b.ctypes.data for b in bufs), nE))
        for k in counters:          # the C ABI's launches alone
            launches[k.__name__] += k.launches
        check(rc_ == 0, f"gcmce_couple_native returned {rc_}")
        couple_ms.append(ms)
        fE = torch.as_tensor(f, device=device)
        direct.coupler.couple({name: fE for name in gr.sheets})
        same += [np.array_equal(b, w.reshape(-1))
                 for b, w in zip(bufs, direct.topo())]
    ad = gcmce_shim._handles[h]
    rows = ad.coupler.ledger.to_rows() == direct.coupler.ledger.to_rows()
    state = all(torch.equal(getattr(ad.coupler.sheets[n].state, k),
                            getattr(direct.coupler.sheets[n].state, k))
                for n in gr.sheets for k in ("H", "enth"))
    fhc = bufs[0].reshape(nhc, -1).sum(axis=0)
    replays = {n: sc.replays for n, sc in ad.coupler.sheets.items()}
    say(f"modele: C ABI built in {lib_ms:.1f} ms (g++, embedded CPython); "
        f"gcmce_new {new_ms:.1f} ms (files, regridder, both sheets' "
        f"matrices), dims {dims}; gcmce_couple_native "
        f"{', '.join(f'{m:.1f}' for m in couple_ms)} ms (2 steps, TOPO "
        f"included); fhc/elevE/underice bit for bit the direct coupler's "
        f"{same}, ledger rows {rows}, ice state {state}; sheets under ice "
        f"{sorted(set(np.unique(bufs[2])) - {0})}, max |sum_hc fhc - 1| on "
        f"iced A cells {np.abs(fhc[fhc > 0] - 1).max():.3e}; launch counts "
        f"in the 2 gcmce_couple_native calls alone {launches}; compiled-"
        f"step replays {replays}")
    check(min(replays.values()) > 0,
          "the C ABI's coupling did not replay the compiled step")
    check(all(same) and rows and state,
          "the C ABI's coupling differs from the directly driven coupler")
    check(np.abs(fhc[fhc > 0] - 1).max() < 1e-9, "fhc does not sum to 1")
    for name in ("spmm_dest_ice", "spmm_dest_small"):
        check(launches[name] > 0, f"the C ABI did not launch {name}")
    lib.gcmce_delete(h)
    check(h not in gcmce_shim._handles, "gcmce_delete kept the handle")


# -- phase 12: the stream-only floors and the tile product ------------------

def phase_floors(sheets, device):
    """The stream-only floors on each sheet's EvI (dest-small) and IvE
    (dest-ice) at nv = 16, timed beside the stock kernel on the same
    matrix and field; then the tile product at Greenland and Antarctica
    depth beside its plain version and torch.bmm.  Launch counters are set
    to 0 just before the timed runs and read just after; the comparisons
    with the plain versions follow."""
    import torch
    from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_dest_small
    from icebin_tpu_torch.ops.floor import (spmm_floor_ice,
                                            spmm_floor_ice_ref,
                                            spmm_floor_small,
                                            spmm_floor_small_ref)
    from icebin_tpu_torch.ops.prods import tile_prods, tile_prods_ref
    floors = ((spmm_floor_small, spmm_floor_small_ref, spmm_dest_small,
               "small", "EvI"),
              (spmm_floor_ice, spmm_floor_ice_ref, spmm_dest_ice, "ice",
               "IvE"))
    rng = np.random.default_rng(5)
    cases = []
    for sheet, sc in sheets.items():
        pack = sc.mat("EvI").pack
        for floor, ref, stock, side, tag in floors:
            csr = getattr(pack, side)
            x = torch.as_tensor((260.0 + 30.0 * rng.uniform(
                size=(csr.n_src, 16))).astype(np.float32), device=device)
            cases.append((floor, ref, stock, csr, x, f"{sheet} {tag}"))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tiles = [(torch.rand((B, 32, 128), generator=gen, device=device) * 2 - 1,
              torch.rand((B, 8, 128), generator=gen, device=device) * 2 - 1)
             for B in PRODS_ROWS]
    for k in (spmm_floor_small, spmm_floor_ice, tile_prods):
        k.launches = 0
    t_floor = [time_ms(lambda: c[0](c[3], c[4]), 50) for c in cases]
    t_prods = [time_ms(lambda: tile_prods(T, F), 50) for T, F in tiles]
    launches = {k.__name__: k.launches
                for k in (spmm_floor_small, spmm_floor_ice, tile_prods)}
    say(f"floors: launch counts in the timed runs {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched")

    res = {}
    for (floor, ref, stock, csr, x, tag), ms in zip(cases, t_floor):
        got, again, plain = floor(csr, x), floor(csr, x), ref(csr, x)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        ident = bool(torch.equal(got, again))
        stock_ms = time_ms(lambda: stock(csr, x), 50)
        plain_ms = time_ms(lambda: ref(csr, x), 3)
        bound_ms, bound_by = spmm_bound(csr, x.shape[1])
        say(f"{floor.__name__} {tag}: ({csr.n_src} x 16) -> ({csr.n_dst} x "
            f"16), {csr.vals.numel()} nnz: max |kernel - plain| {err:.3e} "
            f"(limit 0: the same f32 adds in the same order), rerun "
            f"bit-identical {ident}; floor {ms:.4f} ms, stock "
            f"{stock.__name__} {stock_ms:.4f} ms, stock - floor "
            f"{stock_ms - ms:.4f} ms ({100 * (1 - ms / stock_ms):.1f}% of "
            f"the stock time); plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        check(err == 0.0, f"{floor.__name__} {tag} vs plain {err:.3e}")
        check(ident, f"{floor.__name__} {tag} rerun is not bit-identical")
        # the JSON row keeps the main path's matrices: Greenland
        if tag.startswith("greenland"):
            res[floor.__name__] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "launches": launches[floor.__name__]}
    torch.backends.cuda.matmul.allow_tf32 = False
    for (T, F), ms in zip(tiles, t_prods):
        B = T.shape[0]
        got, again, plain = tile_prods(T, F), tile_prods(T, F), \
            tile_prods_ref(T, F)
        lib = torch.bmm(T, F.transpose(1, 2))
        mag = torch.matmul(T.abs().double(), F.abs().double().transpose(1, 2))
        err = ((got.double() - plain.double()).abs() / mag).max().item()
        err_lib = ((got.double() - lib.double()).abs() / mag).max().item()
        ident = bool(torch.equal(got, again))
        plain_ms = time_ms(lambda: tile_prods_ref(T, F), 10)
        lib_ms = time_ms(lambda: torch.bmm(T, F.transpose(1, 2)), 50)
        nbytes = 4 * B * (32 * 128 + 8 * 128 + 32 * 8)
        bound_ms, bound_by = bound(nbytes, 2 * B * 32 * 8 * 128)
        say(f"tile_prods: {B} x (32 x 128) . (8 x 128)^T f32, "
            f"{nbytes / 1e6:.1f} MB: kernel {ms:.4f} ms = "
            f"{nbytes / ms / 1e6:.1f} GB/s, torch.bmm (TF32 off) "
            f"{lib_ms:.4f} ms, plain (f64) {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); max |kernel - plain| / "
            f"sum|T F| {err:.3e}, vs torch.bmm {err_lib:.3e} (limit "
            f"{PRODS_TOL:.3e}), rerun bit-identical {ident}")
        check(err < PRODS_TOL and err_lib < 2 * PRODS_TOL,
              f"tile_prods vs plain {err:.3e}, vs bmm {err_lib:.3e}")
        check(ident, "tile_prods rerun is not bit-identical")
        # the JSON row keeps Antarctica depth, from HBM
        res["tile_prods"] = {
            "max_abs_err": (got - plain).abs().max().item(), "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "launches": launches["tile_prods"]}
    return res


# -- phase 13: the dest-small probe kernels --------------------------------

K2PROBE_SITES = {    # each probe kernel's TPU sites (pallas_call lines)
    "spmm_small_slots": "tools/probe_slots.py:106",
    "spmm_small_group": "tools/probe_group.py:111",
    "spmm_small_batch": ("tools/probe_batch.py:136 and "
                         "tools/probe_batch2.py:118"),
    "spmm_small_ablate": "tools/probe_ablate.py:261",
}


def k2_split(by, tag):
    """Print how the stage-1 K2's time divides on one matrix and nv (the
    stage-1 K2 is slots(1), whose order and mapping it keeps: a warp a
    row, every row): its stream floor, then what each variant's best
    parameter saves (+) or costs (-); and the stage-2 K2 beside it, on the
    whole CSR and on its live rows alone (what its empty rows' zeros
    cost)."""
    def ms(name, p=None):
        return by[(name, p)]["ms"]

    def best(name):
        return min((c for (k, _), c in by.items() if k == name),
                   key=lambda c: c["ms"])

    k2 = ms("spmm_small_slots", 1)
    parts = [("f64 arithmetic (stage 1 - ablate f32)",
              k2 - ms("spmm_small_ablate", "f32")),
             ("shuffle tree (stage 1 - ablate smem)",
              k2 - ms("spmm_small_ablate", "smem"))]
    for name, what in (("spmm_small_slots", "per-lane load chain"),
                       ("spmm_small_group", "share of the card in use"),
                       ("spmm_small_batch",
                        "per-16-field re-walk and uncoalesced reads")):
        b = best(name)
        parts.append((f"{what} (stage 1 - {name[11:]}({b['param']}))",
                      k2 - b["ms"]))
    k2s = ms("spmm_dest_small")
    say(f"k2probe {tag}: stage-1 K2 (slots(1)) {k2:.4f} ms, its stream floor "
        f"{ms('spmm_floor_small'):.4f} ms, cuSPARSE "
        f"{ms('torch.sparse.mm'):.4f} ms; "
        + "; ".join(f"{what} {1e3 * d:+.1f} us" for what, d in parts)
        + f"; stage-2 K2 {k2s:.4f} ms ({1e3 * (k2s - k2):+.1f} us against "
        f"stage 1), on its live rows alone "
        f"{ms('spmm_dest_small', LIVE):.4f} ms")


# -- phase 14: the dest-ice probe kernels ----------------------------------

K1PROBE_SITES = {    # each probe kernel's TPU sites (pallas_call lines)
    "spmm_ice_slots": "tools/probe_slots.py:161",
    "spmm_ice_batch": ("tools/probe_batch.py:207 and "
                       "tools/probe_batch2.py:184"),
    "spmm_ice_ablate": ("tools/probe_ablate.py:182 and "
                        "tools/probe_manual6.py:149"),
    "spmm_ice_stage": "tools/probe_ice_bisect.py:119",
    "spmm_ice_store": ("tools/probe_donate.py:71 and "
                       "tools/probe_rmw.py:105"),
}


def k1_split(by, tag):
    """Print how K1's time divides on one matrix and nv: its stream floor
    and the stages' increments up to K1, then what each variant's best
    parameter saves (+) or costs (-); the allocation of K1's output in host
    wall-clock time, which device time cannot see."""
    def ms(name, p=None, key="ms"):
        return by[(name, p)][key]

    def best(name):
        return min((c for (k, _), c in by.items() if k == name),
                   key=lambda c: c["ms"])

    k1 = ms("spmm_dest_ice")
    ladder = [("floor", ms("spmm_floor_ice"))] + [
        (lv, ms("spmm_ice_stage", lv))
        for lv in ("gather", "clean", "weights")] + [("scale (K1)", k1)]
    steps = ", ".join(f"{b[0]} {1e3 * (b[1] - a[1]):+.1f}"
                      for a, b in zip(ladder, ladder[1:]))
    parts = [("f64 arithmetic (K1 - ablate f32)",
              k1 - ms("spmm_ice_ablate", "f32")),
             ("layout (K1 - ablate row)", k1 - ms("spmm_ice_ablate", "row"))]
    for name, what in (("spmm_ice_slots", "dependent add chain"),
                       ("spmm_ice_batch", "staging")):
        b = best(name)
        parts.append((f"{what} (K1 - {name[9:]}({b['param']}))",
                      k1 - b["ms"]))
    parts.append(("read before write (K1 - store rmw)",
                  k1 - ms("spmm_ice_store", "rmw")))
    wall = ms("spmm_dest_ice", key="host_ms")
    into = ms("spmm_ice_store", "into", "host_ms")
    via = ms("spmm_dest_ice", APPLY)
    fields = ms("spmm_ice_store", "fields")
    say(f"k1probe {tag}: K1 {k1:.4f} ms, its stream floor "
        f"{ms('spmm_floor_ice'):.4f} ms, cuSPARSE "
        f"{ms('torch.sparse.mm'):.4f} ms; stages over the floor (us): "
        f"{steps}; "
        + "; ".join(f"{what} {1e3 * d:+.1f} us" for what, d in parts)
        + f"; allocation, host wall clock of a synchronised call (K1 "
        f"{wall:.4f} ms - store into {into:.4f} ms) {1e3 * (wall - into):+.1f}"
        f" us; K1 through the stage-1 apply_ice's transposes {via:.4f} "
        f"ms against store fields {fields:.4f} ms "
        f"({1e3 * (via - fields):+.1f} us)")


# -- phases 13 and 14: one probe run each ------------------------------

def phase_probe(probe, base, matrix, side, sites, split, sheets, device):
    """The probe module ``probe`` (tools/probe_k2 or tools/probe_k1) of the
    regrid kernel ``base`` ("K2" or "K1") on each sheet's ``matrix`` ("EvI"
    or "IvE", its pack's ``side`` CSR) at nv = 16 and 64, fields with NaN
    and inf sources, each wrapper's launch counter set to 0 just before its
    timed calls and read just after.  Every variant (the kernels of
    ``sites``) bit for bit its plain version and its rerun, then also on
    probe_k2.order_case's cancelling data, which tells the summation orders
    apart; on the real matrices every tie the probe's ``cases`` name holds
    (K1's order gives K1's bits; slots(1) and group(1) give the stage-1 K2's
    bits, and K2 on its live rows alone K2's) and those with f64 sums are
    within RAW_TOL of the f64 oracle (the
    f32 ablation's error printed, not gated); ``split`` prints how
    ``base``'s time divides.
    Returns {kernel: its JSON row's numbers}: ms, plain ms and bounds at
    Greenland, nv = 16, its best parameter there (``param``), as library_ms
    the ms of the cuSPARSE case that computes that parameter's function
    (the probe's torch.sparse.mm case of that parameter, else of
    ``base``'s function); launches summed and max_abs_err the worst over
    every case of the phase."""
    from icebin_tpu_torch.tools.probe_k2 import fields, order_case
    ties = {(name, p): key for name, p, *_, key in probe.cases() if key}
    res, launches, worst = {}, {}, {}

    def check_case(c, what, tag, against_base=True):
        name, p = c["kernel"], c["param"]
        if against_base and (name, p) in ties:
            check(c[ties[(name, p)]], f"{what} {tag}: {ties[(name, p)]} "
                                      f"is false")
        if c["raw_err"] is not None and p != "f32":
            check(c["raw_err"] < RAW_TOL,
                  f"{what} {tag} raw error {c['raw_err']:.3e}")
        if name in sites:
            worst[name] = max(worst.get(name, 0.0), c["max_abs_err"])
            check(c["equals_plain"],
                  f"{what} {tag} vs plain {c['max_abs_err']:.3e}")
            check(c["rerun_identical"], f"{what} {tag} rerun differs")

    for sheet, sc in sheets.items():
        M = sc.rm.matrix(matrix, sc.cfg.params)
        csr = getattr(sc.mat(matrix).pack, side)
        for nv in (16, 64):
            tag = f"{sheet} {matrix} nv={nv}"
            by = {}
            for c in probe.run_cases(M, csr, fields(csr.n_src, nv, seed=nv)):
                name, p = c["kernel"], c["param"]
                by[(name, p)] = c
                what = name if p is None else f"{name}({p})"
                if name == "torch.sparse.mm":
                    of = base if p is None else f"stage {p}"
                    raw = ("" if c["raw_err"] is None else
                           f", raw error vs f64 oracle {c['raw_err']:.3e}")
                    say(f"{base.lower()}probe {tag}: {what} (cuSPARSE) "
                        f"{c['ms']:.4f} ms{raw}, max |cuSPARSE - {of}| "
                        f"{c['max_abs_err']:.3e}")
                    continue
                raw = ("-" if c["raw_err"] is None
                       else f"{c['raw_err']:.3e}")
                say(f"{base.lower()}probe {tag}: {what} {c['ms']:.4f} ms, "
                    f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}), plain "
                    f"{c['plain_ms']:.3f} ms (one call), max |kernel - "
                    f"plain| {c['max_abs_err']:.3e}, bit for bit plain "
                    f"{c['equals_plain']}, rerun bit-identical "
                    f"{c['rerun_identical']}, "
                    + "".join(f"{k} {v}, " for k, v in c.items()
                              if k.startswith("equals_")
                              and k != "equals_plain")
                    + f"raw error vs f64 oracle {raw}, launches in the "
                    f"timed calls {c['launches']}")
                check(c["launches"] > 0, f"{what} was not launched")
                if name in sites:
                    launches[name] = launches.get(name, 0) + c["launches"]
                check_case(c, what, tag)
            split(by, tag)
            if (sheet, nv) == ("greenland", 16):
                for name in sites:
                    b = min((c for (k, _), c in by.items() if k == name),
                            key=lambda c: c["ms"])
                    lib = by.get(("torch.sparse.mm", b["param"]),
                                 by[("torch.sparse.mm", None)])
                    res[name] = dict(
                        {k: b[k] for k in ("param", "ms", "plain_ms",
                                           "bound_ms", "bound_by")},
                        library_ms=lib["ms"])
    for nv in (1, 20):
        csr, x = order_case(nv, nv, device)
        for c in probe.run_cases(None, csr, x, reps=0):
            if c["kernel"] == "torch.sparse.mm":
                continue
            check_case(c, f"{c['kernel']}({c['param']})",
                       f"order_case nv={nv}", against_base=False)
    for name in res:
        res[name].update(launches=launches[name], max_abs_err=worst[name])
    say(f"{base.lower()}probe: on cancelling data (probe_k2.order_case, nv = "
        f"1 and 20) every variant bit for bit its plain version and its "
        f"rerun")
    return res


def phase_k2probe(sheets, device):
    """Phase 13: the dest-small probe (tools/probe_k2) on each sheet's EvI,
    through phase_probe."""
    from icebin_tpu_torch.tools import probe_k2
    return phase_probe(probe_k2, "K2", "EvI", "small", K2PROBE_SITES,
                       k2_split, sheets, device)


def phase_k1probe(sheets, device):
    """Phase 14: the dest-ice probe (tools/probe_k1) on each sheet's IvE,
    through phase_probe."""
    from icebin_tpu_torch.tools import probe_k1
    return phase_probe(probe_k1, "K1", "IvE", "ice", K1PROBE_SITES,
                       k1_split, sheets, device)


# -- phase 15: the fold and capacity probes --------------------------------

FOLD_BLOCKS = (1, 64, 16384, 64800)   # 16,384: 33.5 MB f32, inside the L2;
                                      # 64,800: one tile per Greenland E row
SMEMFOLD_SITES = {   # kernel: (its source, its TPU site)
    "fold_tiles": ("foldprobe.cu", "tools/probe_fold_ops.py:16"),
    "smem_copy_block": ("smemprobe.cu", "tools/probe_vmem.py:32"),
    "smem_copy_cluster": ("smemprobe.cu", "tools/probe_vmem.py:32"),
}


def phase_smemfold(device):
    """Phase 15: the fold probe (tools/probe_fold_ops) at FOLD_BLOCKS and
    the capacity probe (tools/probe_vmem), through their run functions.
    Returns {kernel: its JSON row's numbers}: fold_tiles at the f64 V1 fold
    of 64,800 tiles by its faster route (the stage-2 dest-small kernel's
    question), launches summed and max_abs_err the worst over every case;
    smem_copy_block at its largest n; smem_copy_cluster at the largest
    cluster, launches summed over the cluster sizes."""
    from icebin_tpu_torch.ops.foldprobe import FOLDS
    from icebin_tpu_torch.tools import probe_fold_ops, probe_vmem
    cases = probe_fold_ops.run_cases(FOLD_BLOCKS, device)
    by = {}
    for c in cases:
        tag = f"{c['fold']} {c['route']} {c['dtype']} B={c['blocks']}"
        by[(c["fold"], c["route"], c["dtype"], c["blocks"])] = c
        say(f"smemfold: fold_tiles {tag} ({c['MB']:.3f} MB in + out) "
            f"{c['ms']:.4f} ms = {c['MB'] / c['ms']:.1f} GB/s, bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}), plain "
            f"{c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} ms; bit "
            f"for bit plain {c['equals_plain']}, library "
            f"{c['equals_library']}, rerun {c['rerun_identical']}; launches "
            f"in the timed calls {c['launches']}")
        check(c["equals_plain"] and c["equals_library"],
              f"fold_tiles {tag} differs from its plain version")
        check(c["rerun_identical"], f"fold_tiles {tag} rerun differs")
        check(c["launches"] > 0, f"fold_tiles {tag} was not launched")
    for fold in FOLDS:               # each route's own cost, by depth
        for dtype in probe_fold_ops.DTYPES:
            diff = [1e3 * (by[(fold, "shfl", dtype, B)]["ms"]
                           - by[(fold, "smem", dtype, B)]["ms"])
                    for B in FOLD_BLOCKS]
            say(f"smemfold: {fold} {dtype}, shfl - smem (us): " + ", ".join(
                f"B={B} {d:+.2f}" for B, d in zip(FOLD_BLOCKS, diff)))
    for what, value in probe_fold_ops.semantic_checks(device).items():
        say(f"smemfold: {what}: {value}")
        check(value == (what != "slice+concat matches row-major fold"),
              f"fold probe check '{what}' gave {value}")
    deep = FOLD_BLOCKS[-1]
    best = min((by[("v1_fold", r, "f64", deep)] for r in ("smem", "shfl")),
               key=lambda c: c["ms"])
    res = {"fold_tiles": dict(
        {k: best[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
        param=f"v1_fold {best['route']} f64 B={deep}",
        launches=sum(c["launches"] for c in cases),
        max_abs_err=max(c["max_abs_err"] for c in cases))}
    found = probe_vmem.run(device)
    for r in found:
        tag = ("one block" if r["scope"] == "block"
               else f"a cluster of {r['cluster']}")
        say(f"smemfold: smem_copy in {tag}: largest n {r['rows']} rows = "
            f"{r['rows']} KB in + out ({r['per_block_kb']} KB a block), "
            f"occupancy {r['occupancy']}; {r['refused_rows']} rows refused "
            f"({r['refusal']}, occupancy {r['refusal_occupancy']}); staging "
            f"budget (80%) {r['budget_kb']} KB; {r['attempts']} sizes tried; "
            f"at n: {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms, plain "
            f"{r['plain_ms']:.4f} ms, torch.mul {r['library_ms']:.4f} ms, "
            f"bit for bit x * 2.0 {r['equals_plain']}, launches "
            f"{r['launches']}")
        check(r["equals_plain"], f"smem_copy in {tag} differs from x * 2.0")
        check(r["launches"] > 0, f"smem_copy in {tag} was not launched")
    cl = [r for r in found if r["scope"] == "cluster"]
    for name, r, launches, worst in (
            ("smem_copy_block", found[0], found[0]["launches"],
             found[0]["max_abs_err"]),
            ("smem_copy_cluster", cl[-1], sum(c["launches"] for c in cl),
             max(c["max_abs_err"] for c in cl))):
        res[name] = dict(
            {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
            param=(f"n={r['rows']}" if r["scope"] == "block"
                   else f"C={r['cluster']}, n={r['rows']}"),
            launches=launches,
            max_abs_err=worst)
    return res


def check_clip_build(log):
    """Each clip instance's registers, stack frame and spills from the
    build log (nvcc -Xptxas -v); fails if a stage-2 instance
    (clip_stream_kernel<V0, VC, min blocks, route>; VC 0: rectangles) has
    a stack frame or spills."""
    import re
    stats, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?"
                      r"(clip_(?:stream|rect|poly)_kernel)I((?:Li\d+E)+)",
                      line)
        if m:
            name = (m.group(1), tuple(map(int, re.findall(r"\d+",
                                                          m.group(2)))))
            stats[name] = {}
        elif name and "stack frame" in line:
            st, ss, sl = map(int, re.findall(r"(\d+) bytes", line))
            stats[name].update(stack=st, spill_stores=ss, spill_loads=sl)
        elif name and "registers" in line:
            stats[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            name = None
    check(any(k[0] == "clip_stream_kernel" for k in stats),
          "the build log lists no clip instance")
    for (kern, args), st in sorted(stats.items()):
        say(f"clip build: {kern}<{', '.join(map(str, args))}> {st}")
        check(kern != "clip_stream_kernel"
              or (st.get("stack", 1) == 0 and st.get("spill_stores", 1) == 0
                  and st.get("spill_loads", 1) == 0),
              f"stage-2 clip instance {kern}<{args}> has a stack frame or "
              f"spills: {st}")


# -- phase 16: the mesh -------------------------------------------------------

MESH_WORLDS = ((1, "nccl"), (2, "gloo"))
MESH_H_TOL = dict(rtol=2e-5, atol=2e-4)      # tests/test_mesh_coupler.py
MESH_FE_TOL = dict(rtol=5e-4, atol=5e-3)     # :111-116
MESH_STEPS = 18       # steps timed as a run takes them (the first 6 checked)
MESH_TRACED = 6       # more steps, with the mesh's synchronised timers on


def plain_median(ms):
    """Median of the steps without a regeneration, the first (warm-up)
    left out."""
    return float(np.median([m for i, m in enumerate(ms)
                            if i and (i + 1) % REGEN]))


def mesh_rank(mesh, specA, specI, xg_ref, dryrun):
    """One rank of phase 16 (run by parallel.distributed.launch): the
    sharded build against phase 3's, then the mesh coupler's steps, each
    path with the launch counters set to 0 just before it and read just
    after (the coupler's after the 2 * REGEN checked steps).  Steps are
    timed with the mesh's timers off (a device sync after each step, as
    the single-device steps); then MESH_TRACED more with them on, which
    synchronise around every halo and collective to split the step.  With
    ``dryrun``, parallel/dryrun.py on this mesh."""
    import torch
    from icebin_tpu_torch import CouplerConfig, GCMCoupler, GCMRegridder
    from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_dest_small
    from icebin_tpu_torch.ops.clip import clip_areas_centroids
    from icebin_tpu_torch.parallel.build import sharded_exchange_grid
    from icebin_tpu_torch.parallel.dryrun import run_dryrun
    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mesh.timing = False
    out = {"device": str(dev)}
    for k in (clip_areas_centroids, spmm_dest_ice, spmm_dest_small):
        k.launches = 0
    sync()
    t = time.perf_counter()
    xg = sharded_exchange_grid(mesh, specA, specI, subdiv=2)
    sync()
    out["build_ms"] = 1e3 * (time.perf_counter() - t)
    out["build_launches"] = clip_areas_centroids.launches
    out["build_same"] = {k: bool(np.array_equal(getattr(xg, k), xg_ref[k]))
                         for k in xg_ref}

    gr = GCMRegridder(specA, HCDEFS, device=dev)
    gr.add_sheet("greenland", specI, exchange=xg)
    for k in (spmm_dest_ice, spmm_dest_small):
        k.launches = 0
    t = time.perf_counter()
    cp = GCMCoupler(gr, CouplerConfig(dt=DT, regen_every=REGEN), mesh=mesh)
    out["init_ms"] = 1e3 * (time.perf_counter() - t)
    sc = cp.sheets["greenland"]
    steps, traced = [], []
    for k in range(MESH_STEPS + MESH_TRACED):
        mesh.timing = k >= MESH_STEPS
        fE = torch.as_tensor(forcing(gr.nE, seed=k), device=dev)
        ms0, calls0 = dict(mesh.ms), dict(mesh.calls)
        sync()
        t = time.perf_counter()
        res = cp.couple({"greenland": fE})["greenland"]
        sync()
        ms = 1e3 * (time.perf_counter() - t)
        if k < MESH_STEPS:
            steps.append(ms)
        else:
            traced.append({"ms": ms,
                           **{f"{key}_ms": mesh.ms[key] - ms0[key]
                              for key in mesh.ms},
                           **{f"{key}_calls": mesh.calls[key] - calls0[key]
                              for key in mesh.calls}})
        if k + 1 == 2 * REGEN:
            out["launches"] = {c.__name__: c.launches for c in (
                spmm_dest_ice, spmm_dest_small)}
            out.update(rows=cp.ledger.to_rows(),
                       H=sc.gathered_state().H.cpu().numpy(),
                       fE_out=res["fE_out"].cpu().numpy(),
                       finite=bool(torch.isfinite(sc.state.H).all()))
    mesh.timing = False
    out.update(steps=steps, traced=traced)
    if dryrun:
        t = time.perf_counter()
        out["dryrun"] = run_dryrun(mesh)
        out["dryrun"]["ms"] = 1e3 * (time.perf_counter() - t)
    return out


def phase_mesh(specA, specI, xg, device, step_ms):
    """Phase 16: the mesh at world sizes 1 (NCCL) and 2 (gloo on one
    card) against phase 3's build and the single-device coupler."""
    import torch
    from icebin_tpu_torch import CouplerConfig, GCMCoupler, GCMRegridder
    from icebin_tpu_torch.parallel.distributed import launch
    t16 = time.perf_counter()
    gr = GCMRegridder(specA, HCDEFS, device=device)
    gr.add_sheet("greenland", specI, exchange=xg)
    cp = GCMCoupler(gr, CouplerConfig(dt=DT, regen_every=REGEN),
                    device=device)
    one = []
    for k in range(MESH_STEPS):
        fE = torch.as_tensor(forcing(gr.nE, seed=k), device=device)
        res, ms = wall_ms(lambda: cp.couple({"greenland": fE})["greenland"])
        one.append(ms)
        if k + 1 == 2 * REGEN:
            H1 = cp.sheets["greenland"].state.H.cpu().numpy()
            e1 = res["fE_out"].cpu().numpy()
            rows1 = cp.ledger.to_rows()
    one_ms = plain_median(one)
    xg_ref = {k: getattr(xg, k) for k in ("iA", "iI", "area", "centroid")}
    say(f"mesh: single-device coupler on the same forcing, {MESH_STEPS} "
        f"steps, median step {one_ms:.3f} ms (steps without regeneration, "
        f"the first left out; phase 3's median {step_ms:.3f})")
    out = {}
    for n, backend in MESH_WORLDS:
        t = time.perf_counter()
        ranks = launch(mesh_rank, n, backend=backend, device=device.type,
                       args=(specA, specI, xg_ref, n == 1), timeout=300.0)
        say(f"mesh {n} x {backend}: launch of {n} rank process(es) took "
            f"{time.perf_counter() - t:.1f} s")
        for r, rk in enumerate(ranks):
            tag = f"mesh {n} x {backend} rank {r} ({rk['device']})"
            check(all(rk["build_same"].values()),
                  f"{tag}: sharded build differs from phase 3's: "
                  f"{rk['build_same']}")
            check(rk["build_launches"] > 0, f"{tag}: K3 was not launched")
            for name, c in rk["launches"].items():
                check(c > 0, f"{tag}: kernel {name} was not launched")
            check(rk["rows"] == ranks[0]["rows"],
                  f"{tag}: ledger differs from rank 0's")
            worst = max(abs(row["greenland.mass_in_E"]
                            - row["greenland.mass_delivered_I"])
                        / abs(row["greenland.mass_in_E"])
                        for row in rk["rows"])
            check(worst < TRANSPORT_TOL, f"{tag}: transport {worst:.3e}")
            check(rk["finite"], f"{tag}: non-finite ice state")
            dH = np.abs(rk["H"] - H1)
            okH = bool(np.all(dH <= MESH_H_TOL["atol"]
                              + MESH_H_TOL["rtol"] * np.abs(H1)))
            fin = np.isfinite(e1)
            check(np.array_equal(np.isfinite(rk["fE_out"]), fin),
                  f"{tag}: fE_out's finite cells differ")
            dE = np.abs(rk["fE_out"][fin] - e1[fin])
            okE = bool(np.all(dE <= MESH_FE_TOL["atol"]
                              + MESH_FE_TOL["rtol"] * np.abs(e1[fin])))
            say(f"{tag}: sharded build {rk['build_ms']:.1f} ms bit for bit "
                f"phase 3's ({rk['build_launches']} K3 launches); coupler "
                f"init {rk['init_ms']:.1f} ms; launches in "
                f"{2 * REGEN} steps {rk['launches']}; max |H - single| "
                f"{dH.max():.3e} m, max |fE_out - single| {dE.max():.3e}; "
                f"transport {worst:.3e}")
            check(okH, f"{tag}: H outside {MESH_H_TOL} of single-device")
            check(okE, f"{tag}: fE_out outside {MESH_FE_TOL}")
            if n == 1:
                check(np.array_equal(rk["H"], H1)
                      and np.array_equal(rk["fE_out"], e1, equal_nan=True)
                      and rk["rows"] == rows1,
                      f"{tag}: H, fE_out or the ledger not bit for bit "
                      f"the single-device coupler's")
                say(f"{tag}: H, fE_out and the ledger bit for bit the "
                    f"single-device coupler's")
            say(f"{tag}: step ms, timers off: "
                + ", ".join(f"{m:.2f}" for m in rk["steps"]))
            for i, st in enumerate(rk["traced"]):
                k = MESH_STEPS + i + 1
                say(f"{tag} step {k} (timers on): {st['ms']:.2f} ms, halo "
                    f"{st['halo_ms']:.2f} ms, collectives {st['coll_ms']:.2f}"
                    f" ms, host staging {st['stage_ms']:.2f} ms, substeps "
                    f"{st['max_calls']}, gathers {st['gather_calls']}, "
                    f"exchanges {st['exchange_calls']}"
                    + (" (regeneration)" if k % REGEN == 0 else ""))
            if "dryrun" in rk:
                say(f"{tag}: parallel/dryrun.py {rk['dryrun']}")
        rk = ranks[0]
        traced = [st for i, st in enumerate(rk["traced"])
                  if (MESH_STEPS + i + 1) % REGEN]
        prod = plain_median(rk["steps"])
        out[f"{n}x{backend}"] = prod
        say(f"mesh {n} x {backend}: median step {prod:.3f} ms with the "
            f"timers off (rank 0, {MESH_STEPS} steps, without regeneration, "
            f"the first left out) vs single-device {one_ms:.3f} ms; with "
            f"the timers on {np.median([st['ms'] for st in traced]):.3f} ms"
            f", of which halo "
            f"{np.median([st['halo_ms'] for st in traced]):.3f}, "
            f"collectives {np.median([st['coll_ms'] for st in traced]):.3f}"
            f", staging {np.median([st['stage_ms'] for st in traced]):.3f}"
            f" ms (medians of {len(traced)} steps)")
    say(f"mesh: phase 16 took {time.perf_counter() - t16:.1f} s")
    return out


# -- phase 17: the ModelE input toolchain ------------------------------------

TOPO_BASE = (1440, 720)   # synthetic_z1qx1n's 1/4-degree base
TOPO_OCEAN = (288, 180)   # ModelE's ocean grid O under the 144 x 90 A grid
TOPO_NV = 16
TOPO_STEPS = 3            # the example twin's coupling steps
TOPO_RES_KM = 5.0         # config #3's lattice (the SeaRISE file, the twin)


def quiet(main, argv):
    """A CLI's ``main(argv)``, its printed lines kept; (rc, lines, ms)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, ms = wall_ms(lambda: main(argv))
    return rc, buf.getvalue().strip().splitlines(), ms


def check_mismatched(rm, device):
    """GCMRegridderModelE's AvI/EvI/IvA/IvE: the conservation identity on
    the host; EvI and AvI through K2, IvE and IvA through K1 at TOPO_NV
    fields against their plain versions (one f32 ulp) and the f64
    ``WeightedMatrix.apply`` (raw error < RAW_TOL), each timed after its
    one launch on the path.  Returns the EvI pack's CSR and field (for
    the Roofline) and the path's launches by kernel."""
    import torch
    from icebin_tpu_torch.ops.apply import (spmm_dest_ice, spmm_dest_small,
                                            spmm_ref)
    from icebin_tpu_torch.ops.csr import csr_pack
    from icebin_tpu_torch.regrid.matrices import RegridParams
    rng = np.random.default_rng(17)
    params = RegridParams()
    keep, path = None, {}
    for name in ("EvI", "AvI", "IvE", "IvA"):
        M = rm.matrix(name, params)
        x = rng.uniform(1.0, 2.0, M.shape[1])
        out = M.apply(x)
        lhs = np.sum(np.where(np.isfinite(out), out, 0.0) * M.wM)
        rel = abs(lhs - np.sum(x * M.Mw)) / abs(np.sum(x * M.Mw))
        ice = name.startswith("I")
        kern = spmm_dest_ice if ice else spmm_dest_small
        pack = csr_pack(M, small_axis="cols" if ice else "rows", nv=TOPO_NV,
                        device=device)
        csr = pack.ice if ice else pack.small
        f = (260.0 + 30.0 * rng.uniform(size=(M.shape[1], TOPO_NV))
             ).astype(np.float32)
        xt = torch.as_tensor(f, device=device)
        n0 = kern.launches
        got = kern(csr, xt)
        launched = kern.launches - n0
        path[kern.__name__] = path.get(kern.__name__, 0) + launched
        plain = spmm_ref(csr, xt)
        torch.cuda.synchronize()
        ulp = torch.finfo(torch.float32).eps * plain.abs()
        d_plain = float((got - plain).abs().max())
        want = M.apply(f.astype(np.float64).T, fill=np.nan).T
        live = M.wM > 0
        g = got.cpu().numpy().astype(np.float64)
        raw = (np.abs(g[live] - want[live]).max()
               / np.abs(want[live]).max())
        ms = time_ms(lambda: kern(csr, xt), 50)
        plain_ms = time_ms(lambda: spmm_ref(csr, xt), 10)
        say(f"topo: mismatched {name} {M.shape[0]} x {M.shape[1]}, {M.nnz} "
            f"nnz: conservation {rel:.3e} (limit 1e-12); "
            f"{kern.__name__} ({launched} launch) raw error vs "
            f"WeightedMatrix.apply {raw:.3e} (limit {RAW_TOL:g}), max "
            f"|kernel - plain| {d_plain:.3e}; {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        check(rel < 1e-12, f"mismatched {name} conservation {rel:.3e}")
        check(launched == 1, f"mismatched {name}: {launched} launches")
        check(bool(((got - plain).abs() <= ulp).all()),
              f"mismatched {name}: {kern.__name__} vs plain {d_plain:.3e}")
        check(raw < RAW_TOL, f"mismatched {name} raw error {raw:.3e}")
        if name == "EvI":
            keep = (csr, xt)
    return keep, path


def phase_topo(device, counters):
    """Phase 17 (module docstring); every launch counter set to 0 just
    before and read just after."""
    import importlib.util
    import torch
    from scipy.io import netcdf_file
    from icebin_tpu_torch import GCMRegridder
    from icebin_tpu_torch.cli import giss2nc, global_ec, make_topoo
    from icebin_tpu_torch.grid import (make_exchange_grid_host,
                                       modele_lonlat_grid)
    from icebin_tpu_torch.io import (read_searise, write_synthetic_searise,
                                     write_z1qx1n)
    from icebin_tpu_torch.io.ncio import write_gcmregridder
    from icebin_tpu_torch.io.zarray import decode_zarray
    from icebin_tpu_torch.grid import clip_pairs
    from icebin_tpu_torch.ops.apply import spmm_dest_small
    from icebin_tpu_torch.ops.clip import (clip_areas_centroids,
                                           clip_areas_centroids_ref,
                                           recentre_pairs)
    from icebin_tpu_torch.regrid.hntr import hntr_matrix, hntr_spec
    from icebin_tpu_torch.regrid.matrices import RegridParams
    from icebin_tpu_torch.regrid.modele import GCMRegridderModelE
    from icebin_tpu_torch.topo.topo import (FRACTION_FIELDS,
                                            synthetic_z1qx1n)
    from icebin_tpu_torch.utils.profiling import Roofline, csr_apply_bytes

    t_phase = time.perf_counter()
    for k in counters:
        k.launches = 0
    stage = {}
    path = dict.fromkeys((k.__name__ for k in counters), 0)

    def add(before):
        """Book the launches since ``before`` (counts by kernel) as the
        path's."""
        for k in counters:
            path[k.__name__] += k.launches - before[k.__name__]

    def now():
        return {k.__name__: k.launches for k in counters}
    dev = ["--device", str(device)]
    specA, specG = greenland_specs(TOPO_RES_KM)
    with tempfile.TemporaryDirectory() as d:
        p = lambda f: os.path.join(d, f)

        # 1. the SeaRISE file of config #3's lattice
        (truth, sr), stage["searise"] = wall_ms(lambda: (
            write_synthetic_searise(p("greenland.nc"), nx=specG.nx,
                                    ny=specG.ny, dx=1e3 * TOPO_RES_KM),
            read_searise(p("greenland.nc"))))
        specI, elev = sr.spec, sr.elevmask()
        same_lattice = (specI.shape == specG.shape
                        and np.abs(specI.xb - specG.xb).max() < 1e-6
                        and np.abs(specI.yb - specG.yb).max() < 1e-6
                        and specI.projection.to_proj4()
                        == specG.projection.to_proj4())
        say(f"topo: SeaRISE file {specI.nx} x {specI.ny}, "
            f"{int(np.isfinite(elev).sum())} iced cells, config #3's "
            f"lattice {same_lattice}")
        check(same_lattice, "the SeaRISE file is not config #3's lattice")
        check(np.array_equal(sr.thk, truth.thk)
              and np.array_equal(sr.usrf, truth.usrf),
              "SeaRISE fields do not read back")

        # 2. the TOPO base as a GISS file, giss2nc, make_topoo onto O
        specO = hntr_spec(*TOPO_OCEAN)
        AvO = hntr_matrix(specA, specO)
        nests = bool((np.bincount(AvO.cols, minlength=specO.ncells)
                      == 1).all())
        check(nests, "the ocean grid does not nest in ModelE 2x2.5")
        base, ms = wall_ms(lambda: synthetic_z1qx1n(hntr_spec(*TOPO_BASE)))
        stage["base"] = ms
        _, stage["write_z1qx1n"] = wall_ms(
            lambda: write_z1qx1n(p("base.giss"), base))
        rc, lines, stage["giss2nc"] = quiet(
            giss2nc.main, [p("base.giss"), p("base.nc")])
        check(rc == 0, f"giss2nc returned {rc}")
        with netcdf_file(p("base.nc"), "r", mmap=False) as nc:
            trip = all(np.array_equal(
                np.array(nc.variables[k.upper()][:]).reshape(-1),
                np.asarray(getattr(base, k), np.float32))
                for k in FRACTION_FIELDS + ("zatmo",))
        say(f"topo: {lines[-1]}; values round-trip bit for bit {trip}")
        check(trip, "giss2nc did not round-trip the base")
        rc, lines, stage["make_topoo"] = quiet(make_topoo.main, [
            "--base", p("base.giss"), "--om", "x".join(map(str, TOPO_OCEAN)),
            "--out", p("topoo.nc")] + dev)
        check(rc == 0, f"make_topoo returned {rc}")
        topoo = make_topoo.read_topo(p("topoo.nc")).check()
        say(f"topo: {lines[-1]}; O nests in ModelE 2x2.5 {nests}")

        # 3. the O-level exchange grid through K3 on the card
        grO = GCMRegridder(specO, HCDEFS, device=device)
        before = now()
        _, stage["exchange O (K3)"] = wall_ms(
            lambda: grO.add_sheet("greenland", specI, subdiv=2))
        add(before)
        check(path["clip_areas_centroids"] > 0,
              "the O-level build launched no clip kernel")
        xo, stage["exchange O (f64 host)"] = wall_ms(
            lambda: make_exchange_grid_host(specO, specI, subdiv=2))
        compare_exchange(grO.sheets["greenland"].exchange, xo, specI,
                         tag="topo: O-level exchange")
        # K3 on the O-level pairs against its plain version, timed
        _, pairI, subj, rect = clip_pairs(specO, specI, subdiv=2)
        pq, rq, _ = recentre_pairs(subj, rect)
        pq, rq = (torch.as_tensor(a, device=device) for a in (pq, rq))
        a, _ = clip_areas_centroids(pq, rq)
        a_ref, _ = clip_areas_centroids_ref(pq, rq)
        cell = torch.as_tensor(specI.cell_areas()[pairI], device=device)
        err = ((a.double() - a_ref.double()).abs() / cell).max().item()
        k3_ms = time_ms(lambda: clip_areas_centroids(pq, rq), 20)
        k3_plain = time_ms(lambda: clip_areas_centroids_ref(pq, rq), 3)
        k3_bound, k3_by = clip_bound(pq, rq)
        say(f"topo: K3 on the O-level build's {pq.shape[0]} pairs: max "
            f"|area - plain| / cell area {err:.3e} (limit 1e-5); {k3_ms:.4f} "
            f"ms, plain {k3_plain:.4f} ms, bound {k3_bound:.4f} ms ({k3_by})")
        check(err < 1e-5, f"O-level clip areas off the plain version {err}")

        # 4. the mismatched regridder: conservation, K1 and K2
        foceanOp = topoo.focean
        mm, stage["GCMRegridderModelE"] = wall_ms(
            lambda: GCMRegridderModelE(grO, specA, foceanOp,
                                       np.round(foceanOp)))
        rm = mm.regrid_matrices("greenland", elev)
        (csr, xt), once = check_mismatched(rm, device)
        for name, n in once.items():
            path[name] += n
        say(f"topo: sAm in [{mm.sAm.min():.4f}, {mm.sAm.max():.4f}], "
            f"{int((mm.sAm != 1.0).sum())} A cells rescaled")

        # 5. global_ec and make_topoo --merge on the regridder file
        write_gcmregridder(p("grO.nc"), grO)
        np.save(p("elev.npy"), elev)
        names = ("AvI", "IvA", "EvI", "IvE", "AvE", "EvA")
        rc, lines, stage["global_ec"] = quiet(global_ec.main, [
            p("grO.nc"), p("ec.nc"), "--elevmask",
            f"greenland={p('elev.npy')}"] + dev)
        check(rc == 0, f"global_ec returned {rc}")
        rmO = grO.regrid_matrices("greenland", elev)
        with netcdf_file(p("ec.nc"), "r", mmap=False) as nc:
            for name in names:
                M = rmO.matrix(name, RegridParams(scale=True, correctA=True))
                key = f"greenland.{name}"
                r, c, v = decode_zarray(
                    np.array(nc.variables[f"{key}.zarray"][:]).tobytes())
                shape = (int(getattr(nc, f"{key}_nrow")),
                         int(getattr(nc, f"{key}_ncol")))
                check(shape == tuple(M.shape) and np.array_equal(r, M.rows)
                      and np.array_equal(c, M.cols)
                      and np.array_equal(v, M.vals),
                      f"global_ec's {name} is not rm.matrix({name!r})")
        say(f"topo: {lines[-1]}; every blob bit for bit its matrix")
        rc, lines, stage["make_topoo --merge"] = quiet(make_topoo.main, [
            "--base", p("base.giss"), "--om", "x".join(map(str, TOPO_OCEAN)),
            "--out", p("merged.nc"), "--regridder", p("grO.nc"),
            "--elevmask", f"greenland={p('elev.npy')}", "--merge"] + dev)
        check(rc == 0, f"make_topoo --merge returned {rc}")
        merged = make_topoo.read_topo(p("merged.nc"))
        s = sum(getattr(merged, k) for k in FRACTION_FIELDS)
        under = rmO.matrix("AvI", RegridParams()).wM > 0
        moved = merged.fgice != topoo.fgice
        say(f"topo: {lines[-1]}; max |sum of fractions - 1| "
            f"{np.abs(s - 1).max():.3e}, FGICE changed in {int(moved.sum())} "
            f"of the sheet's {int(under.sum())} O cells, outside it in "
            f"{int((moved & ~under).sum())}")
        check(np.abs(s - 1).max() < 1e-6, "merged fractions do not sum to 1")
        check(moved.any() and not (moved & ~under).any(),
              "FGICE changed outside the sheet's footprint")

        # 6. the coupled Greenland example's twin
        spec = importlib.util.spec_from_file_location(
            "coupled_greenland_torch", os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "examples",
                "coupled_greenland_torch.py"))
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        # the plot needs matplotlib, which a machine may not have: then
        # the twin runs without --plot (tests/test_torch_topo.py draws it)
        plot = importlib.util.find_spec("matplotlib") is not None
        before = now()
        rows, lines, stage["example"] = quiet(example.main, [
            "--res-km", f"{TOPO_RES_KM:g}", "--steps", str(TOPO_STEPS),
            "--out", p("demo")] + ["--plot"] * plot + dev)
        n1, n2 = (counters[k].launches - before[counters[k].__name__]
                  for k in (1, 2))
        add(before)
        worst = max(abs(r["greenland.mass_in_E"]
                        - r["greenland.mass_delivered_I"])
                    / abs(r["greenland.mass_in_E"]) for r in rows)
        png = p("demo/demo.png")
        size = os.path.getsize(png) if os.path.exists(png) else 0
        done = [s for s in lines if s.startswith("done:")]
        say(f"topo: example twin at {TOPO_RES_KM:g} km: {done}; transport "
            f"{worst:.3e} (limit {TRANSPORT_TOL:g}), K1 {n1} and K2 {n2} "
            f"launches, " + (f"plot {size} bytes" if plot else
                             "no plot: matplotlib is not installed here"))
        check(len(rows) == TOPO_STEPS and worst < TRANSPORT_TOL,
              f"example transport {worst:.3e}")
        check(n1 > 0 and n2 > 0, "the example launched no K1 or K2")
        check(size > 0 or not plot, "the example wrote no plot")

        # 7. a Roofline of the K2 apply
        roof = Roofline()
        nbytes = csr_apply_bytes(csr, TOPO_NV)
        spmm_dest_small(csr, xt)
        for _ in range(20):
            with roof.measure("K2 EvI (mismatched)", bytes=nbytes):
                spmm_dest_small(csr, xt)
                torch.cuda.synchronize()
        for line in roof.report().splitlines():
            say(f"topo: {line}")

    launches = now()
    say(f"topo: stage wall ms " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in stage.items()))
    say(f"topo: launches on phase 17's path {path} (the O-level build, "
        f"each mismatched matrix once, the example twin); with the timed "
        f"and compared runs {launches}")
    for name, n in path.items():
        check(n > 0, f"kernel {name} was not launched by phase 17's path")
    say(f"topo: phase 17 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 18: the compiled step ---------------------------------------------

COMPILED_REGEN = 5        # phase 18's regeneration period at config #3:
                          # steps 2-4 and 7-9 of 10 neither capture nor
                          # regenerate, the medians' samples
CFL_DT = 365.2425 * 86400.0   # a 1-year step: dt_max (0.1 year) binds, so
                              # the SIA takes 10 substeps


def eager(cp):
    """``cp`` with every sheet on the eager step: a plain wrapper of the SIA
    step is not fusible, so ``couple`` runs ``_couple_core`` with the early
    exit (the comparison run)."""
    from icebin_tpu_torch.models.ice_sheet import step_coupled

    def ice(*a):
        return step_coupled(*a)
    for sc in cp.sheets.values():
        sc.ice_step = ice
    return cp


def same_results(oa, ob, a, b, what):
    """Each sheet's outputs and state of the compiled coupler ``a`` bit for
    bit the eager ``b``'s."""
    import torch
    for name in a.sheets:
        for key in ("fI", "fE_out", "fA_out"):
            check(same(oa[name][key], ob[name][key]),
                  f"{what}: {name} {key} is not the eager step's")
        for key in ("H", "enth", "t"):
            check(torch.equal(getattr(a.sheets[name].state, key),
                              getattr(b.sheets[name].state, key)),
                  f"{what}: {name} state {key} is not the eager step's")


def compiled_pair(gr, device, held=None, **kw):
    """A compiled and an eager GCMCoupler on ``gr`` with one config and
    the same held EC state."""
    from icebin_tpu_torch import CouplerConfig, GCMCoupler
    cfg = CouplerConfig(**{"dt": DT, **kw})
    a = GCMCoupler(gr, cfg, device=device)
    b = eager(GCMCoupler(gr, cfg, device=device))
    if held is not None:
        for cp in (a, b):
            for sc in cp.sheets.values():
                sc.set_held_state(held)
    return a, b


def drive_pair(a, b, steps, window, device, tag):
    """``steps`` stepwise steps of the compiled ``a`` and the eager ``b``
    (timed one by one, a then b), each bit for bit; then a fused run of
    ``window`` steps of a beside the same steps of b stepwise; the ledgers
    equal row for row.  Returns the step ms of a and b over the steps that
    neither captured nor regenerated, and the fused and stepwise ms."""
    import torch
    nE, first = a.gr.nE, next(iter(a.sheets))
    ms = ([], [])
    for k in range(steps):
        fE = torch.as_tensor(forcing(nE, seed=k), device=device)
        sc = a.sheets[first]
        n_cap, gen = len(sc.capture_ms), sc._gen
        oa, ta = wall_ms(lambda: a.couple({n: fE for n in a.sheets}))
        ob, tb = wall_ms(lambda: b.couple({n: fE for n in b.sheets}))
        if len(sc.capture_ms) == n_cap and sc._gen == gen:
            ms[0].append(ta)
            ms[1].append(tb)
        same_results(oa, ob, a, b, f"{tag} step {k}")
    fn = lambda t, s: torch.as_tensor(forcing(nE, seed=int(t // a.cfg.dt)),
                                      device=device)
    oa, fa = wall_ms(lambda: a.run_transient(fn, window, fused=True))
    ob, fb = wall_ms(lambda: b.run_transient(fn, window))
    same_results(oa, ob, a, b, f"{tag} fused window")
    rows = a.ledger.to_rows()
    check(rows == b.ledger.to_rows(),
          f"{tag}: the ledger rows are not the eager step's bit for bit")
    check(len(rows) == steps + window, f"{tag}: {len(rows)} ledger rows")
    check_ledger(rows, a.sheets, tag)
    return ms, fa, fb


def graph_stats(cp):
    return {name: {"replays": sc.replays, "reruns": sc.reruns,
                   "budget": sc.budget, "rebinds": sc.rebinds,
                   "capture_ms": [round(m, 1) for m in sc.capture_ms]}
            for name, sc in cp.sheets.items()}


def phase_compiled(gr3, gr5, device):
    """Phase 18 (docstring at the top)."""
    import torch
    from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_dest_small
    from icebin_tpu_torch.ops.books import (books_repair, books_stats,
                                            books_sum)
    t_phase = time.perf_counter()
    med = lambda x: float(np.median(x)) if x else float("nan")

    # config #3: 10 stepwise steps and a fused window of 5, regenerating
    # every 5 (3 regenerations, each rebinding the kept graph)
    held = np.random.default_rng(1).uniform(0.5, 2.0, (2, gr3.nE))
    a, b = compiled_pair(gr3, device, held, regen_every=COMPILED_REGEN)
    (ms_a, ms_b), fused_a, fused_b = drive_pair(
        a, b, 2 * COMPILED_REGEN, COMPILED_REGEN, device, "compiled #3")
    sa = a.sheets["greenland"]
    say(f"compiled #3: step {med(ms_a):.3f} ms compiled, {med(ms_b):.3f} "
        f"eager (medians of {len(ms_a)} steps that neither capture nor "
        f"regenerate: {', '.join(f'{m:.3f}' for m in ms_a)} and "
        f"{', '.join(f'{m:.3f}' for m in ms_b)}); fused window of "
        f"{COMPILED_REGEN} {fused_a:.1f} ms, the same steps eager and "
        f"stepwise {fused_b:.1f} ms (each with its closing regeneration); "
        f"{graph_stats(a)}")
    check(sa.replays > 0, "config #3 ran no graph replay")
    check(sa._gen >= 4 and sa.rebinds == sa._gen - 1
          and len(sa.capture_ms) == len(sa._graphs),
          f"{sa._gen - 1} regenerations, {sa.rebinds} rebinds, "
          f"{len(sa.capture_ms)} captures of {len(sa._graphs)} budgets")

    # one steady step profiled on each (after one that captures), with the
    # regrid kernels' launches counted around it
    fE = torch.as_tensor(forcing(gr3.nE, seed=20), device=device)
    oa, ob = (cp.couple({"greenland": fE}) for cp in (a, b))
    same_results(oa, ob, a, b, "compiled #3 after the window")
    counts = []
    kerns = (spmm_dest_ice, spmm_dest_small, books_sum, books_repair,
             books_stats)
    for cp, ms, tag in ((a, ms_a, "compiled"), (b, ms_b, "eager")):
        before = [k.launches for k in kerns]
        phase_profile(cp, med(ms), device, n=1, tag=f"{tag} #3 profile")
        counts.append([k.launches - n for k, n in zip(kerns, before)])
    say(f"compiled #3: K1 and K2 launches in the profiled step "
        f"{counts[0][:2]} compiled (counted per replay), {counts[1][:2]} "
        f"eager; the books' (books_reduce_kernel: books_sum, books_repair; "
        f"books_stats_kernel) {counts[0][2:]} a replay, "
        f"{counts[1][2:]} eager, {sum(counts[0][2:])} in all")
    check(counts[0] == counts[1] and min(counts[0]) > 0,
          "a replay's launch counts are not the eager step's")
    check(sum(counts[0][2:]) <= BOOKS_LAUNCHES,
          f"the books launch {sum(counts[0][2:])} times a replay and sheet")

    # a fused window with no host sync in it: the graph of this generation
    # is captured, so enqueueing 2 steps must not synchronise; the one
    # fetch comes after
    fE_seq = torch.stack([torch.as_tensor(forcing(gr3.nE, seed=30 + i),
                                          device=device) for i in range(2)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = sa.launch_window(fE_seq)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    stats, last = sa.finish_window(pending)
    for f in fE_seq:
        ob = b.couple({"greenland": f})
    rows = b.ledger.to_rows()[-2:]
    want = np.array([[r[f"greenland.{k}"] for k in sa.STAT_KEYS]
                     for r in rows])
    check(np.array_equal(stats, want), "the sync-free window's ledger rows "
                                       "are not the eager steps'")
    same_results({"greenland": last}, ob, a, b, "the sync-free window")
    say(f"compiled #3: a fused window of 2 enqueued under "
        f"torch.cuda.set_sync_debug_mode('error') (no host sync), its one "
        f"fetch after; rows, outputs and state bit for bit the eager "
        f"steps'")

    # the CFL bound: a 1-year step takes 10 substeps, so from a budget of 1
    # the fused window reruns (1, 2, 4, 8, 16) on the card
    c, d = compiled_pair(gr3, device, regen_every=COMPILED_REGEN, dt=CFL_DT)
    sc = c.sheets["greenland"]
    fn = lambda t, s: torch.as_tensor(forcing(gr3.nE, seed=int(t // CFL_DT)),
                                      device=device)
    oc, fc = wall_ms(lambda: c.run_transient(fn, 2, fused=True))
    od, fd = wall_ms(lambda: d.run_transient(fn, 2))
    same_results(oc, od, c, d, "CFL-bound window")
    tc, td = [], []
    for _ in range(2):        # the first captures at the budget seen (10)
        oc, t = wall_ms(lambda: c.couple({"greenland": fn(c.time, None)}))
        tc.append(t)
        od, t = wall_ms(lambda: d.couple({"greenland": fn(d.time, None)}))
        td.append(t)
        same_results(oc, od, c, d, "CFL-bound step")
    check(c.ledger.to_rows() == d.ledger.to_rows(),
          "CFL-bound ledger rows are not the eager step's")
    check_ledger(c.ledger.to_rows(), c.sheets, "compiled #3, 1-year steps")
    say(f"compiled #3, 1-year steps: fused window of 2 {fc:.1f} ms "
        f"compiled (its reruns and captures included), {fd:.1f} eager; the "
        f"next two steps {tc[0]:.3f} (capturing) and {tc[1]:.3f} ms "
        f"compiled, {td[0]:.3f} and {td[1]:.3f} eager; {graph_stats(c)}")
    check(sc.reruns > 0 and sc.budget >= 2, "no budget rerun on the card")

    # config #5: both sheets, one graph and one budget each
    a5, b5 = compiled_pair(gr5, device, regen_every=REGEN)
    (ms_a, ms_b), fused_a, fused_b = drive_pair(a5, b5, REGEN + 1,
                                                REGEN - 1, device,
                                                "compiled #5")
    say(f"compiled #5: step {med(ms_a):.3f} ms compiled, {med(ms_b):.3f} "
        f"eager ({len(ms_a)} steps that neither capture nor regenerate); "
        f"fused window of {REGEN - 1} {fused_a:.1f} ms, eager stepwise "
        f"{fused_b:.1f} ms; {graph_stats(a5)}")
    for name, sc in a5.sheets.items():
        check(sc.replays > 0, f"config #5 {name} ran no graph replay")
        check(sc._gen >= 3, f"config #5 {name}: {sc._gen - 1} regenerations")
    say(f"compiled: phase 18 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 19: regeneration on the card ------------------------------------

REGEN_TIMES = 4           # regenerations a sheet and path (alternating masks)


def regen_state(st, seed):
    """``st`` with the ice removed from a seeded fifth of its iced cells
    and 37.5 m added to the rest: a retreat and a change of every class
    split."""
    import torch
    from icebin_tpu_torch.models.ice_sheet import IceSheetState
    iced = torch.nonzero(st.H.reshape(-1) > 1.0).flatten().cpu().numpy()
    rng = np.random.default_rng(seed)
    H = st.H.clone().reshape(-1)
    H[iced] += 37.5
    H[torch.as_tensor(rng.choice(iced, len(iced) // 5, replace=False),
                      device=H.device)] = 0.0
    return IceSheetState(H=H.reshape(st.H.shape), bed=st.bed, t=st.t,
                         enth=st.enth)


def same_pack(a, b, what):
    for side in ("small", "ice"):
        x, y = getattr(a, side), getattr(b, side)
        for k in ("rowptr", "cols", "vals", "winv", "live"):
            u, v = getattr(x, k), getattr(y, k)
            check(u.dtype == v.dtype and (same(u, v) if u.is_floating_point()
                                          else bool((u == v).all())),
                  f"regen: {what} {side} {k} not bit for bit the host's")
        check(x.n_live == y.n_live, f"regen: {what} {side} n_live")
    for k in ("wS", "wI"):
        check(same(getattr(a, k), getattr(b, k)),
              f"regen: {what} {k} not bit for bit the host's")


def kept_pack(pack):
    """A copy of ``pack`` that later regenerations leave as it is (the
    device path loads every generation's hot packs into the same
    buffers)."""
    import copy

    def kept(csr):
        out = copy.copy(csr)
        for k in ("rowptr", "cols", "vals", "winv", "live"):
            setattr(out, k, getattr(csr, k).clone())
        return out

    out = copy.copy(pack)
    out.small, out.ice = kept(pack.small), kept(pack.ice)
    out.wS, out.wI = pack.wS.clone(), pack.wI.clone()
    return out


def phase_regen(gr, device):
    """Regeneration on the card against the host factory at config #5, and
    the segment-sum kernel (see the module docstring, phase 19)."""
    import torch
    from icebin_tpu_torch import CouplerConfig
    from icebin_tpu_torch.coupler.coupler import IceSheetCoupler
    from icebin_tpu_torch.coupler.ledger import Ledger
    from icebin_tpu_torch.ops.segsum import segment_sum, segment_sum_ref

    class HostRegen(IceSheetCoupler):
        def _regen_on_device(self):
            return False

    cfg = CouplerConfig(dt=DT, regen_every=1)
    held = np.random.default_rng(19).uniform(0.5, 2.0, (2, gr.nE))
    segment_sum.launches = 0
    for name in SHEETS:
        runs = {}
        for cls in (IceSheetCoupler, HostRegen):
            sc, init_ms = wall_ms(lambda: cls(gr, name, cfg, device=device))
            sc.set_held_state(held)
            sc.topo_fields()
            states = [regen_state(sc.state, 19), sc.state]
            ledger, ms, out = Ledger(), [], []
            for k in range(REGEN_TIMES):
                sc.state = states[k % 2]
                sc.steps_since_regen = 1
                ledger.open_step(float(k))
                remap, t = wall_ms(lambda: sc._regen_if_due(ledger))
                (fhc, elevE), t_topo = wall_ms(sc.topo_fields)
                ms.append((t, t_topo))
                out.append((remap, fhc, elevE, sc.held_E.copy(),
                            {n: kept_pack(sc.mat(n).pack)
                             for n in ("EvI", "AvI")}))
            runs[cls] = sc, init_ms, ms, out, ledger.to_rows()
        (dv, dinit, dms, dout, drows), (hs, hinit, hms, hout, hrows) = (
            runs[IceSheetCoupler], runs[HostRegen])
        check((dv.regens_device, dv.regens_host) == (1 + REGEN_TIMES, 0),
              f"regen: {name} device counters {dv.regens_device}, "
              f"{dv.regens_host}")
        check((hs.regens_device, hs.regens_host) == (0, 1 + REGEN_TIMES),
              f"regen: {name} host counters")
        check(drows == hrows, f"regen: {name} held-mass rows differ")
        for k, (d, h) in enumerate(zip(dout, hout)):
            for a, b, what in ((d[0].rows, h[0].rows, "E1vE0 rows"),
                               (d[0].cols, h[0].cols, "E1vE0 cols"),
                               (d[0].vals, h[0].vals, "E1vE0 vals"),
                               (d[1], h[1], "fhc"), (d[2], h[2], "elevE"),
                               (d[3], h[3], "held state")):
                check(a.dtype == b.dtype and np.array_equal(
                    np.ascontiguousarray(a).view(np.uint8),
                    np.ascontiguousarray(b).view(np.uint8)),
                      f"regen: {name} {what} of regeneration {k} not bit "
                      f"for bit the host's")
            for m in ("EvI", "AvI"):
                same_pack(d[4][m], h[4][m], f"{name} {m} ({k})")
        say(f"regen {name}: {dv.regen.xd.iA.numel()} exchange cells; set-up "
            f"(upload and the first matrices) device {dinit:.1f} ms, host "
            f"{hinit:.1f} ms; a regeneration (factory, packs, E1vE0, held "
            f"remap) device "
            f"{', '.join(f'{a:.1f}' for a, _ in dms)} ms, host "
            f"{', '.join(f'{a:.1f}' for a, _ in hms)} ms; TOPO device "
            f"{', '.join(f'{b:.1f}' for _, b in dms)} ms, host "
            f"{', '.join(f'{b:.1f}' for _, b in hms)} ms; E1vE0 "
            f"{dout[0][0].nnz} nnz; bit for bit")
    # the count the kernels line reports: the regenerations' own launches
    launches = segment_sum.launches
    check(launches > 0, "regen: segment_sum was not launched")

    # the kernel on Antarctica's EvI: row sums (wS: 64,800 long segments)
    # and column sums (wI: 1.25 M short ones)
    rows, cols, vals, shape = dv.rm.coo("EvI", cfg.params)
    order = torch.sort(cols.to(torch.int32), stable=True).indices
    cases = {"wS": (vals, torch.searchsorted(
                 rows, torch.arange(shape[0] + 1, device=device))),
             "wI": (vals[order], torch.searchsorted(
                 cols[order], torch.arange(shape[1] + 1, device=device)))}
    res = {"launches": launches, "max_abs_err": 0.0}
    timed = {}
    for tag, (v, ptr) in cases.items():
        got = segment_sum(v, ptr)
        want, plain = wall_ms(lambda: segment_sum_ref(v.cpu(), ptr.cpu()))
        check(same(got.cpu(), want),
              f"regen: segment_sum ({tag}) not bit for bit its plain version")
        lens = ptr[1:] - ptr[:-1]
        ms = time_ms(lambda: segment_sum(v, ptr), 20)
        lib = time_ms(lambda: torch.segment_reduce(v, "sum", lengths=lens),
                      20)
        b, by = bound(8 * v.numel() + 16 * (len(ptr) - 1) + 8, 0)
        timed[tag] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                          bound_by=by, n=v.numel(), segments=len(ptr) - 1,
                          longest=int(lens.max()))
        say(f"regen segment_sum antarctica EvI {tag}: {v.numel()} values in "
            f"{len(ptr) - 1} segments (longest {int(lens.max())}), "
            f"{ms:.4f} ms, bound {b * 1e3:.1f} us ({by}), plain {plain:.1f} "
            f"ms, torch.segment_reduce {lib:.4f} ms")
    res.update(timed["wS"], param="antarctica EvI wS (wI: "
               f"{timed['wI']['ms']:.4f} ms, bound "
               f"{timed['wI']['bound_ms'] * 1e3:.1f} us)")
    return res


# -- phase 21: the books kernel alone ------------------------------------------

def books_stages(sc, device, seed):
    """The groups of a coupling step's two sum stages on sheet ``sc``'s
    real widths and weights (``IceSheetCoupler._couple_core``): the
    forcing repair's sums (7 rows over E scaled, 7 over I, the weights'
    total) and the step's sums (5 lattice fields before the step and 7
    after it, 2 of them of three fields, and the 7 E-side sources), with
    their fields from ``seed``; and the bytes each reads once."""
    import torch
    from icebin_tpu_torch.ops.apply import apply_view
    from icebin_tpu_torch.ops.books import Rows
    ive = sc.mat("IvE")
    cin, rep = sc.contract_in, list(sc.cfg.repair_fields)
    fac, off = sc._conversion(torch.float32)
    fE = torch.as_tensor(forcing(sc.gr.nE, seed=seed), device=device)
    fI = apply_view(ive, fE, var_factor=fac, var_offset=off)
    irep = [cin.index(n) for n in rep]
    rng = np.random.default_rng(seed)
    nI, nE = fI.shape[1], fE.shape[1]
    f32 = lambda: torch.as_tensor(rng.standard_normal(nI), dtype=torch.float32,
                                  device=device)
    f64 = lambda: torch.as_tensor(rng.standard_normal(nI), device=device)
    H, enth = sc.state.H, sc.state.enth
    repair = [Rows(fE, irep, w=ive.Mw, scale=fac), Rows(fI, irep, w=ive.wM),
              Rows(ive.wM)]
    step = [Rows(H), Rows(enth), Rows(f64()), Rows(f64()), Rows(f64()),
            Rows(H), Rows(enth), Rows(f32(), extra=(f32(), f32())),
            Rows(H.sum()), Rows(f32(), extra=(f32(), f32())),
            Rows(enth.sum()), Rows(f32()),
            Rows(fE, irep, w=ive.Mw, scale=fac, split=True)]
    nbytes = {"repair": 7 * 4 * (nE + nI) + 8 * (nE + nI),
              "step": (4 * 4 + 3 * 8 + 2 * 3 * 4 + 4) * nI
              + 7 * 4 * nE + 8 * nE}
    return {"repair": repair, "step": step}, nbytes, (fI, ive, irep)


def phase_books(sheets, device):
    """The books' kernel (csrc/books.cu) alone on each sheet's step stages
    (``books_stages``) and on its repair's write: against the plain
    version (the torch chain it replaced, on the card) within BOOKS_TOL of
    sum |f w| (the write bit for bit), two launches the same bits, its ms
    beside the plain chain's and its byte bound.  Returns the kernel-table
    entry (Antarctica's step sums) with each case's numbers."""
    import torch
    from icebin_tpu_torch.ops.books import (Rows, books_repair,
                                            books_repair_ref, books_sum,
                                            books_sum_ref)

    def absolute(groups):
        """The groups with |f| and |w|: their sums bound sum |f w|."""
        return [Rows(g.x.abs(), g.rows, None if g.w is None else g.w.abs(),
                     g.mask, tuple(e.abs() for e in g.extra),
                     None if g.scale is None else g.scale.abs(), g.split)
                for g in groups]

    res = {}
    for name, sc in sheets.items():
        stages, nbytes, (fI, ive, irep) = books_stages(sc, device, 21)
        for tag, groups in stages.items():
            got = books_sum(*groups)
            check(same(got, books_sum(*groups)),
                  f"books {name} {tag}: two launches differ")
            want = books_sum_ref(*groups)
            scale = books_sum_ref(*absolute(groups))
            err = float(((got - want).abs() / scale.clamp(min=1e-300)).max())
            check(err <= BOOKS_TOL, f"books {name} {tag}: {err:.2e} of sum "
                                    f"|f w| from the plain version")
            ms = time_ms(lambda: books_sum(*groups), 50)
            plain = time_ms(lambda: books_sum_ref(*groups), 20)
            b, by = bound(nbytes[tag], 0)
            res[f"{name} {tag}"] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                        bound_by=by, max_rel_err=err,
                                        sums=len(got))
            say(f"books {name} {tag} sums: {len(got)} sums over rows of "
                f"{fI.shape[1]} (I) and {sc.gr.nE} (E), {ms:.4f} ms, "
                f"bound {b * 1e3:.1f} us ({by}), the plain ATen chain "
                f"{plain:.4f} ms; {err:.2e} of sum |f w| from it")
        # the repair's write: 7 rows, their f32 downcast into the forcing,
        # the 7 delivered sums
        m = books_sum(Rows(fI, irep, w=ive.wM), Rows(ive.wM))
        m_src = m[:7] * 1.0001
        args = (ive.wM, m_src, m[:7], m[7])
        kw = dict(rows=irep, into=True, sums=list(range(7)))
        xa, xb = fI.clone(), fI.clone()
        out, ds = books_repair(xa, *args, **kw)
        ref, dref = books_repair_ref(xb, *args, **kw)
        check(same(out, ref) and same(xa, xb),
              f"books {name} repair: the write is not the plain version's")
        ms = time_ms(lambda: books_repair(fI.clone(), *args, **kw), 50)
        plain = time_ms(lambda: books_repair_ref(fI.clone(), *args, **kw),
                        20)
        copy = time_ms(lambda: fI.clone(), 50)
        nI = fI.shape[1]
        b, by = bound(7 * nI * (4 + 8 + 4) + 8 * nI, 0)
        res[f"{name} write"] = dict(ms=ms - copy, plain_ms=plain - copy,
                                    bound_ms=b, bound_by=by)
        say(f"books {name} repair write: 7 rows of {nI}, {ms - copy:.4f} ms "
            f"(less the clone's {copy:.4f}), bound {b * 1e3:.1f} us ({by}), "
            f"the plain ATen chain {plain - copy:.4f} ms; bit for bit")
    top = res["antarctica step"]
    return dict(top, max_abs_err=max(r.get("max_rel_err", 0.0)
                                     for r in res.values()),
                library_ms=None, cases=res,
                param="antarctica step sums (of sum |f w|: max_abs_err)")


# -- phase 20: the graph kept across regenerations ----------------------------

REBIND_TIMES = 3          # rebinds (and fresh captures) a sheet


def phase_rebind(gr, device):
    """Phase 20 (docstring at the top): a rebind against a capture."""
    import torch
    from icebin_tpu_torch import CouplerConfig, GCMCoupler
    from icebin_tpu_torch.coupler.step_graph import StepGraph
    from icebin_tpu_torch.ops.apply import spmm_dest_small
    t_phase = time.perf_counter()
    cfg = CouplerConfig(dt=DT, regen_every=1 << 30)
    cp = GCMCoupler(gr, cfg, device=device)
    fn = lambda t, s: torch.as_tensor(forcing(gr.nE, seed=int(t // DT)),
                                      device=device)
    cp.run_transient(fn, 2, fused=True)       # each sheet's one capture
    res = {}
    for name, sc in cp.sheets.items():
        (g,) = sc._graphs.values()
        ms = {"load": [], "nodes": [], "capture": []}
        nodes = []

        def timed(f, key, out=None):
            """``f`` timed into ``ms[key]`` (synchronised around it), its
            results appended to ``out``."""
            def run(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = f(*a)
                torch.cuda.synchronize()
                ms[key].append(1e3 * (time.perf_counter() - t0))
                if out is not None:
                    out.append(r)
                return r
            return run

        for buf in sc.regen.buffers.values():
            buf.load = timed(buf.load, "load")
        g.rebind = timed(g.rebind, "nodes", nodes)
        fE = fn(cp.time, name)
        (budget,) = sc._graphs
        for k in range(REBIND_TIMES):
            sc.state = regen_state(sc.state, 40 + k)
            sc.regen_matrices()       # the packs loaded, the graph rebound
            st = sc.state
            inputs = (st.H, st.bed, st.t, st.enth, fE)
            rebound = [x.clone() for x in g.run(inputs)]
            fresh = StepGraph(sc._step_fn(budget), inputs,
                              stream=sc._capture_stream)
            torch.cuda.synchronize()
            ms["capture"].append(fresh.capture_ms or float("nan"))
            check(all(same(a, b) for a, b in zip(rebound,
                                                 fresh.run(inputs))),
                  f"rebind {name}: the rebound graph's step is not a fresh "
                  f"capture's bit for bit")
            fresh.reset()
        want = g.launches.get(spmm_dest_small, 0)
        check(nodes == [want] * REBIND_TIMES and want > 0,
              f"rebind {name}: {nodes} dest-small launches updated")
        # a rebind: both hot packs' copies and the node updates
        rebind = [a + b + n for a, b, n in zip(ms["load"][::2],
                                               ms["load"][1::2],
                                               ms["nodes"])]
        res[name] = {k: float(np.median(v)) for k, v in ms.items()}
        res[name]["rebind"] = float(np.median(rebind))
        say(f"rebind {name}: {want} dest-small launches; a rebind "
            f"{', '.join(f'{m:.3f}' for m in rebind)} ms (the packs' copies "
            f"into the graph's buffers "
            f"{', '.join(f'{m:.3f}' for m in ms['load'])} ms, the node "
            f"updates "
            f"{', '.join(f'{m:.3f}' for m in ms['nodes'])} ms); a fresh "
            f"capture {', '.join(f'{m:.1f}' for m in ms['capture'])} ms; "
            f"EvI/AvI live rows "
            f"{[sc.mat(n).pack.small.n_live for n in ('EvI', 'AvI')]}; the "
            f"rebound step bit for bit the fresh capture's; {CARD}")
    say(f"rebind: phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return res


def main():
    global CARD
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from icebin_tpu_torch.ops import _build
    from icebin_tpu_torch.ops.apply import spmm_dest_ice, spmm_dest_small
    from icebin_tpu_torch.ops.books import (books_repair, books_stats,
                                            books_sum)
    from icebin_tpu_torch.ops.clip import (clip_areas_centroids,
                                           clip_areas_centroids_poly)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    CARD = card_name()
    t = time.perf_counter()
    _build.library()
    say(f"build: {1e3 * (time.perf_counter() - t):.1f} ms, "
        f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            say(f"ptxas: {line.strip()}")
    check_clip_build(_build.build_log())

    specA, specI = greenland_specs()
    clip = phase_clip(specA, specI, device)
    counters = (clip_areas_centroids, spmm_dest_ice, spmm_dest_small)
    books = (books_sum, books_repair, books_stats)
    for k in books:
        k.launches = 0
    cp, launches, step_ms = phase_main(specA, specI, device, counters)
    launches["books"] = sum(k.launches for k in books)
    check(launches["books"] > 0, "the main path did not launch the books")
    spmm = phase_spmm(cp)
    phase_profile(cp, step_ms, device)
    phase_toy(device)
    poly = phase_polyclip(specA, specI, device,
                          counters + (clip_areas_centroids_poly,))
    phase_run(specA, specI, cp.gr.sheets["greenland"].exchange, device,
              counters)
    roof = phase_roof(device)
    ms = phase_multisheet(specA, specI, cp.gr.sheets["greenland"].exchange,
                          device, counters)
    phase_modele(ms.gr, device, counters)
    sheets = {"greenland": cp.sheets["greenland"],
              "antarctica": ms.sheets["antarctica"]}
    floors = phase_floors(sheets, device)
    books_res = phase_books(sheets, device)
    probes = phase_k2probe(sheets, device)
    t14 = time.perf_counter()
    probes1 = phase_k1probe(sheets, device)
    say(f"k1probe: phase 14 took {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    smemfold = phase_smemfold(device)
    say(f"smemfold: phase 15 took {time.perf_counter() - t15:.1f} s")
    phase_mesh(specA, specI, cp.gr.sheets["greenland"].exchange, device,
               step_ms)
    phase_topo(device, counters)
    phase_compiled(cp.gr, ms.gr, device)
    regen = phase_regen(ms.gr, device)
    phase_rebind(ms.gr, device)
    for mod in ("jax", "icebin_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    launches["clip_areas_centroids_poly"] = poly["launches"]
    launches["stream_reduce"] = roof["launches"]
    launches["segment_sum"] = regen["launches"]
    for name, res in (*floors.items(), *probes.items(), *probes1.items(),
                      *smemfold.items()):
        launches[name] = res["launches"]

    def row(name, source, replaces, res):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}

    # timings at the main path's hot shapes: IvE (K1, in the (nv, n) layout
    # apply_ice runs) and EvI (K2), beside the stage-1 kernel's; the error
    # is the worst of every matrix and nv of phase 4
    def spmm_row(name, tag):
        res = dict(spmm[name])[tag]
        return dict(row(name, "icebin_tpu_torch/csrc/spmm.cu",
                        "icebin_tpu/ops/pallas_bdt.py:" + (
                            "903" if name == "spmm_dest_ice" else "807"),
                        dict(res, max_abs_err=max(r["max_abs_err"]
                                                  for _, r in spmm[name]))),
                    **{k: v for k, v in res.items()
                       if k == "stage1_ms" or k.startswith("f64_")})

    kernels = [
        spmm_row("spmm_dest_ice", "IvE"),
        spmm_row("spmm_dest_small", "EvI"),
        dict(row("clip_areas_centroids", "icebin_tpu_torch/csrc/clip.cu",
                 "icebin_tpu/ops/pallas_clip.py:142", clip),
             stage1_ms=clip["stage1_ms"]),
        dict(row("clip_areas_centroids_poly",
                 "icebin_tpu_torch/csrc/clip.cu",
                 "icebin_tpu/ops/pallas_clip.py:120", poly),
             stage1_ms=poly["stage1_ms"]),
        row("stream_reduce", "icebin_tpu_torch/csrc/roof.cu",
            "tools/bench_roof.py:58 and tools/probe_stream_scale.py:40",
            roof),
        row("spmm_floor_small", "icebin_tpu_torch/csrc/floor.cu",
            "tools/probe_floor.py:59 and tools/probe_ant_nv.py:144",
            floors["spmm_floor_small"]),
        row("spmm_floor_ice", "icebin_tpu_torch/csrc/floor.cu",
            "tools/probe_floor.py:84", floors["spmm_floor_ice"]),
        row("tile_prods", "icebin_tpu_torch/csrc/prods.cu",
            "tools/probe_prods_scale.py:69", floors["tile_prods"]),
        dict(row("segment_sum", "icebin_tpu_torch/csrc/segsum.cu",
                 "none: regeneration is host numpy in the JAX package",
                 regen), param=regen["param"]),
        dict(row("books", "icebin_tpu_torch/csrc/books.cu",
                 "none: added for the books on the card", books_res),
             param=books_res["param"], cases=books_res["cases"]),
    ] + [dict(row(name, "icebin_tpu_torch/csrc/k2probe.cu", site,
                  probes[name]), param=probes[name]["param"])
         for name, site in K2PROBE_SITES.items()] + [
        # store("into") launches spmm.cu's K1 into a held buffer
        dict(row(name, "icebin_tpu_torch/csrc/" + (
            "spmm.cu" if probes1[name]["param"] == "into" else "k1probe.cu"),
                 site, probes1[name]), param=probes1[name]["param"])
        for name, site in K1PROBE_SITES.items()] + [
        dict(row(name, "icebin_tpu_torch/csrc/" + src, site, smemfold[name]),
             param=smemfold[name]["param"])
        for name, (src, site) in SMEMFOLD_SITES.items()]
    say(f"whole script {time.perf_counter() - t0:.1f} s (the build "
        f"included)")
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
