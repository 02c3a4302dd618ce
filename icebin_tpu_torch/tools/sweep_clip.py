"""The launch-geometry sweep of the clip kernels (``csrc/clip.cu``, stage
2: the register pipeline): threads a block x ``__launch_bounds__`` min
blocks x the route a subject ring takes to its thread (16-byte loads into
registers, or cp.async into shared memory), for ``clip_rect`` at V0 = 8 and
16 and ``clip_poly`` at V0 = 8, Vc = 8, on the main path's pairs, beside
the stage-1 kernels.  ``clip.cu``'s rule (``clip_rect``, ``clip_poly``) is
the geometry this sweep settled.

    python -m icebin_tpu_torch.tools.sweep_clip [--config 3 5 hex]
        [--device cuda|cpu]

``--config 3`` is every candidate pair of bench.py's Greenland 5 km under
ModelE 2x2.5 (subdiv 2), ``5`` those of Antarctica 5 km on
bench.py:101-113's lattice, both clipped against rectangles at V0 = 8 and,
padded with their last vertex, at V0 = 16; ``hex`` the pairs of Greenland
as 25 km2 hexagons (``common.hex_mesh``) under the same atmosphere,
clipped against convex rings at V0 = 8, Vc = 8; ``synth`` 1,024 seeded
random pairs of each kind.  Prints one JSON line per case: the kernel, its
shape and pairs, the geometry, device ms (CUDA events over REPS calls after
a sleep kernel) beside the bound (``clip_bound``), whether the areas and
centroids are bit for bit the wrapper's (the rule), and the card.  The
wrapper's own line also says whether it is bit for bit
``clip_stream_model`` on SAMPLE seeded pairs; the stage-1 line how many
pairs' areas differ from stage 2's in any bit and by how much at most; a
last line (geometry "divergence") the stage steps a thread of stage 2
takes and those its warp runs, counted from the bit model on WARPS seeded
warps (``warp_steps``; the same on any device).
``--device cpu`` runs the plain versions and times nothing (every ms and
comparison null: a CPU time is not the card's).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from icebin_tpu_torch.tools.common import (HEX_R, antarctica_spec,
                                           card_name, clip_bound,
                                           greenland_specs, hex_mesh, same,
                                           time_ms)

__all__ = ["REPS", "SAMPLE", "WARPS", "THREADS", "MIN_BLOCKS", "SWEPT",
           "pairs", "warp_steps", "sweep", "main"]

REPS = 20
SAMPLE = 4096
WARPS = 64        # seeded warps whose stage steps ``warp_steps`` counts
#: the geometries stage 2 has instances for (``clip.cu:clip_stream_at``):
#: every shape at min blocks 1, the swept shapes (V0, Vc; 0 for
#: rectangles) also at 2
THREADS = (64, 128, 256)
MIN_BLOCKS = (1, 2)
SWEPT = ((8, 0), (16, 0), (8, 8))


def _synth(B, kind, seed=0):
    """B seeded random pairs: convex rings of 3..8 vertices around the
    origin against centred rectangles, or against convex rings of 3..8
    vertices recentred on their slots' mean (f32)."""
    rng = np.random.default_rng(seed)

    def rings(n, V, r0, r1):
        ang = np.sort(rng.uniform(0, 2 * np.pi, (B, V)), axis=1)
        ang = np.take_along_axis(
            ang, np.minimum(np.arange(V)[None, :], n[:, None] - 1), axis=1)
        r = rng.uniform(r0, r1, (B, 1))
        return np.stack([r * np.cos(ang), r * np.sin(ang)], -1)

    polys = rings(rng.integers(3, 9, B), 8, 0.2, 1.5)
    if kind == "rect":
        h = rng.uniform(0.1, 1.0, (B, 2))
        other = np.stack([-h[:, 0], -h[:, 1], h[:, 0], h[:, 1]], -1)
    else:
        other = rings(rng.integers(3, 9, B), 8, 0.5, 1.2)
        other -= other.mean(axis=1, keepdims=True)
    return polys.astype(np.float32), other.astype(np.float32)


def pairs(config, device):
    """[(kernel, polys, other, cell areas (B,) f64)]: the kernel inputs of
    ``config`` ("3", "5", "hex" or "synth") on ``device``."""
    from icebin_tpu_torch.grid import clip_pairs, polyclip_pairs
    from icebin_tpu_torch.ops.clip import recentre_pairs, recentre_poly_pairs

    def on(*arrays):
        return [torch.as_tensor(a, device=device) for a in arrays]

    if config == "synth":
        p, r = _synth(1024, "rect")
        q, c = _synth(1024, "poly", seed=1)
        ones = np.ones(1024)
        return [("clip_rect", *on(p, r), ones),
                ("clip_poly", *on(q, c), ones)]
    specA, specI = greenland_specs()
    if config == "hex":
        hexes = hex_mesh(specI, HEX_R)
        _, pairI, subj, clip, p2c = polyclip_pairs(specA, hexes, 2)
        p, q, _ = recentre_poly_pairs(subj, clip)
        cell = np.abs(hexes.plane_areas())[p2c[pairI]]
        return [("clip_poly", *on(p, q), cell)]
    if config == "5":
        specI = antarctica_spec()
    elif config != "3":
        raise ValueError(f"config must be 3, 5, hex or synth, got {config!r}")
    _, pairI, subj, rect = clip_pairs(specA, specI, subdiv=2)
    p, r, _ = recentre_pairs(subj, rect)
    p16 = np.concatenate([p, np.repeat(p[:, -1:], 16 - p.shape[1], 1)], 1)
    cell = specI.cell_areas()[pairI]
    return [("clip_rect", *on(p, r), cell), ("clip_rect", *on(p16, r), cell)]


def _emissions(ring, other):
    """Per clipping stage of one pair, the tokens each of its input tokens
    makes it pass on (``clip_stream_model``'s arithmetic, the kernel's
    order): nothing for the first vertex, the crossing and the vertex for
    each later one, the closing group and the close token for the close."""
    from icebin_tpu_torch.ops.clip import _F, _stream_dists, _stream_stage
    r = [(_F(x), _F(y)) for x, y in np.asarray(ring, np.float32)]
    out = []
    for dist in _stream_dists(other):
        if dist is None or not r:       # passes each token on
            out.append([1] * (len(r) + 1))
            continue
        ins = [dist(x, y) >= 0 for x, y in r]
        out.append([0] + [int(ins[k] != ins[k - 1]) + int(ins[k])
                          for k in range(1, len(r))]
                   + [int(ins[0] != ins[-1]) + int(ins[0]) + 1])
        r = _stream_stage(r, dist)
    return out


def warp_steps(p, q, warps=WARPS, seed=13):
    """(stage steps a thread takes, stage steps its warp runs): means over
    ``warps`` seeded warps of 32 consecutive pairs of (p, q), counting a
    step of any stage, the shoelace included, once.  The warp runs a
    stage's emission loop to the largest count among its threads, so it
    runs the stages after it as often as that count and the counts below
    it multiply."""
    p, q = np.asarray(p), np.asarray(q)
    n = min(warps, len(p) // 32)
    total_t = total_w = 0
    for w in np.random.default_rng(seed).choice(len(p) // 32, n,
                                               replace=False):
        C = [_emissions(p[32 * w + i], q[32 * w + i]) for i in range(32)]
        ptr = [[0] * len(C[0]) for _ in C]
        steps = 0

        def run(k, active):
            nonlocal steps
            steps += 1
            if k == len(C[0]):          # the shoelace takes the token
                return
            emit = {}
            for t in active:
                emit[t] = C[t][k][ptr[t][k]]
                ptr[t][k] += 1
            for i in range(max(emit.values())):
                run(k + 1, [t for t in active if emit[t] > i])

        for _ in C[0][0]:               # the V0 vertices and the close
            run(0, list(range(32)))
        total_w += steps
        total_t += sum(sum(map(len, c)) + sum(c[-1]) for c in C) / 32
    return total_t / max(n, 1), total_w / max(n, 1)


def sweep(kernel, p, q, cell, reps=REPS):
    """The cases of one kernel's inputs: a list of dicts (module
    docstring); no time for ``reps=0``."""
    from icebin_tpu_torch.ops import clip as cl
    cuda = p.device.type == "cuda"
    rect = kernel == "clip_rect"
    wrap = cl.clip_areas_centroids if rect else cl.clip_areas_centroids_poly
    compact = (cl.clip_areas_centroids_compact if rect
               else cl.clip_areas_centroids_poly_compact)
    bound_ms, bound_by = clip_bound(p, q)
    base = {"kernel": kernel, "v0": p.shape[1],
            "vc": 0 if rect else q.shape[1], "pairs": p.shape[0],
            "bound_ms": bound_ms, "bound_by": bound_by}
    res = []

    def case(name, geometry, fn, extra):
        ms = time_ms(fn, reps) if cuda and reps else None
        res.append(dict(base, kernel=name, geometry=geometry, ms=ms,
                        **extra))

    want = wrap(p, q)
    if cuda:
        torch.cuda.synchronize()
    idx = np.sort(np.random.default_rng(11).choice(
        p.shape[0], min(SAMPLE, p.shape[0]), replace=False))
    model = None
    if cuda:
        a_m, c_m = cl.clip_stream_model(p[idx].cpu().numpy(),
                                        q[idx].cpu().numpy())
        model = (same(want[0][idx].cpu(), torch.as_tensor(a_m))
                 and same(want[1][idx].cpu(), torch.as_tensor(c_m)))
    for threads in THREADS:
        for mb in MIN_BLOCKS:
            for route in cl.ROUTES:
                fn = (lambda t=threads, m=mb, r=route:
                      cl.clip_stream_at(p, q, t, m, r))
                ok = None
                if cuda:
                    got = fn()
                    ok = same(got[0], want[0]) and same(got[1], want[1])
                case(kernel, {"threads": threads, "min_blocks": mb,
                              "route": route}, fn, {"equals_rule": ok})
    case(kernel, "rule", lambda: wrap(p, q), {"equals_model": model})
    diff = None
    if cuda:
        a1 = compact(p, q)[0]
        cellt = torch.as_tensor(cell, device=p.device)
        diff = {"pairs_differing": int((a1.view(torch.int32)
                                        != want[0].view(torch.int32))
                                       .sum()),
                "max_rel_cell": float(((a1.double() - want[0].double())
                                       .abs() / cellt).max())}
    case(kernel + "_compact", "stage 1", lambda: compact(p, q),
         {"versus_stage2": diff})
    t, w = warp_steps(p.cpu().numpy(), q.cpu().numpy())
    res.append(dict(base, geometry="divergence", ms=None, thread_steps=t,
                    warp_steps=w))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_clip", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--config", nargs="+", default=["3", "5", "hex"],
                    choices=["3", "5", "hex", "synth"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain "
                 "versions on the CPU")
    card = card_name() if device.type == "cuda" else "cpu"
    ok = True
    for config in args.config:
        for kernel, p, q, cell in pairs(config, device):
            for c in sweep(kernel, p, q, cell):
                ok &= (c.get("equals_rule") is not False
                       and c.get("equals_model") is not False)
                print(json.dumps({"config": config, "device": card, **c}),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
