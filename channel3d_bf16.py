#!/usr/bin/env python3
"""example/3d_channel.xml's lattice (d3q27_cumulant, 48x48x256) in bf16
shifted storage on one CUDA card, through two engines: the z-slab kernels
(``cuda_d3q27_band[d3q27_cumulant,fuse=2,bfloat16/shifted]``) and the
narrowed eager engine (the kernels' plain version: widen, one step in f32,
narrow), beside the f32 run on the kernels.

    python3 channel3d_bf16.py [--steps N]

Each run takes ``N`` steps (default: the XML's Solve, 20000) in the chunks
its Log interval cuts.  The script prints the card, each run's engine,
wall time and mean ux, and U's relative L2 of each bf16 run against the
f32 run and of the eager run against the kernel run.  It exits nonzero
if a run ran on another engine or left non-finite fields; the values the
bf16 runs reach are reported, not held (the JAX package pins no 3D bound
in bf16).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import xml.etree.ElementTree as ET

import torch

from chip_smoke import (CHANNEL3D_XML, DEVICE, bf16_copy, card_line,
                        case_lattice, fail, say)

ENGINES = {
    "f32": "cuda_d3q27_band[d3q27_cumulant,fuse=2]",
    "bf16_shifted_kernels":
        "cuda_d3q27_band[d3q27_cumulant,fuse=2,bfloat16/shifted]",
    "bf16_shifted_eager": "eager[bfloat16/shifted]",
}


def run(lat, steps: int, chunk: int, eager: bool) -> float:
    """``steps`` steps of ``lat`` in chunks of ``chunk``; the wall time.
    ``eager``: the kernel engine is turned off for the engine's choice."""
    if eager:
        os.environ["TCLB_FASTPATH"] = "0"
    try:
        lat.iterate(min(chunk, steps))
    finally:
        os.environ.pop("TCLB_FASTPATH", None)
    lat.synchronize()
    t0 = time.perf_counter()
    done = min(chunk, steps)
    while done < steps:
        n = min(chunk, steps - done)
        lat.iterate(n)
        done += n
    lat.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=None,
                   help="steps per run (default: the XML's Solve)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("channel3d_bf16: torch.cuda.is_available() is false; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    root = ET.parse(CHANNEL3D_XML).getroot()
    steps = args.steps or int(root.find("Solve").get("Iterations"))
    chunk = int(root.find("Log").get("Iterations"))
    say(card_line())
    base = case_lattice(CHANNEL3D_XML, torch.float32, DEVICE)
    lats = {"f32": base, "bf16_shifted_kernels": bf16_copy(base),
            "bf16_shifted_eager": bf16_copy(base)}
    out = {"steps": steps}
    for label, lat in lats.items():
        wall = run(lat, steps, chunk, eager=label.endswith("eager"))
        if lat.engine_name != ENGINES[label]:
            fail(f"{label} ran on {lat.engine_name}")
        if not bool(torch.isfinite(lat.state.fields.float()).all()):
            fail(f"{label}: non-finite fields")
        u = lat.get_quantity("U").double()
        out[label] = {"engine": lat.engine_name, "wall_s": wall,
                      "mean_ux": float(u[0].mean())}
        say(f"{label}: {steps} steps on {lat.engine_name} in {wall:.3f} s "
            f"(the first chunk untimed), mean ux "
            f"{out[label]['mean_ux']:.6g}")
        lats[label] = u
    for a, b in (("bf16_shifted_kernels", "f32"),
                 ("bf16_shifted_eager", "f32"),
                 ("bf16_shifted_eager", "bf16_shifted_kernels")):
        rel = float((lats[a] - lats[b]).norm() / lats[b].norm())
        out[f"u_rel_l2_{a}_vs_{b}"] = rel
        say(f"U of {a} against {b}: relative L2 {rel:.6e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
