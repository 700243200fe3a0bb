#!/usr/bin/env python3
"""Where K3-kinds' time goes, on one NVIDIA card.

    python3 k3k_breakdown.py [--seed N]

Run from the root of a checkout, on a machine whose torch sees a CUDA
card.  It builds pilosa_tpu_torch/ops/csrc/vm_counts_kinds.cu as it is
and with each phase left out in turn through the source's K3K_OMIT flags
(``-DK3K_OMIT=<mask>``: the leaf slices' loading and clearing, the array
scatter, the run toggles, the run prefix xor, the run decode as a whole,
the tape), one nvcc each for sm_90a, side by side, into a temporary
directory.  A last variant runs the kernel as it is on an unplanned
program, every instruction and leaf slot live, to see what the host's
tape plan saves.  Each is timed on chip_smoke.py's fixed K3-kinds launch
(``chip_smoke.k3k_fixed_launch``: B=4, D=4096, (L, T) = (4, 4), arrays
at ~0.1 %, 16 runs of 512 columns and bitmaps at 8 %, made from
``--seed``) with CUDA events around each launch and L2 flushed before
each, in two rounds, and one line per variant gives its best median and
the time the left-out phase saves.  The kernel as it is, on the planned
and on the unplanned program, must equal its plain version; a variant
that leaves out a phase counts wrong by design, and its counts are not
used.

It prints the card's name and power limit first and a JSON object of the
medians last.  It exits non-zero where torch sees no card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402  (sets the shard width first)

#: variant -> (what it leaves out, K3K_OMIT mask of vm_counts_kinds.cu)
VARIANTS = {
    "kernel": ("nothing", 0),
    "no_gather": ("loading and clearing the leaf slices", 1),
    "no_arrays": ("the array scatter", 2),
    "no_toggles": ("the run toggles (every warp still xors)", 4),
    "no_cover": ("the run prefix xor", 8),
    "no_runs": ("the run toggles and prefix xor", 4 | 8),
    "no_tape": ("all but the last live instruction", 16),
}


def build(nvcc_build, out_dir: str) -> dict:
    """One library per K3K_OMIT mask, built side by side."""
    src = os.path.join(nvcc_build.CSRC_DIR, "vm_counts_kinds.cu")
    procs = {}
    for name, (_what, mask) in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [nvcc_build.find_nvcc(), *nvcc_build.NVCC_FLAGS,
             f"-DK3K_OMIT={mask}", "-o",
             os.path.join(out_dir, f"lib{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        cs.check(p.returncode == 0, f"{name} does not build: {log[-2000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        c, i = ctypes.c_void_p, ctypes.c_int
        lib.vm_counts_kinds_launch.argtypes = [c] * 7 + [i] * 8 + [c]
        libs[name] = lib
    return libs


def unplanned(prog_np: np.ndarray, slots: int) -> np.ndarray:
    """The plan of ``prog_np`` int32[B, T, 3] with every instruction and
    leaf slot live, as the tape reads without a plan: instruction t
    writes register L + t, a COPY runs as a copy, and the last register
    is the result."""
    n_q, tape_len, _ = prog_np.shape
    ins = prog_np.astype(np.uint32)
    plan = np.ones((n_q, 2 + tape_len + slots), dtype=np.uint32)
    plan[:, 0] = tape_len
    plan[:, 1] = slots + tape_len - 1
    plan[:, 2:2 + tape_len] = (
        ins[..., 0] | ins[..., 1] << 8 | ins[..., 2] << 16
        | (slots + np.arange(tape_len, dtype=np.uint32)) << 24)
    return plan.view(np.int32)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20240601)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k3k_breakdown: torch sees no CUDA card", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import bitmap as bm
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import kindpools as kp
    from pilosa_tpu_torch.ops import nvcc_build, tape

    card = cs.phase_header(torch)
    dev = torch.device("cuda", 0)
    _live, pools, prog_np, gidx_np = cs.k3k_fixed_launch(
        torch, tape, bm, kp, dev, args.seed)
    bpool, apool, acard, rpool = pools
    prog = torch.from_numpy(prog_np)
    gidx = torch.from_numpy(gidx_np).to(dev)
    n_q, tape_len, _ = prog.shape
    slots, _, domain = gidx.shape
    plans = {"planned": ck.vm_kinds_plan(prog, slots).to(dev),
             "unplanned": torch.from_numpy(unplanned(prog_np, slots))
             .to(dev)}
    want = ck.vm_counts_kinds_plain(*pools, prog.to(dev), gidx)
    out = torch.empty((n_q, domain), dtype=torch.int32, device=dev)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    runs = [(name, name, "planned") for name in VARIANTS]
    runs.append(("unplanned", "kernel", "unplanned"))
    medians: dict = {}
    with tempfile.TemporaryDirectory(prefix="k3k_breakdown_") as tmp:
        libs = build(nvcc_build, tmp)
        for _round in range(2):
            for name, lib_name, plan_name in runs:
                plan = plans[plan_name]

                def launch(fn=libs[lib_name].vm_counts_kinds_launch,
                           plan=plan, name=name):
                    rc = fn(bpool.data_ptr(), apool.data_ptr(),
                            acard.data_ptr(), rpool.data_ptr(),
                            plan.data_ptr(), gidx.data_ptr(), out.data_ptr(),
                            int(bpool.shape[0]), int(apool.shape[0]),
                            int(apool.shape[1]), int(rpool.shape[1]) // 2,
                            n_q, tape_len, slots, domain,
                            torch.cuda.current_stream().cuda_stream)
                    cs.check(rc == 0, f"{name}: CUDA error {rc}")

                t = cs.time_ms(torch, launch, cs.TIMED_LAUNCHES, flush)
                if lib_name == "kernel":
                    cs.check(torch.equal(out, want),
                             f"{name} differs from the plain version")
                medians.setdefault(name, []).append(t["median"] * 1e3)
    full = min(medians["kernel"])
    whats = {name: what for name, (what, _mask) in VARIANTS.items()}
    whats["unplanned"] = "the tape plan (every instruction and slot runs)"
    for name, _lib, _plan in runs:
        us = min(medians[name])
        print(f"{name}: without {whats[name]}: {us:.3f} us (rounds "
              f"{', '.join(f'{x:.3f}' for x in medians[name])}); saves "
              f"{full - us:.3f} us of {full:.3f}", flush=True)
    print(json.dumps({"card": card["kind"], "us": {
        k: min(v) for k, v in medians.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
