#!/usr/bin/env python3
"""K3 against its first design, on one NVIDIA card.

    python3 k3_compare.py --first PATH [--seed N]

Run from the root of a checkout, on a machine whose torch sees a CUDA
card.  PATH is the first design's source: pilosa_tpu_torch/ops/csrc/
vm_counts.cu of a checkout from before the redesign, for example

    git archive 66c7e69 pilosa_tpu_torch/ops/csrc/vm_counts.cu \\
        | tar -x -C /some/dir

It builds, one nvcc each for sm_90a, side by side, into a temporary
directory:

- ``first``: the first design as it is, one block per (query, domain
  slot) cell in query-major order (cell = q * D + d);
- ``cheap``: the same kernel with its cell index turned domain-major
  (cell = d * B + q), so that the B blocks that read one domain slot's
  containers run side by side and meet in L2; its two lines of cell
  arithmetic and its output index are replaced, nothing else;

and takes this checkout's kernel (``new``, pilosa_tpu_torch/ops/
nvcc_build.py).  It also builds this checkout's vm_counts.cu with each
of its K3_OMIT phases left out (``-DK3_OMIT=<mask>``: the leaves' copies
from HBM, the instructions, the per-query warp sums, and the last two
together), to see where the new kernel's time goes; those builds count
wrong by design, and their counts are not used.  Each is timed on chip_smoke.py's fixed K3 launches made
from ``--seed`` (``chip_smoke.k3_fixed_launch``): B=2 (trees 0 and 5,
the width of a coalesced flush) and B=4 (trees 0, 5, 9, 12) at D=4096,
and B=16 (all 16 trees) at D=1024, five rows at ~8 % fill.  CUDA events
around each launch, L2 flushed before each, in turns (first, cheap, new,
new, cheap, first), and every variant's counts equal to the plain
version's; then ``new`` once more at each vector width of
``cuda_kernels.VM_VECS`` (``new@vec<v>``: v int4 vectors per thread and
pass).  ``new`` is timed on its launch alone, with its
plan made before (chip_smoke.py times the host plan).

It prints the card's name and power limit first, one line per launch
and variant, and a JSON object of the medians (µs) last.  It exits
non-zero where torch sees no card.
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

#: (what the first design computes its cell from, the domain-major form)
CELL_ORDER = (
    ("  const int q = cell / domain;\n  const int d = cell - q * domain;\n",
     "  const int d = cell / n_q;\n  const int q = cell - d * n_q;\n"),
    ("    out[cell] = s;\n", "    out[q * domain + d] = s;\n"),
)
#: (label, shards, tree indices into chip_smoke.TREES)
LAUNCHES = (("B=2, D=4096", cs.N_SHARDS, cs.FIXED_TREES[:2]),
            ("B=4, D=4096", cs.N_SHARDS, cs.FIXED_TREES),
            ("B=16, D=1024", cs.WIDE_SHARDS, tuple(range(16))))
TURNS = ("first", "cheap", "new", "new", "cheap", "first")
#: variant -> (what it leaves out, K3_OMIT mask of vm_counts.cu)
OMITS = {"no_copy": ("the leaves' copies from HBM", 1),
         "no_tape": ("the instructions", 2),
         "no_reduce": ("the per-query warp sums", 4),
         "no_tape_reduce": ("the instructions and the warp sums", 6)}


def domain_major(src: str) -> str:
    """The first design's source with its cells in domain-major order."""
    for old, new in CELL_ORDER:
        cs.check(src.count(old) == 1, f"the first design's source does not "
                 f"hold {old.strip()!r} once")
        src = src.replace(old, new)
    return src


def build(nvcc_build, first: str, out_dir: str) -> dict:
    """The first design as it is and domain-major, and this checkout's
    kernel with each phase left out, built side by side."""
    with open(first) as f:
        src = f.read()
    this = os.path.join(nvcc_build.CSRC_DIR, "vm_counts.cu")
    builds = {"first": (src, []), "cheap": (domain_major(src), [])}
    with open(this) as f:
        src = f.read()
    builds.update({name: (src, [f"-DK3_OMIT={mask}"])
                   for name, (_what, mask) in OMITS.items()})
    procs = {}
    for name, (text, flags) in builds.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc_build.find_nvcc(), *nvcc_build.NVCC_FLAGS, *flags, "-o",
             os.path.join(out_dir, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    c, i = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        log, _ = p.communicate()
        cs.check(p.returncode == 0, f"{name} does not build: {log[-2000:]}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")
                         ).vm_counts_launch
        # the first design: (pool, prog, gidx, out, B, T, L, D, stream);
        # this one: (pool, gidx, meta, out, B, T, L, D, G, vec, smem,
        # stream)
        fn.argtypes = ([c] * 4 + [i] * 4 + [c] if name in ("first", "cheap")
                       else [c] * 4 + [i] * 7 + [c])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first", required=True,
                    help="vm_counts.cu of the first design")
    ap.add_argument("--seed", type=int, default=20240601)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k3_compare: torch sees no CUDA card", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import bitmap as bm
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import nvcc_build, tape

    card = cs.phase_header(torch)
    dev = torch.device("cuda", 0)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    medians: dict = {}
    with tempfile.TemporaryDirectory(prefix="k3_compare_") as tmp:
        fns = build(nvcc_build, args.first, tmp)
        for label, shards, trees in LAUNCHES:
            blocks, prog_np, gidx_np, _zero = cs.k3_fixed_launch(
                tape, args.seed, shards, [cs.TREES[i] for i in trees])
            pool = bm.to_tensor(blocks, dev)
            prog = torch.from_numpy(prog_np).to(dev)
            gidx = torch.from_numpy(gidx_np).to(dev)
            n_q, tape_len, _ = prog.shape
            slots, _, domain = gidx.shape
            plan = ck.vm_plan(prog, gidx)
            plan = plan._replace(meta=plan.meta.to(dev))
            want = ck.vm_counts_plain(pool, prog, gidx)
            out = torch.empty_like(want)

            def launch(name, out=out, pool=pool, prog=prog, gidx=gidx,
                       plan=plan, n_q=n_q, tape_len=tape_len, slots=slots,
                       domain=domain):
                if name == "new":
                    out.copy_(ck._vm_launch(pool, gidx, plan))
                    return
                rc = fns[name](pool.data_ptr(), prog.data_ptr(),
                               gidx.data_ptr(), out.data_ptr(), n_q,
                               tape_len, slots, domain,
                               torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"{name}: CUDA error {rc}")

            for name in TURNS:
                out.zero_()
                launch(name)
                torch.cuda.synchronize()
                cs.check(torch.equal(out, want),
                         f"{name} differs from the plain version ({label})")
                # ``new`` is timed on the bare launch, as chip_smoke.py does
                fn = ((lambda: ck._vm_launch(pool, gidx, plan))
                      if name == "new" else (lambda name=name: launch(name)))
                t = cs.time_ms(torch, fn, cs.TIMED_LAUNCHES, flush)
                medians.setdefault(label, {}).setdefault(name, []).append(
                    t["median"] * 1e3)
            # the new kernel at each vector width
            for vec in ck.VM_VECS:
                p = ck.vm_plan(prog, gidx, vec)
                p = p._replace(meta=p.meta.to(dev))
                cs.check(torch.equal(ck._vm_launch(pool, gidx, p), want),
                         f"new at {vec} vectors differs ({label})")
                t = cs.time_ms(torch, lambda p=p: ck._vm_launch(pool, gidx,
                                                                p),
                               cs.TIMED_LAUNCHES, flush)
                medians[label][f"new@vec{vec}"] = [t["median"] * 1e3]
            # where the new kernel's time goes: each phase left out
            for name, (what, _mask) in OMITS.items():
                def omitted(fn=fns[name]):
                    rc = fn(pool.data_ptr(), gidx.data_ptr(),
                            plan.meta.data_ptr(), out.data_ptr(), n_q,
                            tape_len, slots, domain, plan.n_groups,
                            plan.vec, plan.smem,
                            torch.cuda.current_stream().cuda_stream)
                    cs.check(rc == 0, f"{what} left out: CUDA error {rc}")

                t = cs.time_ms(torch, omitted, cs.TIMED_LAUNCHES, flush)
                medians[label][name] = [t["median"] * 1e3]
            for name in medians[label]:
                us = medians[label][name]
                print(f"{label}, {name}: {np.mean(us):.3f} us (turns "
                      f"{', '.join(f'{x:.3f}' for x in us)})", flush=True)
    print(json.dumps({"card": card["kind"], "us": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
