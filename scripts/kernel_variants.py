#!/usr/bin/env python3
"""Time source variants of one of the port's kernel families in turns on one GPU.

    python3 scripts/kernel_variants.py stencil      [--out build/kernel_variants_stencil.json]
    python3 scripts/kernel_variants.py fused_iter   [--out build/kernel_variants_fused_iter.json]
    python3 scripts/kernel_variants.py stencil7_dot [--out build/kernel_variants_stencil7_dot.json]

Each variant is the family's CUDA source (``src/repro_torch/kernels/csrc/``)
with a few text substitutions, built into its own copy of the package under
``build/kernel_variants/`` (all builds at once; removed at the end), then
timed in the order given and again in reverse, each checked bit for bit
against the plain version first.  ``stencil``: K1 at 608x608x1536 (bf16
storage, bf16 and f32 accumulation) and K1b at 608^3 x 4 RHS (star7, bf16
storage and accumulation); its ``march_*`` variants, as ``stencil7_dot``'s,
run the x-march's ring in other forms than the shared ``Ring`` (described
where they are defined).  ``fused_iter``: K2
(update_q_dots) and K4 (update_p) at 608x608x1536 and K2b/K4b at 608^3 x 4
RHS, bf16, their dots' relative gap to the plain version recorded beside
the bitwise check.  ``stencil7_dot``: K6 at 608x608x1536 (bf16 storage, f32
accumulation), its one-dot variant with w read from memory and its two-dot
variant with w = the iterate taken from the kernel's ring (in the
``two_dots_memory_w`` variant, read from a copy in memory instead).  A
substitution is ``(old, new)`` in the family's source or ``(path, old,
new)`` in another file of the package.  Times are CUDA events, mean of 20
launches, three repeats.  Prints one JSON line per variant and run, the
registers, stack frame and spill stores of the variant's kernels, and the
card's name and power limit.  ``--variants`` picks some of a family's
variants.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc/"

CUDA_MS = r'''
import json, sys, torch
sys.path.insert(0, "src")

def cuda_ms(fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n

dev, dt = torch.device("cuda"), torch.bfloat16
g = torch.Generator(device=dev).manual_seed(1)
out = {}
'''

STENCIL_TIME = CUDA_MS + r'''
from repro_torch.core import stencil
from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

offs = stencil.STAR7.offsets
for name, shape, nb, acc in (("k1", (608, 608, 1536), 0, dt),
                             ("k1_acc_f32", (608, 608, 1536), 0, torch.float32),
                             ("k1b", (608, 608, 608), 4, dt)):
    pre = (nb,) if nb else ()
    vp = torch.randn(pre + tuple(s + 2 for s in shape), generator=g, device=dev).to(dt)
    cfs = [(0.1 * torch.randn(shape, generator=g, device=dev)).to(dt) for _ in offs]
    f = stencil_nd_batched if nb else stencil_nd
    run = lambda: f(vp, cfs, offs, radius=1, accum_dtype=acc)
    want = stencil_nd_padded_ref(vp, cfs, offs, radius=1, accum_dtype=acc)
    out[name] = dict(bitwise=bool(run().equal(want)), ms=[cuda_ms(run) for _ in range(3)])
    del vp, cfs, want
    torch.cuda.empty_cache()
print(json.dumps(out))
'''

FUSED_TIME = CUDA_MS + r'''
from repro_torch.kernels.fused_iter import kernel as fk
from repro_torch.kernels.fused_iter import ref

for sfx, shape in (("", (608 * 608 * 1536,)), ("b", (4, 608 ** 3))):
    v = [torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(3)]
    if sfx:
        a, w, b = (torch.linspace(lo, hi, 4, device=dev)
                   for lo, hi in ((0.3, 0.9), (-1.3, -0.5), (0.2, 0.8)))
        q_dots, q_ref = fk.update_q_dots_batched, ref.update_q_dots_batched_ref
        upd_p, p_ref = fk.update_p_batched, ref.update_p_batched_ref
    else:
        a, w, b = (torch.tensor(x, device=dev) for x in (0.37, -1.3, 0.81))
        q_dots, q_ref = fk.update_q_dots, ref.update_q_dots_ref
        upd_p, p_ref = fk.update_p, ref.update_p_ref
    got, want = q_dots(a, *v), q_ref(a, *v)
    rel = max(float(((x - y).abs() / y.abs()).max()) for x, y in zip(got[1:], want[1:]))
    out["k2" + sfx] = dict(bitwise=bool(got[0].equal(want[0])), dot_rel=rel,
                           ms=[cuda_ms(lambda: q_dots(a, *v)) for _ in range(3)])
    del got, want
    out["k4" + sfx] = dict(bitwise=bool(upd_p(b, w, *v).equal(p_ref(b, w, *v))),
                           ms=[cuda_ms(lambda: upd_p(b, w, *v)) for _ in range(3)])
    del v
    torch.cuda.empty_cache()
print(json.dumps(out))
'''

DOT_TIME = CUDA_MS + r'''
from repro_torch.core import stencil
from repro_torch.kernels.stencil_nd.fused import stencil7_dots_padded
from repro_torch.kernels.stencil_nd.ref import stencil7_dots_padded_ref

offs, shape = stencil.STAR7.offsets, (608, 608, 1536)
vp = torch.randn(tuple(s + 2 for s in shape), generator=g, device=dev).to(dt)
cfs = [(0.1 * torch.randn(shape, generator=g, device=dev)).to(dt) for _ in offs]
w = torch.randn(shape, generator=g, device=dev).to(dt)
# the two-dot variant's w is the iterate: the kernel takes it from its ring,
# the memory-w form reads the same values from a contiguous copy
w2 = vp[1:-1, 1:-1, 1:-1].contiguous() if sys.argv[1] == "two_dots_memory_w" else None
for name, (ww, two) in {"one_dot": (w, False), "two_dots": (w2, True)}.items():
    run = lambda: stencil7_dots_padded(vp, ww, cfs, two_dots=two)
    got, want = run(), stencil7_dots_padded_ref(vp, ww, cfs, offs, two_dots=two)
    rel = max(float((x - y).abs() / y.abs()) for x, y in zip(got[1:], want[1:]) if y is not None)
    out[name] = dict(bitwise=bool(got[0].equal(want[0])), dot_rel=rel,
                     ms=[cuda_ms(run) for _ in range(3)])
    del got, want
print(json.dumps(out))
'''

#: evict-first loads and stores (dot_mixed's loads change with them; it is not timed here)
_HINTS = [("if (wide) return __ldg(", "if (wide) return __ldcs("),
          ("reinterpret_cast<uint4*>(p)[j] = v;", "__stcs(reinterpret_cast<uint4*>(p) + j, v);")]
#: The x-march's ring (stencil_march.cuh: Ring) against two other forms of
#: the same march, bits unchanged: the prologue, prefetch and rotation
#: written out in the kernel (march_in_kernel), and the prologue and plane
#: loop in one device function that takes the plane's body as a callback
#: (march_callback, the function in _MARCH)
_MARCH = r"""
template <int R, int SLOTS, int SLOT, int VZ, typename RawT, typename St, typename Src,
          typename Body>
__device__ __forceinline__ void march(St& stage, RawT* sm, const Src& src_of, int64_t vstride,
                                      int pz, int nc, int qs, int rows_ok, int cols_ok, int x0,
                                      int x1, bool live, const Body& body) {
  for (int j = 0; j <= 2 * R; ++j) {
    stage.load(src_of(x0 + j), vstride, pz, nc, rows_ok, cols_ok);
    stage.store(sm + j * SLOT + (VZ - R), qs, nc);
  }
  __syncthreads();
  int base = 0;
  for (int x = x0; x < x1; ++x) {
    const bool more = x + 1 < x1;
    if (more) stage.load(src_of(x + 2 * R + 1), vstride, pz, nc, rows_ok, cols_ok);
    if (live) {
      int slot[2 * R + 1];
#pragma unroll
      for (int d = 0; d <= 2 * R; ++d)
        slot[d] = (base + d < SLOTS ? base + d : base + d - SLOTS) * SLOT;
      body(x, slot);
    }
    if (more) {
      const int next = base + 2 * R + 1 < SLOTS ? base + 2 * R + 1 : base + 2 * R + 1 - SLOTS;
      stage.store(sm + next * SLOT + (VZ - R), qs, nc);
    }
    __syncthreads();
    base = base + 1 == SLOTS ? 0 : base + 1;
  }
}

"""
_K1_HEAD = ("template <typename T, typename A, int KIND, int R, int NB, bool PAIR>\n"
            "__global__ void __launch_bounds__(kThreads, min_blocks(NB)) stencil_nd_kernel(")
_K1_RING_HEAD = """  Ring<R, SLOT, VZ, RawT, decltype(stage), decltype(src_of)> ring{
      stage, sm, src_of, p.vp_stride, pz, nc, QS, rows_ok, cols_ok, x1};
  ring.begin(x0);                                   // planes x0-r .. x0+r
"""
_K1_RING_TOP = """  for (int x = x0; x < x1; ++x) {
    ring.prefetch(x);
    if (live) {
      int slot[2 * R + 1];                          // element offset of interior plane x + dx
#pragma unroll
      for (int d = 0; d <= 2 * R; ++d) slot[d] = ring.slot(d);
"""
_K1_STORE = "        if (q < nc) store_vec(u + q * p.u_stride + o, acc[q].pack(), wide, nz);\n"
_K1_RING_END = _K1_STORE + """    }
    ring.advance(x);
  }
}
"""
_K1_IN_KERNEL = [
    (_K1_RING_HEAD, """\
  // prologue: padded planes x0 .. x0+2r (interior x0-r .. x0+r) into slots 0 .. 2r
  for (int j = 0; j <= 2 * R; ++j) {
    stage.load(src_of(x0 + j), p.vp_stride, pz, nc, rows_ok, cols_ok);
    stage.store(sm + j * SLOT + (VZ - R), QS, nc);
  }
  __syncthreads();
"""),
    (_K1_RING_TOP, """\
  int base = 0;                                     // slot of padded plane x (interior x - r)
  for (int x = x0; x < x1; ++x) {
    const bool more = x + 1 < x1;
    if (more) stage.load(src_of(x + 2 * R + 1), p.vp_stride, pz, nc, rows_ok, cols_ok);
    if (live) {
      int slot[2 * R + 1];                          // element offset of interior plane x + dx
#pragma unroll
      for (int d = 0; d <= 2 * R; ++d)
        slot[d] = (base + d < SLOTS ? base + d : base + d - SLOTS) * SLOT;
"""),
    (_K1_RING_END, _K1_STORE + """    }
    if (more) {
      const int next = base + 2 * R + 1 < SLOTS ? base + 2 * R + 1 : base + 2 * R + 1 - SLOTS;
      stage.store(sm + next * SLOT + (VZ - R), QS, nc);
    }
    __syncthreads();
    base = base + 1 == SLOTS ? 0 : base + 1;
  }
}
"""),
]
_K1_CALLBACK = [
    (_K1_HEAD, _MARCH + _K1_HEAD),
    (_K1_RING_HEAD, ""),
    (_K1_RING_TOP, "  march<R, SLOTS, SLOT, VZ>(stage, sm, src_of, p.vp_stride, pz, nc, QS, "
                   "rows_ok,\n                            cols_ok, x0, x1, live, "
                   "[&](int x, const int* slot) {\n"),
    (_K1_RING_END, _K1_STORE + "  });\n}\n"),
]

#: the same forms of K6
_K6_HEAD = "template <typename T, typename A, int ND, bool ALIGNED4>\n__global__"
_K6_RING_HEAD = """    Ring<1, SLOT, VZ, RawT, decltype(stage), decltype(src_of)> ring{
        stage, sm, src_of, 0, pz, 1, 0, rows_ok, cols_ok, x1};
    ring.begin(x0);                                 // planes x0-1 .. x0+1
"""
_K6_RING_TOP = """    for (int x = x0; x < x1; ++x) {
      ring.prefetch(x);
      if (live) {   // rows past by and lanes past Z add nothing to the dots
        int slot[3];                                // element offset of interior plane x + dx
#pragma unroll
        for (int d = 0; d <= 2; ++d) slot[d] = ring.slot(d);
"""
_K6_FLUSH = ("        if ((unsigned)(x - x0) % kRuns == kRuns - 1) dots.flush();"
             "   // every kChunk terms\n")
_K6_RING_END = _K6_FLUSH + """      }
      ring.advance(x);
    }
"""
_K6_IN_KERNEL = [
    (_K6_RING_HEAD, """    constexpr int SLOTS = 4;
    // prologue: padded planes x0 .. x0+2 (interior x0-1 .. x0+1) into slots 0 .. 2
    for (int j = 0; j <= 2; ++j) {
      stage.load(src_of(x0 + j), 0, pz, 1, rows_ok, cols_ok);
      stage.store(sm + j * SLOT + (VZ - 1), 0, 1);
    }
    __syncthreads();
"""),
    (_K6_RING_TOP, """\
    int base = 0;                                   // slot of padded plane x (interior x - 1)
    for (int x = x0; x < x1; ++x) {
      const bool more = x + 1 < x1;
      if (more) stage.load(src_of(x + 3), 0, pz, 1, rows_ok, cols_ok);
      if (live) {   // rows past by and lanes past Z add nothing to the dots
        int slot[3];                                // element offset of interior plane x + dx
#pragma unroll
        for (int d = 0; d <= 2; ++d)
          slot[d] = (base + d < SLOTS ? base + d : base + d - SLOTS) * SLOT;
"""),
    (_K6_RING_END, _K6_FLUSH + """      }
      if (more) {
        const int next = base + 3 < SLOTS ? base + 3 : base + 3 - SLOTS;
        stage.store(sm + next * SLOT + (VZ - 1), 0, 1);
      }
      __syncthreads();
      base = base + 1 == SLOTS ? 0 : base + 1;
    }
"""),
]
_K6_CALLBACK = [
    (_K6_HEAD, _MARCH + _K6_HEAD),
    (_K6_RING_HEAD, "    constexpr int SLOTS = 4;\n"),
    (_K6_RING_TOP, "    march<1, SLOTS, SLOT, VZ>(stage, sm, src_of, 0, pz, 1, 0, rows_ok, "
                   "cols_ok, x0,\n"
                   "                              x1, live, [&](int x, const int* slot) {\n"),
    (_K6_RING_END, _K6_FLUSH + "    });\n"),
]

#: family -> (source, time script, kernels whose ptxas lines are kept, variants:
#: name -> substitutions in the source; "as_is" is the committed kernel)
FAMILIES = {
    "stencil": ("stencil_nd.cu", STENCIL_TIME, r"stencil_nd_kernel", {
        "as_is": [],
        "2_blocks_per_sm": [("kMinBlocks1 = 4", "kMinBlocks1 = 2")],
        "3_blocks_per_sm": [("kMinBlocks1 = 4", "kMinBlocks1 = 3")],
        "2_byte_staging": [("(reinterpret_cast<uintptr_t>(vp) & 3) == 0;", "false;")],
        "2_byte_staging_2_blocks": [("(reinterpret_cast<uintptr_t>(vp) & 3) == 0;", "false;"),
                                    ("kMinBlocks1 = 4", "kMinBlocks1 = 2")],
        "march_in_kernel": _K1_IN_KERNEL,
        "march_callback": _K1_CALLBACK,
    }),
    "fused_iter": ("fused_iter.cu", FUSED_TIME, r"update_(q_dots|p)_kernel", {
        "as_is": [],
        "1_group_4_blocks": [("kStepGroups = 2;", "kStepGroups = 1;")],
        "1_group_8_blocks": [("kStepGroups = 2;", "kStepGroups = 1;"),
                             ("kStreamMinBlocks = 4;", "kStreamMinBlocks = 8;")],
        "2_groups_8_blocks": [("kStreamMinBlocks = 4;", "kStreamMinBlocks = 8;")],
        "hints": _HINTS,
        "1_group_8_blocks_hints": [("kStepGroups = 2;", "kStepGroups = 1;"),
                                   ("kStreamMinBlocks = 4;", "kStreamMinBlocks = 8;"), *_HINTS],
    }),
    "stencil7_dot": ("stencil7_dot.cu", DOT_TIME, r"stencil7_dot_kernel", {
        "as_is": [],
        "4_blocks_per_sm": [("kMinBlocksDot = 3;", "kMinBlocksDot = 4;")],
        "2_blocks_per_sm": [("kMinBlocksDot = 3;", "kMinBlocksDot = 2;")],
        "x_loop_not_unrolled": [("    for (int x = x0; x < x1; ++x) {",
                                 "#pragma unroll 1\n    for (int x = x0; x < x1; ++x) {")],
        # the two-dot variant reads w (the iterate) from memory, as the one-dot does
        "two_dots_memory_w": [
            ("if constexpr (ND == 2) wv = window<T, 0>(mine + slot[1]);",
             "if constexpr (false) wv = window<T, 0>(mine + slot[1]);"),
            ("(w == nullptr) != (n_dots == 2)", "w == nullptr"),
            ("src/repro_torch/kernels/stencil_nd/fused.py", "    if (w is None) != two_dots:\n",
             "    if w is None:\n")],
        "march_in_kernel": _K6_IN_KERNEL,
        "march_callback": _K6_CALLBACK,
    }),
}


def registers(log: str, pattern: str) -> dict:
    """Registers, stack frame and spill stores of each kernel whose mangled
    name matches ``pattern``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
        if name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, {})["registers"] = int(m.group(1))
        if name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)):
            out.setdefault(name, {})["stack_frame"] = int(m.group(1))
            out[name]["spill_stores"] = int(m.group(2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("--variants", nargs="+", default=None,
                    help="the variants to build and time, in this order (default all)")
    ap.add_argument("--out", type=Path, default=None,
                    help="default build/kernel_variants_<family>.json")
    args = ap.parse_args(argv)
    source, time_script, pattern, variants = FAMILIES[args.family]
    if args.variants:
        unknown = set(args.variants) - set(variants)
        if unknown:
            raise SystemExit(f"no such {args.family} variant: {sorted(unknown)}")
        variants = {n: variants[n] for n in args.variants}
    source = CSRC + source
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tmp = ROOT / "build" / "kernel_variants"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        dirs = {}
        for name, subs in variants.items():
            d = tmp / name
            shutil.copytree(ROOT / "src" / "repro_torch", d / "src" / "repro_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            for sub in subs:
                path, old, new = sub if len(sub) == 3 else (source, *sub)
                text = (d / path).read_text()
                if old not in text:
                    raise SystemExit(f"variant {name}: {old!r} not in {path}")
                (d / path).write_text(text.replace(old, new))
            dirs[name] = d
        build = "import sys; sys.path.insert(0, 'src'); " \
                "from repro_torch.kernels import _build; print(_build.build())"
        procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=d, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for n, d in dirs.items()}
        record = dict(card=card, variants={})
        for name, proc in procs.items():
            text, _ = proc.communicate()
            subs = variants[name]
            if proc.returncode:
                raise SystemExit(f"variant {name} failed to build:\n{text}")
            lib = Path(text.strip().splitlines()[-1])
            ptxas = registers(lib.with_suffix(".log").read_text(), pattern)
            record["variants"][name] = dict(substitutions=subs, ptxas=ptxas, runs=[])
            print(json.dumps(dict(variant=name, ptxas=ptxas)), flush=True)
        for order in (list(dirs), list(reversed(dirs))):
            for name in order:
                res = subprocess.run([sys.executable, "-c", time_script, name], cwd=dirs[name],
                                     capture_output=True, text=True)
                if res.returncode:
                    raise SystemExit(f"variant {name} failed:\n{res.stderr[-3000:]}")
                run = json.loads(res.stdout.strip().splitlines()[-1])
                record["variants"][name]["runs"].append(run)
                print(json.dumps(dict(variant=name, **run)), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = ROOT / (args.out or Path(f"build/kernel_variants_{args.family}.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    bad = [n for n, v in record["variants"].items()
           if not all(r[k]["bitwise"] for r in v["runs"] for k in r)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
