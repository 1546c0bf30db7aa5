#!/usr/bin/env python3
"""Time source variants of one of the port's kernel families in turns on one GPU.

    python3 scripts/kernel_variants.py stencil      [--out build/kernel_variants_stencil.json]
    python3 scripts/kernel_variants.py fused_iter   [--out build/kernel_variants_fused_iter.json]

Each variant is the family's CUDA source (``src/repro_torch/kernels/csrc/``)
with a few text substitutions, built into its own copy of the package under
``build/kernel_variants/`` (all builds at once; removed at the end), then
timed in the order given and again in reverse, each checked bit for bit
against the plain version first.  ``stencil``: K1 at 608x608x1536 and K1b at
608^3 x 4 RHS (star7, bf16 storage and accumulation).  ``fused_iter``: K2
(update_q_dots) and K4 (update_p) at 608x608x1536 and K2b/K4b at 608^3 x 4
RHS, bf16, their dots' relative gap to the plain version recorded beside
the bitwise check.  Times are CUDA events, mean of 20 launches, three
repeats.  Prints one JSON line per variant and run, the registers and spill
stores of the variant's kernels, and the card's name and power limit.
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
for name, shape, nb in (("k1", (608, 608, 1536), 0), ("k1b", (608, 608, 608), 4)):
    pre = (nb,) if nb else ()
    vp = torch.randn(pre + tuple(s + 2 for s in shape), generator=g, device=dev).to(dt)
    cfs = [(0.1 * torch.randn(shape, generator=g, device=dev)).to(dt) for _ in offs]
    f = stencil_nd_batched if nb else stencil_nd
    run = lambda: f(vp, cfs, offs, radius=1, accum_dtype=dt)
    want = stencil_nd_padded_ref(vp, cfs, offs, radius=1, accum_dtype=dt)
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

#: evict-first loads and stores (dot_mixed's loads change with them; it is not timed here)
_HINTS = [("if (wide) return __ldg(", "if (wide) return __ldcs("),
          ("reinterpret_cast<uint4*>(p)[j] = v;", "__stcs(reinterpret_cast<uint4*>(p) + j, v);")]
#: family -> (source, time script, kernels whose ptxas lines are kept, variants:
#: name -> substitutions in the source; "as_is" is the committed kernel)
FAMILIES = {
    "stencil": ("stencil_nd.cu", STENCIL_TIME, r"stencil_nd_kernel\w*bfloat16S2_", {
        "as_is": [],
        "2_blocks_per_sm": [("kMinBlocks1 = 4", "kMinBlocks1 = 2")],
        "3_blocks_per_sm": [("kMinBlocks1 = 4", "kMinBlocks1 = 3")],
        "2_byte_staging": [("(reinterpret_cast<uintptr_t>(vp) & 3) == 0;", "false;")],
        "2_byte_staging_2_blocks": [("(reinterpret_cast<uintptr_t>(vp) & 3) == 0;", "false;"),
                                    ("kMinBlocks1 = 4", "kMinBlocks1 = 2")],
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
}


def registers(log: str, pattern: str) -> dict:
    """Registers and spill stores of each kernel whose mangled name matches ``pattern``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
        if name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, {})["registers"] = int(m.group(1))
        if name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out.setdefault(name, {})["spill_stores"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("--out", type=Path, default=None,
                    help="default build/kernel_variants_<family>.json")
    args = ap.parse_args(argv)
    source, time_script, pattern, variants = FAMILIES[args.family]
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
            src = (d / source).read_text()
            for old, new in subs:
                if old not in src:
                    raise SystemExit(f"variant {name}: {old!r} not in {source}")
                src = src.replace(old, new)
            (d / source).write_text(src)
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
                res = subprocess.run([sys.executable, "-c", time_script], cwd=dirs[name],
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
