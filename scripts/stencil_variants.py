#!/usr/bin/env python3
"""Time variants of the port's stencil kernel in turns on one GPU.

    python3 scripts/stencil_variants.py [--out build/stencil_variants.json]

Each variant is ``src/repro_torch/kernels/csrc/stencil_nd.cu`` with a few
text substitutions, built into its own copy of the package under
``build/stencil_variants/`` (all builds at once; removed at the end), then timed in the order given and again in
reverse: K1 at 608x608x1536 and K1b at 608^3 x 4 RHS (star7, bf16 storage and
accumulation, CUDA events, mean of 20 launches, three repeats), each checked
bit for bit against the plain version first.  Prints one JSON line per
variant and run, and the card's name and power limit.
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
SOURCE = "src/repro_torch/kernels/csrc/stencil_nd.cu"

#: name -> substitutions in SOURCE; "as_is" is the committed kernel
VARIANTS = {
    "as_is": [],
    "2_blocks_per_sm": [("kMinBlocks1 = 4", "kMinBlocks1 = 2")],
    "3_blocks_per_sm": [("kMinBlocks1 = 4", "kMinBlocks1 = 3")],
    "2_byte_staging": [("(reinterpret_cast<uintptr_t>(vp) & 3) == 0;", "false;")],
    "2_byte_staging_2_blocks": [("(reinterpret_cast<uintptr_t>(vp) & 3) == 0;", "false;"),
                                ("kMinBlocks1 = 4", "kMinBlocks1 = 2")],
}

TIME = r'''
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch.core import stencil
from repro_torch.kernels.stencil_nd.kernel import stencil_nd, stencil_nd_batched
from repro_torch.kernels.stencil_nd.ref import stencil_nd_padded_ref

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
offs = stencil.STAR7.offsets
out = {}
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


def registers(log: str) -> dict:
    """Registers and spill stores of each bf16/bf16 stencil instantiation."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+stencil_nd_kernel\w+)'", line)
        if m:
            name = m.group(1) if "bfloat16S2_" in m.group(1) else None
        if name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, {})["registers"] = int(m.group(1))
        if name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out.setdefault(name, {})["spill_stores"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("build/stencil_variants.json"))
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tmp = ROOT / "build" / "stencil_variants"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        dirs = {}
        for name, subs in VARIANTS.items():
            d = tmp / name
            shutil.copytree(ROOT / "src" / "repro_torch", d / "src" / "repro_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            src = (d / SOURCE).read_text()
            for old, new in subs:
                if old not in src:
                    raise SystemExit(f"variant {name}: {old!r} not in {SOURCE}")
                src = src.replace(old, new)
            (d / SOURCE).write_text(src)
            dirs[name] = d
        build = "import sys; sys.path.insert(0, 'src'); " \
                "from repro_torch.kernels import _build; print(_build.build())"
        procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=d, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for n, d in dirs.items()}
        record = dict(card=card, variants={})
        for name, proc in procs.items():
            text, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"variant {name} failed to build:\n{text}")
            lib = Path(text.strip().splitlines()[-1])
            record["variants"][name] = dict(substitutions=VARIANTS[name],
                                            ptxas=registers(lib.with_suffix(".log").read_text()),
                                            runs=[])
        for order in (list(dirs), list(reversed(dirs))):
            for name in order:
                res = subprocess.run([sys.executable, "-c", TIME], cwd=dirs[name],
                                     capture_output=True, text=True)
                if res.returncode:
                    raise SystemExit(f"variant {name} failed:\n{res.stderr[-3000:]}")
                run = json.loads(res.stdout.strip().splitlines()[-1])
                record["variants"][name]["runs"].append(run)
                print(json.dumps(dict(variant=name, **run)), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    bad = [n for n, v in record["variants"].items()
           if not all(r[k]["bitwise"] for r in v["runs"] for k in r)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
