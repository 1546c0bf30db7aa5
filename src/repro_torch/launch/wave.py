"""Explicit acoustic wave propagation: shots through ``core/wave.propagate_shot``.

    PYTHONPATH=src python -m repro_torch.launch.wave --mesh 755 994 1000 --steps 200 --shots 4
    PYTHONPATH=src python -m repro_torch.launch.wave --device cpu --mesh 24 24 32 --steps 40
    PYTHONPATH=src python -m repro_torch.launch.wave --device cpu --mesh 24 24 32 --obs
    PYTHONPATH=src python -m repro_torch.launch.wave --profile --run-dir /tmp/wave_p

The source's workload (Jacquelin, Araya-Polo and Meng, SC22): the
constant-density acoustic wave equation, 8th-order in space (the 25-point
star), second order in time, float32.  The medium is
``core/wave.gradient_velocity`` from ``--seed`` (1500 to 4500 m/s with depth
along Z, a smooth 5% lateral perturbation; h = 10 m, dt = 0.8 ms); each
shot starts from rest, its source (a 10 Hz Ricker wavelet) drawn from the
seed in the middle half of X by Y at depth index 10, runs ``--steps``
steps with no host wait between them and is waited for at its end.  It
prints each shot's time, ms a step, its share of the step's compulsory
bytes at the card's HBM bandwidth (16 B a point: read u, u_prev and c,
write u_next) and its peak amplitude.  K7 runs the steps on the
card, its plain version on the CPU.  It runs on the card unless
``--device cpu`` is given, and refuses to start without one.  ``--obs``
(implied by ``--profile``/``--run-dir``) writes a run bundle whose trace
holds the ``wave.*`` spans.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from repro_torch.core import perfmodel, wave
from repro_torch.device import device_name, synchronize
from repro_torch.obs import manifest as obs_manifest

#: compulsory bytes of one step per point: read u, u_prev and c, write u_next (f32)
BYTES_PER_POINT = 4 * 4
#: time step (s), grid spacing (m), the Ricker wavelet (Hz, s), the sources' depth index
DT, H, RICKER, SOURCE_DEPTH = 8e-4, 10.0, wave.Ricker(10.0, 0.1), 10


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.wave")
    ap.add_argument("--mesh", type=int, nargs=3, default=[128, 128, 128],
                    metavar=("X", "Y", "Z"), help="grid points; Z is depth and contiguous")
    ap.add_argument("--steps", type=int, default=200, help="time steps a shot")
    ap.add_argument("--shots", type=int, default=1, help="shots, one after another")
    ap.add_argument("--seed", type=int, default=0, help="the medium and the shot positions")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda)")
    ap.add_argument("--obs", action="store_true",
                    help="observability: spans + metrics + a run bundle "
                         "results/runs/<run_id>/ (or --run-dir)")
    ap.add_argument("--profile", action="store_true",
                    help="run under torch.profiler into <run_dir>/torch_profile "
                         "(implies --obs)")
    ap.add_argument("--run-dir", default=None, help="bundle directory override (implies --obs)")
    return ap


def shot_sources(shape, shots: int, seed: int) -> list[tuple[int, int, int]]:
    """Source points from ``seed``: x and y in the middle half of the grid,
    z at :data:`SOURCE_DEPTH` (or the deepest point of a shallower grid)."""
    rng = random.Random(seed)
    nx, ny, nz = shape
    return [(rng.randrange(nx // 4, nx - nx // 4), rng.randrange(ny // 4, ny - ny // 4),
             min(SOURCE_DEPTH, nz - 1)) for _ in range(shots)]


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    args.obs = args.obs or args.profile or args.run_dir is not None
    return (obs_manifest.run_bundled("wave", args, device, run) if args.obs
            else run(args, device))


def run(args: argparse.Namespace, device: torch.device) -> dict:
    shape = tuple(args.mesh)
    dev_name = device_name(device)
    points = shape[0] * shape[1] * shape[2]
    model = wave.WaveModel.from_velocity(
        wave.gradient_velocity(shape, seed=args.seed, device=device), dt=DT, h=H)
    sources = shot_sources(shape, args.shots, args.seed)
    cfl = float(model.c.max()) ** 0.5
    print(f"acoustic wave, 25-point star, f32, mesh {'x'.join(map(str, shape))} "
          f"({points / 1e6:.1f} M points), {args.steps} steps a shot, dt={DT:g} s, "
          f"h={H:g} m, CFL {cfl:.3f}, device={dev_name}")
    peak = perfmodel.HBM_BW if device.type == "cuda" else None
    shots = []
    for k, src in enumerate(sources):
        synchronize(device)
        t0 = time.perf_counter()
        res = wave.propagate_shot(model, src, RICKER, args.steps)
        synchronize(device)
        wall = time.perf_counter() - t0
        ms = wall / max(args.steps, 1) * 1e3
        amp = float(res.u.abs().max())
        rec = dict(source=list(src), wall_s=wall, ms_per_step=ms, max_abs_u=amp,
                   failed=res.failed)
        if peak is not None:
            rec["bytes_share"] = points * BYTES_PER_POINT / peak / (ms * 1e-3)
        shots.append(rec)
        share = f", {rec['bytes_share']:.1%} of the bytes bound" if peak is not None else ""
        print(f"shot {k} at {tuple(src)}: {wall:.3f} s, {ms:.3f} ms/step{share}, "
              f"max |u| {amp:.4e}{'  FAILED' if res.failed else ''}")
    out = dict(mesh=list(shape), steps=args.steps, device=dev_name, cfl=cfl, shots=shots)
    if any(s["failed"] for s in shots):
        print("WARNING: a shot failed (a value not finite, or past the blow-up bound)")
    return out


if __name__ == "__main__":
    main()
