"""Console entry points (pyproject [project.scripts]).

Twin of `cam_nor_physics_tpu.cli`. `cam-nor-torch-run`: a Held-Suarez run
of the coupled driver with history and checkpoint output
(driver.quick_run), on the card unless `--device cpu`:

    python -m cam_nor_physics_tpu_torch.cli --device cpu --nsteps 2
    cam-nor-torch-run --im 144 --jm 96 --km 26 --nsteps 16 --chunk 8

`bench_main` runs the port's bench (bench.main, one JSON line). Flags
stay few; a run is configured through the config dataclasses
(utils/config.py, the namelist's role).
"""

from __future__ import annotations

import argparse


def bench_main() -> None:
    """The port's bench as an installed script."""
    from .bench import main
    main()


def run_main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Held-Suarez run of the coupled driver of the "
                    "PyTorch/CUDA port")
    p.add_argument("--im", type=int, default=48)
    p.add_argument("--jm", type=int, default=24)
    p.add_argument("--km", type=int, default=10)
    p.add_argument("--nsteps", type=int, default=8)
    p.add_argument("--chunk", type=int, default=1,
                   help="steps per dispatch (a CUDA graph on the card)")
    p.add_argument("--hist-every", type=int, default=0)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--out", default="output")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    args = p.parse_args(argv)

    from .driver import quick_run
    state, timer = quick_run(
        im=args.im, jm=args.jm, km=args.km, nsteps=args.nsteps,
        device=args.device, out_dir=args.out, hist_every=args.hist_every,
        ckpt_every=args.ckpt_every, chunk=args.chunk)
    print(timer.table())
    print(f"completed step {int(state.nstep)}; output in {args.out}")


if __name__ == "__main__":
    run_main()
