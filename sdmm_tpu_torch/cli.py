"""Command-line renderer of the port (port of sdmm_tpu/cli.py: ``render`` and
``compare``, with the same arguments and outputs).

    python -m sdmm_tpu_torch render scene.xml -o out.exr -D key=val --spp 64
    python -m sdmm_tpu_torch render scene.xml --integrator sdmm --spp 1024
    python -m sdmm_tpu_torch compare image.exr reference.exr

Integrators: ``gt``/``volpath`` (path tracing with NEE) and ``path`` (no
NEE) through ``render_wavefront``, or through the wave renderer
``renderer.render`` for a scene with a medium or a sampler other than
``independent`` or an rfilter other than ``box``; ``sdmm``, the guided
training render, through ``SDMMTrainer`` (``-D reservoirCapacity=N``,
``-D optimizeAsync=true``; ``--resume`` continues from a full checkpoint,
``--checkpoint`` writes one at the end); ``ppg``, practical path guiding,
through ``PPGTrainer``. The others keep their place in the argument list
and raise ``NotImplementedError``, naming the ROADMAP item that ports them.
Renders run on the card unless ``--device cpu`` is given. Stats go next to
the output as stats.json; an sdmm render also writes its guiding model to
checkpoints/model_NNNNN.asdmm.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

INTEGRATORS = ["gt", "volpath", "path", "sdmm", "ppg", "direct", "ao",
               "field", "ptracer", "vpl", "photonmapper", "ppm", "sppm",
               "pssmlt", "mlt", "erpt", "bdpt", "adaptive", "multichannel",
               "irrcache", "motion"]
# The integrators still to port, by ROADMAP item.
UNPORTED_INTEGRATORS = {name: "A12" for name in INTEGRATORS[5:]}


def _parse_defines(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[k] = v
    return out


def _write_stats(out_dir, stats):
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)


def cmd_render(args):
    import numpy as np

    from .core.device import resolve_device
    from .scene.xml_loader import load_scene, unported
    from .utils.exr import write_exr

    device = resolve_device(args.device)
    overrides = _parse_defines(args.define)
    overrides.setdefault("samplesPerIteration",
                         str(args.samples_per_iteration))
    if args.integrator:
        overrides["integrator"] = args.integrator
    builder = load_scene(args.scene, overrides)
    integrator = args.integrator or builder.integrator.get("type", "volpath")
    if integrator in UNPORTED_INTEGRATORS:
        raise unported(f"the {integrator} integrator",
                        UNPORTED_INTEGRATORS[integrator])
    sampler = args.sampler or builder.sampler
    rfilter = args.rfilter or builder.rfilter
    scene, cfg = builder.build(device=device)
    if args.width:
        cfg.width = args.width
    if args.height:
        cfg.height = args.height
    if args.max_depth:
        cfg.max_depth = args.max_depth
        cfg.rr_depth = args.max_depth
    spp = args.spp or builder.sample_count
    out = args.output or os.path.splitext(args.scene)[0] + ".exr"
    out_dir = os.path.dirname(os.path.abspath(out))
    os.makedirs(out_dir, exist_ok=True)

    t0 = time.time()
    if integrator == "ppg":
        from .guiding.ppg import PPGConfig, PPGTrainer

        trainer = PPGTrainer(scene, cfg, PPGConfig(seed=builder.seed),
                             device=device)
        image, _ = trainer.run(total_spp=spp, verbose=args.verbose)
        _write_stats(out_dir, trainer.stats)
    elif integrator == "sdmm":
        from .guiding import io as gio
        from .guiding.trainer import SDMMTrainer, TrainerConfig

        tc = TrainerConfig(
            samples_per_iteration=int(overrides.get("samplesPerIteration",
                                                    4)),
            seed=builder.seed,
            reservoir_capacity=int(overrides.get("reservoirCapacity", 0)),
            optimize_async=overrides.get("optimizeAsync", "false") == "true",
        )
        trainer = SDMMTrainer(scene, cfg, tc, device=device)
        prev_iters = trainer.restore(args.resume) if args.resume else None
        image, iters = trainer.run(total_spp=spp, verbose=args.verbose,
                                   iters=prev_iters)
        if args.checkpoint:
            gio.save_full_checkpoint(args.checkpoint, trainer, iters)
        _write_stats(out_dir, trainer.stats)
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        gio.save_checkpoint(os.path.join(
            ckpt_dir, f"model_{trainer.iteration:05d}.asdmm"), trainer)
        if args.dump_iterations:
            for i, it in enumerate(iters):
                n = np.maximum(it["weight"], 1.0)[:, None]
                for name, film in (("iteration", it["image"]),
                                   ("iteration_sqr", it["sqr"])):
                    write_exr(os.path.join(out_dir, f"{name}{i:05d}.exr"),
                              (film / n).reshape(cfg.height, cfg.width, 3))
    else:
        nee = integrator in ("gt", "volpath")
        if not cfg.has_medium and sampler == "independent" \
                and rfilter == "box":
            from .render.wavefront import render_wavefront

            res = render_wavefront(scene, cfg, spp=spp, seed=builder.seed,
                                   nee=nee, device=device)
        else:
            from .render.renderer import render

            res = render(scene, cfg, spp=spp, seed=builder.seed, nee=nee,
                         sampler=sampler, rfilter=rfilter, device=device)
        image = res["image"]
        _write_stats(out_dir, {"integrator": integrator, "spp": spp,
                               "seconds": time.time() - t0,
                               "mean": float(np.asarray(image).mean())})

    if out.endswith(".npy"):
        np.save(out, np.asarray(image))
    else:
        write_exr(out, np.asarray(image))
    if args.npy:
        np.save(args.npy, np.asarray(image))
    print(f"Rendered {args.scene} [{integrator}] {cfg.width}x{cfg.height} @ "
          f"{spp} spp in {time.time() - t0:.1f}s -> {out}")


def cmd_compare(args):
    from .utils.exr import read_exr
    from .utils.metrics import all_metrics

    print(json.dumps(all_metrics(read_exr(args.image),
                                 read_exr(args.reference)), indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sdmm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a Mitsuba-0.6 XML scene")
    r.add_argument("scene")
    r.add_argument("-o", "--output")
    r.add_argument("-D", "--define", action="append", metavar="key=val",
                   help="scene variable override (as mitsuba -D)")
    r.add_argument("--integrator", choices=INTEGRATORS)
    r.add_argument("--resume", help="resume a training render from a full "
                   "checkpoint (.npz)")
    r.add_argument("--checkpoint", help="write a full resume checkpoint "
                   "(.npz) at the end of the render")
    r.add_argument("--spp", type=int)
    r.add_argument("--samples-per-iteration", type=int, default=4)
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--max-depth", type=int)
    r.add_argument("--dump-iterations", action="store_true")
    r.add_argument("--sampler",
                   choices=["independent", "stratified", "halton", "sobol"])
    r.add_argument("--rfilter",
                   choices=["box", "tent", "gaussian", "mitchell",
                            "catmullrom", "lanczos"])
    r.add_argument("--npy", help="also save the film as a .npy array")
    r.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    r.add_argument("-v", "--verbose", action="store_true")
    r.set_defaults(fn=cmd_render)

    c = sub.add_parser("compare", help="image metrics vs a reference EXR")
    c.add_argument("image")
    c.add_argument("reference")
    c.set_defaults(fn=cmd_compare)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
