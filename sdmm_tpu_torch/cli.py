"""Command-line renderer of the port (port of sdmm_tpu/cli.py: ``render``,
``compare`` and ``import``, with the same arguments and outputs).

    python -m sdmm_tpu_torch render scene.xml -o out.exr -D key=val --spp 64
    python -m sdmm_tpu_torch render scene.xml --integrator sdmm --spp 1024
    python -m sdmm_tpu_torch compare image.exr reference.exr
    python -m sdmm_tpu_torch import scene.dae out.xml

Integrators: ``gt``/``volpath`` (path tracing with NEE) and ``path`` (no
NEE) through ``render_wavefront``, or through the wave renderer
``renderer.render`` for a scene with a medium or a sampler other than
``independent`` or an rfilter other than ``box``; ``sdmm``, the guided
training render, through ``SDMMTrainer`` (``-D reservoirCapacity=N``,
``-D optimizeAsync=true``; ``--resume`` continues from a full checkpoint,
``--checkpoint`` writes one at the end); ``ppg``, practical path guiding,
through ``PPGTrainer``; the classic integrators of ``render/classic.py``:
``direct`` (``emitterSamples``, ``bsdfSamples``, ``shadingSamples``),
``ao`` (``rayLength``, ``shadingSamples``), ``field`` (``field``) and
``motion`` (``time``) through the wave renderer, ``adaptive``
(``maxError``; ``--spp`` is the most a pixel takes) and ``multichannel``
(``fields``: one EXR a field beside the output, then the first field as the
output), each reading its properties from the scene's integrator and
``-D``; the light-path integrators: ``ptracer`` (``render/ptracer.py``),
``vpl`` (``lightPaths``, ``maxDepth``), ``bdpt`` (``render/bdpt.py``, in
waves of BDPT_WAVE samples), ``photonmapper`` (``globalPhotons``), and
``ppm`` and ``sppm`` (``maxPasses``, ``photonCount``, ``alpha``) through
``render/photonmap.py``; the Metropolis integrators: ``pssmlt``
(``pLarge``) and ``erpt`` (``chainLength``) through ``render/pssmlt.py``,
and ``mlt`` through ``render/mlt.py``, which falls back to ``pssmlt`` on a
scene without area emitters or where no bootstrap path finds one (b = 0);
and ``irrcache`` (``resolution``, ``quality``, ``indirectOnly``) through
``render/irrcache.py``. Renders run on the card unless ``--device cpu`` is
given. Stats go next to the output as stats.json; an sdmm render also
writes its guiding model to checkpoints/model_NNNNN.asdmm. ``import``
converts a COLLADA file to a scene XML and OBJ meshes (the output also as
``-o``), then builds the written scene on ``--device`` and prints its
triangle count.
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
LIGHT_PATH_INTEGRATORS = ("ptracer", "vpl", "bdpt", "photonmapper", "ppm",
                          "sppm")
# BDPT's samples a wave on the CLI: a whole 640x360 image in one wave (the
# reference's default is 2^15, eight waves a sample there).
BDPT_WAVE = 1 << 18


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
    from .scene.xml_loader import load_scene
    from .utils.exr import write_exr

    device = resolve_device(args.device)
    overrides = _parse_defines(args.define)
    overrides.setdefault("samplesPerIteration",
                         str(args.samples_per_iteration))
    if args.integrator:
        overrides["integrator"] = args.integrator
    builder = load_scene(args.scene, overrides)
    integrator = args.integrator or builder.integrator.get("type", "volpath")
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
    elif integrator in ("direct", "ao", "field", "motion", "adaptive",
                        "multichannel"):
        image = _render_classic(integrator, scene, cfg, builder, overrides,
                                spp, sampler, rfilter, out, out_dir, t0,
                                device)
    elif integrator in LIGHT_PATH_INTEGRATORS:
        image = _render_light_paths(integrator, scene, cfg, builder,
                                    overrides, spp, out_dir, t0, device)
    elif integrator in ("pssmlt", "mlt", "erpt", "irrcache"):
        image = _render_mcmc_irrcache(integrator, scene, cfg, builder,
                                      overrides, spp, out_dir, t0, device)
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


def _render_classic(integrator, scene, cfg, builder, overrides, spp, sampler,
                    rfilter, out, out_dir, t0, device):
    """One of the classic integrators; writes stats.json (and a
    multichannel render's field EXRs) and returns the image."""
    import numpy as np

    from .render import classic
    from .render.renderer import render
    from .utils.exr import write_exr

    props = dict(builder.integrator)
    props.update(overrides)
    types = cfg.bsdf_types or None
    stats = {"integrator": integrator, "spp": spp}
    if integrator == "adaptive":
        res = classic.render_adaptive(
            scene, cfg, max_spp=spp, seed=builder.seed,
            max_error=float(props.get("maxError", 0.05)), device=device)
        image = res["image"]
        stats.update(seconds=time.time() - t0,
                     mean_spp=float(res["spp_map"].mean()),
                     mean=float(image.mean()))
    elif integrator == "multichannel":
        fields = tuple(f for f in str(props.get(
            "fields", "position,shNormal,albedo,distance")).split(",")
            if f in classic.FIELDS)
        chans = classic.render_multichannel(scene, cfg, fields=fields,
                                            spp=spp, seed=builder.seed,
                                            device=device)
        base, ext = os.path.splitext(out)
        for name, chan in chans.items():
            write_exr(f"{base}_{name}{ext or '.exr'}", np.asarray(chan))
        image = chans[fields[0]]
        stats.update(fields=list(fields), seconds=time.time() - t0)
    else:
        if integrator == "direct":
            es = int(props.get("emitterSamples",
                               props.get("shadingSamples", 1)))
            bs = int(props.get("bsdfSamples", props.get("shadingSamples", 1)))

            def trace(sc, gen, ro, rd):
                return classic.trace_direct(
                    sc, gen, ro, rd, emitter_samples=es, bsdf_samples=bs,
                    bsdf_types=types, has_bump=cfg.has_bump, device=device)
        elif integrator == "ao":
            rl = float(props.get("rayLength", -1.0))
            ss = int(props.get("shadingSamples", 1))

            def trace(sc, gen, ro, rd):
                return classic.trace_ao(sc, gen, ro, rd, ray_length=rl,
                                        shading_samples=ss, device=device)
        elif integrator == "field":
            fld = props.get("field", "shNormal")

            def trace(sc, gen, ro, rd):
                return classic.trace_field(sc, gen, ro, rd, field=fld,
                                           bsdf_types=types, device=device)
        else:  # motion: the reference renders it with the box filter
            tm = float(props.get("time", 1.0))
            sampler, rfilter = "independent", "box"

            def trace(sc, gen, ro, rd):
                return classic.trace_motion(
                    sc, gen, ro, rd, width=cfg.width, height=cfg.height,
                    time=tm, fov_axis=cfg.fov_axis, device=device)
        image = render(scene, cfg, spp=spp, seed=builder.seed,
                       trace_fn=trace, sampler=sampler, rfilter=rfilter,
                       device=device)["image"]
        stats.update(seconds=time.time() - t0, mean=float(image.mean()))
    _write_stats(out_dir, stats)
    return image


def _render_light_paths(integrator, scene, cfg, builder, overrides, spp,
                        out_dir, t0, device):
    """One of the light-path integrators with the reference's properties
    and defaults; writes the reference's stats.json and returns the
    image."""
    import numpy as np

    props = dict(builder.integrator)
    props.update(overrides)
    extra = {}
    if integrator == "ptracer":
        from .render.ptracer import render_ptracer

        res = render_ptracer(scene, cfg, spp=spp, seed=builder.seed,
                             device=device)
        extra["n_paths"] = res["n_paths"]
    elif integrator == "vpl":
        from .render.ptracer import render_vpl

        res = render_vpl(scene, cfg, spp=spp, seed=builder.seed,
                         n_light_paths=int(props.get("lightPaths", 32)),
                         vpl_depth=int(props.get("maxDepth", 4)),
                         device=device)
    elif integrator == "bdpt":
        from .render.bdpt import render_bdpt

        res = render_bdpt(scene, cfg, spp=spp, seed=builder.seed,
                          rays_per_wave=BDPT_WAVE, device=device)
    elif integrator == "photonmapper":
        from .render.photonmap import render_photonmap

        res = render_photonmap(
            scene, cfg, spp=spp, seed=builder.seed,
            n_photon_paths=int(props.get("globalPhotons", 1 << 17)),
            device=device)
    else:
        # ppm and sppm share the progressive driver, which re-jitters the
        # camera points every pass.
        from .render.photonmap import render_sppm

        res = render_sppm(
            scene, cfg, seed=builder.seed,
            iterations=int(props.get("maxPasses", max(spp // 4, 4))),
            photon_paths_per_iter=int(props.get("photonCount", 1 << 16)),
            alpha=float(props.get("alpha", 0.7)), device=device)
    image = res["image"]
    _write_stats(out_dir, {"integrator": integrator, "spp": spp,
                           "seconds": time.time() - t0, **extra,
                           "mean": float(np.asarray(image).mean())})
    return image


def _flag(value) -> bool:
    """A boolean property: a bool as it is, a string true when it reads
    "true" (any case)."""
    return value.lower() == "true" if isinstance(value, str) else bool(value)


def _render_mcmc_irrcache(integrator, scene, cfg, builder, overrides, spp,
                          out_dir, t0, device):
    """pssmlt, erpt, mlt (with the reference's fallback to pssmlt) or
    irrcache with the reference's properties and defaults; writes the
    reference's stats.json (b for the Metropolis integrators) and returns
    the image."""
    import numpy as np

    props = dict(builder.integrator)
    props.update(overrides)
    extra = {}
    if integrator == "irrcache":
        from .render.irrcache import render_irrcache

        res = render_irrcache(
            scene, cfg, spp=spp, seed=builder.seed,
            gather_res=int(props.get("resolution", 14)),
            kappa=float(props.get("quality", 1.0)),
            indirect_only=_flag(props.get("indirectOnly", False)),
            device=device)
    else:
        from .render import pssmlt as psm

        if integrator == "erpt":
            res = psm.render_erpt(
                scene, cfg, spp=spp, seed=builder.seed,
                chain_length=int(props.get("chainLength", 32)),
                device=device)
        else:
            res = None
            if integrator == "mlt":
                from .render.mlt import render_mlt

                if scene.em_tri_idx.numel() > 0:
                    res = render_mlt(scene, cfg, spp=spp, seed=builder.seed,
                                     device=device)
                if res is None or res["b"] <= 0.0:
                    # Environment transport lies outside the path-space
                    # subspace; pssmlt's primary-sample mutations carry it.
                    print("mlt: no area-emitter bootstrap paths (b == 0); "
                          "falling back to pssmlt for env transport")
                    res = None
            if res is None:
                res = psm.render_pssmlt(
                    scene, cfg, spp=spp, seed=builder.seed,
                    p_large=float(props.get("pLarge", 0.3)),
                    mutations="kelemen", device=device)
        extra["b"] = res["b"]
    image = res["image"]
    _write_stats(out_dir, {"integrator": integrator, "spp": spp,
                           "seconds": time.time() - t0, **extra,
                           "mean": float(np.asarray(image).mean())})
    return image


def cmd_compare(args):
    from .utils.exr import read_exr
    from .utils.metrics import all_metrics

    print(json.dumps(all_metrics(read_exr(args.image),
                                 read_exr(args.reference)), indent=2))


def cmd_import(args):
    from .core.device import resolve_device
    from .scene.collada import import_collada
    from .scene.xml_loader import load_scene

    device = resolve_device(args.device)
    out = args.output or args.out_xml
    if not out:
        raise SystemExit("import: name the output scene (.xml)")
    n = import_collada(args.dae, out)
    scene, _ = load_scene(out).build(device=device)
    print(f"Imported {n} meshes from {args.dae} -> {out} "
          f"({scene.tri_v0.shape[0]} triangles on {device})")
    return 0


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

    i = sub.add_parser("import", help="convert a COLLADA .dae scene to "
                       "scene XML + OBJ meshes")
    i.add_argument("dae")
    i.add_argument("out_xml", nargs="?", help="output scene .xml")
    i.add_argument("-o", "--output", help="output scene .xml")
    i.add_argument("--device", default="cuda",
                   help="where the written scene is built: cuda (the "
                   "default) or cpu")
    i.set_defaults(fn=cmd_import)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
