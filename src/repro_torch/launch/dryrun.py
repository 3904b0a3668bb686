"""Multi-pod dry-run, as ``repro.launch.dryrun``.

For every (architecture x input shape) pair this lays the right step
(train_step / prefill / decode_step) out on

  * the single-pod mesh  (16, 16)    = 256 chips, axes ("data", "model")
  * the multi-pod mesh   (2, 16, 16) = 512 chips, axes ("pod", "data",
    "model")

as DTensors over a fake process group of 256 or 512 ranks made in this
process (``launch.mesh.device_mesh(..., "fake")``, the counterpart of
JAX's 512 placeholder host devices), runs it on fake tensors as rank 0
(nothing is allocated; ``launch.specs.lower_step``), and prints the
bytes a chip holds (its arguments, its outputs and the peak of its
temporaries, each against the H100's 80 GB) and the roofline terms from
the chip's own ops (``analysis.roofline``).

The fake group is process-global, so run this in its own process; it
tears the group down at the end.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--both-meshes] [--json out.jsonl]
"""

import argparse
import json
import sys
import time
import traceback


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            fsdp: bool | None = None, remat: bool = True,
            swa_window: int = 0, verbose: bool = True) -> dict:
    """Lay out and run one (arch, shape, mesh) combination; returns its
    record."""
    from repro_torch.analysis.roofline import (HBM_BYTES, measure,
                                               roofline_record)
    from repro_torch.configs import INPUT_SHAPES, get_config, \
        shape_applicable
    from repro_torch.configs.base import with_sliding_window
    from repro_torch.launch.mesh import device_mesh, make_production_mesh
    from repro_torch.launch.specs import local_bytes, lower_step

    cfg = get_config(arch)
    if swa_window:
        cfg = with_sliding_window(cfg, swa_window)
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skip", "reason": why}

    mesh = device_mesh(make_production_mesh(multi_pod=multi_pod), "fake")
    t0 = time.perf_counter()
    lowered = lower_step(cfg, shape, mesh, fsdp=fsdp, remat=remat)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    tally = measure(lowered)
    t_run = time.perf_counter() - t0

    rec = {"arch": cfg.name, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single",
           "n_devices": mesh.size, "status": "ok", "fsdp": lowered.fsdp,
           "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1)}
    out_bytes = local_bytes(tally.outputs)
    rec["memory"] = {
        "argument_size_in_bytes": lowered.argument_bytes(),
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(tally.peak_bytes - tally.output_bytes, 0),
        "hbm_bytes": int(HBM_BYTES)}
    rec["roofline"] = roofline_record(tally, cfg, shape, mesh)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x "
              f"{'multi(512)' if multi_pod else 'single(256)'}: OK "
              f"(lower {t_lower:.1f}s, run {t_run:.1f}s)")
        print(f"  memory: {rec['memory']}")
        r = rec["roofline"]
        print(f"  terms(s): compute={r['compute_s']:.3e} "
              f"memory={r['memory_s']:.3e} "
              f"collective={r['collective_s']:.3e} "
              f"-> bottleneck={r['bottleneck']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--swa", type=int, default=0,
                    help="beyond-paper: retrofit sliding-window attention "
                         "of this width (lights up long_500k for dense "
                         "archs)")
    ap.add_argument("--json", help="append JSONL records here")
    args = ap.parse_args(argv)

    from repro_torch.configs import INPUT_SHAPES, list_archs
    from repro_torch.launch.mesh import destroy

    if args.all:
        combos = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        combos = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    records = []
    # one fake group a mesh: the group is made for the first combo on it
    # and torn down before the next mesh
    for mp in meshes:
        for arch, shape in combos:
            try:
                rec = run_one(arch, shape, multi_pod=mp,
                              fsdp=False if args.no_fsdp else None,
                              swa_window=args.swa)
            except Exception:
                failures += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": "multi" if mp else "single",
                       "status": "fail",
                       "error": traceback.format_exc(limit=4)}
                print(f"[dryrun] {arch} x {shape} FAILED:\n"
                      f"{rec['error']}", file=sys.stderr)
            records.append(rec)
            if args.json:
                with open(args.json, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        destroy()

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} principled skips, "
          f"{failures} failures / {len(records)} combos")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
