"""Perf-iteration tool, as ``repro.analysis.perf``: one (arch, shape)
pair's roofline terms on H100 constants under configurable knobs, for
the hypothesis -> change -> measure loop.

    PYTHONPATH=src python -m repro_torch.analysis.perf --arch yi-6b \\
        --shape decode_32k [--no-fsdp] [--no-remat] [--fp32-scores] \\
        [--json out.jsonl]

Runs on the production mesh's fake process group, made in this process
(``launch.mesh.device_mesh(..., "fake")``), so run it in its own
process, like ``launch.dryrun``.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="force FSDP (default: the lower_step policy)")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--fp32-scores", action="store_true",
                    help="ablation: the fp32 attention-score path")
    ap.add_argument("--label", default="")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    from repro_torch.analysis.roofline import roofline_extrapolated
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.mesh import (destroy, device_mesh,
                                         make_production_mesh)

    if args.fp32_scores:
        from repro_torch.models.layers import set_scores_fp32
        set_scores_fp32(True)

    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    mesh = device_mesh(make_production_mesh(multi_pod=args.multi_pod),
                       "fake")
    fsdp = True if args.fsdp else (False if args.no_fsdp else None)
    try:
        rec = roofline_extrapolated(cfg, shape, mesh, fsdp=fsdp,
                                    remat=not args.no_remat)
    finally:
        destroy()
    rec.update(arch=args.arch, shape=args.shape, label=args.label,
               fsdp=fsdp, remat=not args.no_remat)
    print(f"[perf] {args.arch} x {args.shape} "
          f"({args.label or 'baseline'}; fsdp={rec['fsdp']}):")
    print(f"  compute={rec['compute_s']:.4e}s "
          f"(fp32-dot share {rec['f32_dot_share']:.0%}) "
          f"memory={rec['memory_s']:.4e}s "
          f"collective={rec['collective_s']:.4e}s "
          f"-> {rec['bottleneck']}")
    print(f"  coll breakdown: {rec['coll_breakdown']}")
    print(f"  useful={rec['useful_ratio']:.3f}")
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
