"""What a dry-run step holds at its peak: the live tensors by the op that
made them.

    PYTHONPATH=src:. python tools/peak_holders.py --arch yi-6b \
        --shape prefill_32k [--mesh single|multi|DxM|PxDxM] [--reduced] \
        [--set num_layers=2 ...]

Runs the step as ``repro_torch.launch.dryrun`` does (fake tensors, rank 0
of a fake process group over the mesh; ``--shape`` a name of
``INPUT_SHAPES`` or ``T,B,kind``) under a counting mode that notes, for
every tensor the step makes, the aten op that made it and, for one of
more than ``SITE_BYTES``, the lines of ``repro_torch`` that ran the op.
Prints the step's peak and temporaries (the peak less the outputs it
made, the dry-run's temp bytes), the call stack where the peak was
reached, and the ``TOP`` largest groups of the tensors alive there, by
op, shape, dtype and site. CPU only; run it in its own process (the fake
process group is process-global).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import traceback
import weakref

from repro_torch.analysis.roofline import OpTally, measure

TOP = 25                # groups of live tensors printed
SITE_BYTES = 50e6       # a tensor this large notes the lines that made it


def _sites(n: int = 4) -> str:
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename and "roofline" not in f.filename]
    return " <- ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
                       for f in reversed(frames[-n:]))


class HolderTally(OpTally):
    """``OpTally`` that also keeps, for each storage it tracks, the op
    that made it, and the live set at the latest peak."""

    def __init__(self, args=()):
        super().__init__(args)
        self._op = "?"
        self._made = weakref.WeakKeyDictionary()
        self.at_peak: list = []
        self.peak_site = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        prev, self._op = self._op, func.overloadpacket.__name__
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._op = prev

    def _track(self, t, inputs) -> None:
        s = t.untyped_storage()
        if id(s) in inputs or s in self._tracked:
            return
        n = s.nbytes()
        site = _sites() if n > SITE_BYTES else ""
        self._made[s] = (self._op, tuple(t.shape),
                         str(t.dtype).replace("torch.", ""), site, n)
        before = self.peak_bytes
        super()._track(t, inputs)
        if self.peak_bytes > before:
            self.at_peak = list(self._made.values())
            self.peak_site = _sites(6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config fields, NAME=JSON")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.launch.specs import lower_step
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {k: json.loads(v) for k, v in (a.split("=", 1) for a in args.set)}
    if over:
        cfg = dataclasses.replace(cfg, **over)
    if args.shape in configs.INPUT_SHAPES:
        shape = configs.INPUT_SHAPES[args.shape]
    else:
        t, b, kind = args.shape.split(",")
        shape = configs.base.ShapeConfig("s", int(t), int(b), kind)
    named = {"single": (16, 16), "multi": (2, 16, 16)}
    sizes = named.get(args.mesh) or tuple(int(n) for n in
                                          args.mesh.split("x"))
    mesh = device_mesh(Mesh(dict(zip(("pod", "data", "model")[-len(sizes):],
                                     sizes))), "fake")
    import repro_torch.analysis.roofline as roofline
    roofline.OpTally, plain = HolderTally, roofline.OpTally
    try:
        t = measure(lower_step(cfg, shape, mesh))
    finally:
        roofline.OpTally = plain
    print(f"peak {t.peak_bytes / 1e9:.3f} GB, outputs "
          f"{t.output_bytes / 1e9:.3f} GB, temporaries "
          f"{(t.peak_bytes - t.output_bytes) / 1e9:.3f} GB, dot FLOPs "
          f"{t.total_dot_flops:.6g}")
    print(f"at the peak: {t.peak_site}")
    count, size = collections.Counter(), collections.Counter()
    for op, shp, dtype, site, n in t.at_peak:
        count[op, shp, dtype, site] += 1
        size[op, shp, dtype, site] += n
    for (op, shp, dtype, site), n in size.most_common(TOP):
        print(f"  {n / 1e9:9.3f} GB {count[op, shp, dtype, site]:5d} x "
              f"{op} {list(shp)} {dtype}" + (f"  @ {site}" if site else ""))
    from repro_torch.launch.mesh import destroy
    destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
