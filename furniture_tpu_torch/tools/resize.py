#!/usr/bin/env python
"""Furniture resizer.

The port's counterpart of ``tools/resize.py`` (the reference's
``demo_resizer.py``/``run_resizer``, ``env/furniture.py:2626-2694``, and its
XML rescaler), with the same arguments: writes a scaled copy of a furniture
spec into the asset directory the port reads (``models.ASSET_DIR``, shared
with the JAX package) and prints the compiled part masses before and after,
so the scaling can be audited. It runs on the host (numpy) and uses no
device::

    python furniture_tpu_torch/tools/resize.py table_lack_0825 --scale 1.3 --out table_lack_big
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("furniture")
    p.add_argument("--scale", type=float, required=True)
    p.add_argument("--out", default=None, help="output spec name (default <name>_x<scale>)")
    args = p.parse_args(argv)

    from furniture_tpu_torch import models

    spec = models.load_spec("furniture", args.furniture)
    scaled = models.scale_spec(spec, args.scale)
    out_name = args.out or f"{args.furniture}_x{args.scale:g}".replace(".", "p")
    scaled["model"] = out_name
    out_path = models.ASSET_DIR / "furniture" / f"{out_name}.json"
    with open(out_path, "w") as f:
        json.dump(scaled, f)
    print(f"wrote {out_path}")

    before = models.compile_model(args.furniture)
    after = models.compile_model(args.furniture, size_scale=args.scale)
    for name, m0, m1 in zip(before.part_names, before.part_mass, after.part_mass):
        print(f"  {name}: mass {m0:.4f} -> {m1:.4f} kg "
              f"(x{m1 / max(m0, 1e-12):.2f})")
    return out_path


if __name__ == "__main__":
    main()
