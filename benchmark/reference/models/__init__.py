"""Model registry for furniture_tpu_torch.

The port's own copy of ``furniture_tpu.models``: glob-sorted furniture list
with stable integer ids, agent names and background names. The JSON assets
are read in place from the JAX package's ``assets/`` directory (data, not an
import), resolved relative to this file.
"""

from __future__ import annotations

from pathlib import Path

# benchmark/reference/models/__init__.py -> the checkout's root
ASSET_DIR = Path(__file__).resolve().parents[3] / "furniture_tpu" / "assets"

furniture_xmls = sorted(p.name for p in (ASSET_DIR / "furniture").glob("*.json"))
furniture_names = [p[: -len(".json")] for p in furniture_xmls]
furniture_name2id = {name: i for i, name in enumerate(furniture_names)}
furniture_ids = list(range(len(furniture_names)))

background_names = [
    "Industrial",
    "Lab",
    "Garage",
    "Ambient",
    "NightTime",
    "Interior",
    "STC",
]

agent_names = ["Baxter", "Sawyer", "Panda", "Jaco", "Fetch", "Cursor"]

from .compiler import (  # noqa: E402,F401
    CompiledModel,
    compile_from_config,
    compile_model,
    load_spec,
    scale_spec,
)
