"""PyTorch port: the model compiler's resize flags against the JAX package.

Mirrors of ``tests/test_compiler.py:69,82`` (``size_scale`` scales geometry
linearly and mass cubically; ``compile_from_config`` honours
``furn_size_scale`` and ``furn_size_rand``), each held against the JAX
package's ``compile_model``/``compile_from_config`` on the same arguments
(numpy only: no JAX function runs), with the JAX test's own bounds.
"""

import numpy as np
import pytest

from furniture_tpu.config import EnvConfig as JEnvConfig
from furniture_tpu.models import compile_from_config as jax_compile_from_config
from furniture_tpu.models import compile_model as jax_compile_model
from furniture_tpu_torch.config import EnvConfig
from furniture_tpu_torch.models import compile_from_config, compile_model

FIELDS = ("geom_size", "part_init_pos", "conn_pos", "part_mass", "part_inertia", "part_com")


@pytest.mark.parametrize("name,scale", [("table_lack_0825", 2.0), ("chair_agne_0007", 0.7),
                                        ("shelf_ivar_0678", 1.3)])
def test_size_scale_resizes_geometry_and_mass(name, scale):
    """Geometry and init poses scale by ``scale``, mass by its cube; the
    scaled model equals the JAX package's."""
    base = compile_model(name)
    big = compile_model(name, size_scale=scale)
    assert np.allclose(big.geom_size, base.geom_size * scale)
    assert np.allclose(big.part_init_pos, base.part_init_pos * scale)
    assert np.allclose(big.conn_pos, base.conn_pos * scale)
    assert np.allclose(big.part_mass, base.part_mass * scale**3, rtol=1e-5)
    ref = jax_compile_model(name, size_scale=scale)
    for f in FIELDS:
        assert np.allclose(getattr(big, f), getattr(ref, f)), f


def test_compile_from_config_size_flags():
    """``furn_size_scale`` is the deterministic factor; ``furn_size_rand``
    draws ``1 + U(-r, r)`` from numpy's global generator, so both packages
    seeded alike build the same model, within 1 +/- r of the base."""
    m = compile_from_config(EnvConfig(furn_size_scale=1.5))
    ref = compile_model("table_lack_0825", size_scale=1.5)
    assert np.allclose(m.geom_size, ref.geom_size)
    assert np.allclose(m.geom_size, jax_compile_from_config(JEnvConfig(furn_size_scale=1.5)).geom_size)

    np.random.seed(3)
    m2 = compile_from_config(EnvConfig(furn_size_rand=0.2))
    np.random.seed(3)
    j2 = jax_compile_from_config(JEnvConfig(furn_size_rand=0.2))
    base = compile_model("table_lack_0825")
    ratio = m2.geom_size[0, 0] / base.geom_size[0, 0]
    assert 0.8 <= ratio <= 1.2
    for f in FIELDS:
        assert np.allclose(getattr(m2, f), getattr(j2, f)), f
