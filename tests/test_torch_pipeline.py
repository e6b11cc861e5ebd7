"""The GPipe pipeline (``repro_torch.sharding.pipeline.pipeline_apply``) on
gloo meshes of CPU processes: the layers applied in sequence, and the JAX
package's ``pipeline_apply`` on a 1x1 mesh, with ``tests/test_pipeline.py``'s
layer and shapes (L 8, B 16, D 32, 4 microbatches): (1, 4) runs 4 stages of
2 layers, (2, 2) 2 stages of 4 layers on each of 2 data shards, (1, 1) one
stage."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh
from repro.sharding.pipeline import pipeline_apply as jax_pipeline_apply

torch.set_num_threads(2)

L, B, D, N_MICRO = 8, 16, 32, 4
TOL = 1e-5  # tests/test_pipeline.py's
MESHES = {1: [(1, 1)], 4: [(1, 4), (2, 2)]}


def _inputs():
    rng = np.random.default_rng(0)
    params = {"w": (0.3 * rng.standard_normal((L, D, D))).astype(np.float32),
              "b": (0.1 * rng.standard_normal((L, D))).astype(np.float32)}
    return params, rng.standard_normal((B, D)).astype(np.float32)


def _sequential():
    """The layers applied one after another, in torch on the CPU."""
    params, x = _inputs()
    h = torch.tensor(x)
    for i in range(L):
        h = torch_mesh.tanh_layer({k: torch.tensor(v[i]) for k, v in params.items()}, h)
    return h.numpy()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{(n_data, n_model): [the output on each rank]}."""
    params, x = _inputs()
    out = {}
    for world, shapes in MESHES.items():
        ranks = torch_mesh.run(torch_mesh.pipeline_cases, world,
                               tmp_path_factory.mktemp(f"pipe{world}"), shapes, params, x,
                               N_MICRO)
        for shape in shapes:
            out[shape] = [r[shape].numpy() for r in ranks]
    return out


@pytest.mark.parametrize("shape", [s for shapes in MESHES.values() for s in shapes],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pipeline_equals_sequential(results, shape):
    """Every rank gets the global output: the layers in sequence."""
    want = _sequential()
    assert len(results[shape]) == shape[0] * shape[1]
    for y in results[shape]:
        assert y.shape == (B, D)
        np.testing.assert_allclose(y, want, atol=TOL, rtol=TOL)
    assert float(np.abs(want).max()) > 0.5


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_pipeline_matches_jax_pipeline(results, shape):
    """The reference's ``pipeline_apply`` on a 1x1 mesh, and its sequential
    application (``tests/test_pipeline.py``), on the same inputs."""
    params, x = _inputs()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def layer(pl_, h):
        return jnp.tanh(h @ pl_["w"] + pl_["b"])

    jp = jax.tree.map(jnp.asarray, params)
    with mesh:
        want = np.asarray(jax_pipeline_apply(layer, jp, jnp.asarray(x), mesh, n_micro=N_MICRO))
    seq = jnp.asarray(x)
    for i in range(L):
        seq = layer(jax.tree.map(lambda a: a[i], jp), seq)
    np.testing.assert_allclose(want, np.asarray(seq), atol=TOL, rtol=TOL)
    for y in results[shape]:
        np.testing.assert_allclose(y, want, atol=TOL, rtol=TOL)
