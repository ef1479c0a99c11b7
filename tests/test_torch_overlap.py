"""The port's ``distributed/overlap.py``: the ring all-gather matmul on 1, 2
and 4 CPU shards (and each line of a 2 x 2 mesh) against the gathered
``x @ w``, at JAX's ``tests/test_distribution.py`` tolerance (rtol 1e-5),
and JAX's own ring on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.overlap import ring_allgather_matmul_shardmap as j_ring
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro_torch.distributed.overlap import ring_allgather_matmul, ring_allgather_matmul_shardmap
from repro_torch.launch.mesh import make_mesh


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 2)])
def test_ring_allgather_matmul_matches_dense(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    mesh = make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))
    got = ring_allgather_matmul_shardmap(mesh)(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    want = j_ring(j_host_mesh())(jnp.asarray(x), jnp.asarray(w))  # JAX's ring, one device
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_every_rank_of_a_ring_gets_the_product_and_holds_its_shard():
    """Rank r starts from its own shard: every rank's product equals x @ w,
    and the ranks' inputs are left as they were."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 48, generator=gen)
    w = torch.randn(48, 16, generator=gen)
    ws = [t.clone() for t in w.chunk(4)]
    outs = ring_allgather_matmul([x] * 4, ws, [torch.device("cpu")] * 4)
    for y in outs:
        torch.testing.assert_close(y, x @ w, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(ws, w.chunk(4)))
    with pytest.raises(ValueError, match="no 'model'"):
        ring_allgather_matmul_shardmap(make_mesh((2,), ["cpu"] * 2, ("data",)))
