"""Compiled GPU kernels against their plain references (marked `gpu`: these
skip without a card; run them with JAX_PLATFORMS=cuda,cpu pytest -m gpu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mundy_tpu.neighbor.rows import (build_rows, extract_kernel_ok,
                                     make_row_grid, row_extract_xla)
from mundy_tpu.ops.pallas.row_extract import row_neighbor_extract

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n,box,K", [(20000, 58.0, 16), (6000, 16.0, 48)])
def test_row_extract_kernel_matches_xla(gpu_device, n, box, K):
    cutoff = 1.45
    with jax.default_device(gpu_device):
        pos = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), jnp.float32,
                                 maxval=box)
        grid = make_row_grid([0, 0, 0], (box,) * 3, cutoff, n,
                             dtype=jnp.float32, align=8)
        assert extract_kernel_ok(grid, K, 4)
        rows = build_rows(pos, jnp.arange(n, dtype=jnp.int32), grid)
        ids_k, cnt_k = jax.jit(lambda st: row_neighbor_extract(
            st.pos, st.gid, st.valid, (box,) * 3, cutoff, K))(rows)
        ids_x, cnt_x = jax.jit(lambda st: row_extract_xla(
            st, ((box,) * 3, (True,) * 3), cutoff, K))(rows)
    valid = np.asarray(rows.valid)
    np.testing.assert_array_equal(np.asarray(cnt_k), np.asarray(cnt_x))
    assert np.asarray(cnt_k).max() <= K
    np.testing.assert_array_equal(np.sort(np.asarray(ids_k)[valid], axis=1),
                                  np.sort(np.asarray(ids_x)[valid], axis=1))
