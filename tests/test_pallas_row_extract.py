"""Triton K-neighbor extraction kernel vs brute force and the XLA path.

Runs the kernel in interpret mode on CPU; the compiled kernel is checked
against the XLA extraction on the card by chip_smoke.py. Covers small rows
(one own-slot tile), dense rows (several tiles, C = 1024), lane-id fields
wider than 10 bits, very large R at small nz (C = 4096), the static envelope
check, and lowering to Triton IR for the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mundy_tpu.neighbor.rows import build_rows, make_row_grid
from mundy_tpu.ops.pallas.row_extract import (_plan, row_extract_fits,
                                              row_neighbor_extract)


def _brute_sets(pos, box, cutoff):
    p = np.asarray(pos, np.float64)
    b = np.asarray(box, np.float64)
    d = p[:, None, :] - p[None, :, :]
    d -= b * np.round(d / b)
    r2 = (d * d).sum(-1)
    np.fill_diagonal(r2, np.inf)
    hits = r2 < cutoff * cutoff
    return [set(np.nonzero(hits[i])[0].tolist()) for i in range(len(p))]


def _run(n, box, cutoff, K, seed=7):
    box3 = np.broadcast_to(np.asarray(box, np.float64), (3,))
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(0, 1, (n, 3)) * box3, jnp.float32)
    grid = make_row_grid([0, 0, 0], box3, cutoff, n,
                         dtype=jnp.float32, align=8)
    state = build_rows(pos, jnp.arange(n, dtype=jnp.int32), grid)
    ids, cnt = row_neighbor_extract(state.pos, state.gid, state.valid,
                                    tuple(box3), cutoff, K, interpret=True)
    ids = np.asarray(ids)
    cnt = np.asarray(cnt)
    gid = np.asarray(state.gid)
    valid = np.asarray(state.valid)
    assert (cnt[~valid] == 0).all() and (ids[~valid] == -1).all()
    want = _brute_sets(pos, box3, cutoff)
    checked = 0
    for iy, iz, r in zip(*np.nonzero(valid)):
        g = gid[iy, iz, r]
        got = [int(v) for v in ids[iy, iz, r] if v >= 0]
        assert cnt[iy, iz, r] == len(want[g]), (g, cnt[iy, iz, r])
        assert cnt[iy, iz, r] <= K, "test sized K below max count"
        assert len(got) == len(set(got)) and set(got) == want[g], (g, got)
        # sorted nearest first, up to the lane field's low mantissa bits
        d = np.asarray(pos)[got] - np.asarray(pos)[g]
        d -= box3 * np.round(d / box3)
        r2 = (d * d).sum(-1)
        assert (np.diff(r2) >= -r2[1:] * 2.0 ** -10).all()
        checked += 1
    assert checked == n
    return grid.row_capacity


def test_extract_full_rows():
    # small occupancy: one own-slot tile per row
    R = _run(n=3000, box=20.0, cutoff=1.0, K=24)
    assert R <= 32


def test_extract_dense_rows():
    # tight box -> 8x8 row grid with dense rows: several own-slot tiles
    R = _run(n=2400, box=8.0, cutoff=1.0, K=48)
    assert R > 63 and _plan(R, 48)[2] > 1


def test_extract_wide_lane_bits():
    # R >= 114 -> 9R > 1024 -> lane-id field wider than 10 bits
    R = _run(n=3900, box=8.0, cutoff=1.0, K=64, seed=11)
    assert 9 * R > 1024


def test_extract_large_R_small_nz():
    # long-x box: R counts beads per full-x (y,z) column, so a long thin
    # box drives R past 200 while the local density (and hence K) stays
    # small: C = 4096 lanes, small own-slot tiles
    R = _run(n=7000, box=(60.0, 8.0, 8.0), cutoff=1.0, K=24, seed=5)
    assert R > 180 and _plan(R, 24)[0] == 4096


def test_extract_rejects_oversize_rows():
    # past the lane cap or the pass cap the envelope refuses and the
    # caller takes the XLA path
    assert not row_extract_fits(460, 12)
    assert not row_extract_fits(88, 65)
    assert row_extract_fits(455, 64)
    assert row_extract_fits(88, 12)   # 1M-sphere LCP broad phase shape
    pos = jnp.zeros((8, 8, 460, 3), jnp.float32)
    gid = jnp.zeros((8, 8, 460), jnp.int32)
    with pytest.raises(ValueError, match="envelope"):
        row_neighbor_extract(pos, gid, gid > 0, (64.0,) * 3, 1.0, 12,
                             interpret=True)


@pytest.mark.parametrize("R,K", [(88, 12), (200, 24)])
def test_extract_lowers_to_triton(R, K):
    """The kernel lowers to Triton IR for the GPU (compiling that IR to
    PTX happens only where a card is present)."""
    pos = jax.ShapeDtypeStruct((6, 8, R, 3), jnp.float32)
    gid = jax.ShapeDtypeStruct((6, 8, R), jnp.int32)
    valid = jax.ShapeDtypeStruct((6, 8, R), jnp.bool_)
    fn = jax.jit(lambda p, g, v: row_neighbor_extract(
        p, g, v, (30.0, 30.0, 30.0), 1.2, K))
    text = fn.trace(pos, gid, valid).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text
