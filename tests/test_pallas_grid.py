"""SHA-256 kernel grid plumbing: programs striding over ≥2 blocks each.

The kernel *bodies* are covered by ops.testing.emulate_kernel, which runs a
one-program grid. Here the PRODUCTION grid spec (sha256_kernel._grid_spec —
the same dict the real pallas_call uses, with fewer programs) runs through
ops.testing.emulate_pallas_grid: every program walks its strided blocks and
the last block is masked, so a striding or tail bug — a block hashed twice,
skipped, or written past the end — produces wrong bytes on CPU CI.
"""

import hashlib

import numpy as np

from zkstark_tpu.hash import sha256
from zkstark_tpu.ops import sha256_kernel
from zkstark_tpu.ops.testing import emulate_pallas_grid

N = 3 * sha256_kernel.BLOCK + 5  # 4 blocks over 2 programs, ragged tail
PROGRAMS = 2


def test_leaf_grid_strided_blocks():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    got = emulate_pallas_grid(
        sha256_kernel._leaf_kernel,
        sha256_kernel._grid_spec(N, PROGRAMS),
        np.array([N], np.int32),
        sha256._K,
        vals,
    )
    # spot-check rows from every block, both programs, against hashlib
    for idx in (0, 1, 255, 256, 600, 2 * 256 + 7, N - 1):
        want = hashlib.sha256(int(vals[idx]).to_bytes(4, "big")).digest()
        assert got[idx].astype(">u4").tobytes() == want, idx


def test_node_grid_strided_blocks():
    rng = np.random.default_rng(2)
    pairs = rng.integers(0, 1 << 32, (N, 16), dtype=np.uint64).astype(np.uint32)
    got = emulate_pallas_grid(
        sha256_kernel._node_kernel,
        sha256_kernel._grid_spec(N, PROGRAMS),
        np.array([N], np.int32),
        sha256._K,
        sha256._PAD_WK,
        pairs,
    )
    for idx in (0, 3, 300, 2 * 256 + 1, N - 1):
        want = hashlib.sha256(pairs[idx].astype(">u4").tobytes()).digest()
        assert got[idx].astype(">u4").tobytes() == want, idx
