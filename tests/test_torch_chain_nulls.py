"""The slice as a whole on NULLs: the port's chain against the JAX package's.

The dryrun_multichip production-chain batch with NULL urls (masked
columns keep their validity, NULL rows hash to empty bytes) and NULL
regions (UNKNOWN rows never pass the filter), with urls of 1-4 SHA
blocks; both dispatch encodings, chunked dispatch on and off.
"""

import numpy as np
import pytest

from test_torch_chain import DRYRUN, ROWS, check_chain, dryrun_data
from test_torch_chain import knobs  # noqa: F401  (fixture)


def dryrun_nulls_data(n):
    cols, data = dryrun_data(n)
    rng = np.random.default_rng(2)
    data["url"] = [None if i % 13 == 0 else u + "/x" * int(rng.integers(0, 100))
                   for i, u in enumerate(data["url"])]
    data["region"] = [None if i % 7 == 0 else r
                      for i, r in enumerate(data["region"])]
    return cols, data


@pytest.mark.parametrize("chunk", [256, 0])
@pytest.mark.parametrize("encoding", ["raw", "auto"])
def test_chain_with_nulls_byte_identical_to_jax(encoding, chunk, knobs):
    cols, data = dryrun_nulls_data(ROWS)
    check_chain(DRYRUN, cols, data, knobs, encoding, chunk)
