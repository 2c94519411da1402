"""The port's Batch/Column round trip against the reference's, for every
scalar type of types.py: Python values (None = NULL) in, the same
Python values out."""

import decimal

import pytest

from presto_tpu.batch import Batch as JaxBatch
from presto_tpu.types import parse_type as jax_type

from presto_tpu_torch.batch import Batch as TorchBatch
from presto_tpu_torch.types import parse_type as torch_type

VALUES = {
    "bigint": [1, None, -(1 << 40), 0],
    "integer": [7, -3, None, 2 ** 31 - 1],
    "smallint": [1, None, -32768, 32767],
    "tinyint": [None, -128, 127, 5],
    "double": [1.5, None, -2.25, 1e300],
    "real": [0.5, None, 3.25, -1.0],
    "boolean": [True, False, None, True],
    "varchar": ["b", None, "a", "b"],
    "date": [10471, None, 0, -5],
    "timestamp": [1_700_000_000_000, None, 0, -1],
    "decimal(12,2)": [decimal.Decimal("12.34"), None, 5, -0.5],
}


@pytest.mark.parametrize("type_name", sorted(VALUES))
def test_round_trip_matches_reference(type_name):
    vals = VALUES[type_name]
    want = JaxBatch.from_pydict(
        {"x": (vals, jax_type(type_name))}).to_pylist()
    got = TorchBatch.from_pydict(
        {"x": (vals, torch_type(type_name))}).to_pylist()
    assert got == want
    assert [type(v) for (v,) in got] == [type(v) for (v,) in want]


def test_dictionary_remaps_match_reference():
    """unify_dictionaries / remap_column: same codes, same dictionary."""
    import numpy as np
    import jax.numpy as jnp
    from presto_tpu import batch as jb
    from presto_tpu.types import VARCHAR as JV
    from presto_tpu_torch import batch as tb
    from presto_tpu_torch.types import VARCHAR as TV
    import torch
    rng = np.random.default_rng(2)
    specs = [(("b", "d", "f"), rng.integers(0, 3, 64)),
             (("a", "b", "c", "e"), rng.integers(0, 4, 64))]
    mask = rng.random(64) < 0.8
    jcols = [jb.Column(jnp.asarray(c.astype(np.int32)), jnp.asarray(mask),
                       JV, d) for d, c in specs]
    tcols = [tb.Column(torch.from_numpy(c.astype(np.int32)),
                       torch.from_numpy(mask), TV, d) for d, c in specs]
    for j, t in zip(jb.unify_dictionaries(jcols),
                    tb.unify_dictionaries(tcols)):
        assert j.dictionary == t.dictionary
        np.testing.assert_array_equal(np.asarray(j.data), t.data.numpy())
    target = jb.union_dictionary(specs[0][0], ("z",))
    assert target == tb.union_dictionary(specs[0][0], ("z",))
    j = jb.remap_column(jcols[0], target)
    t = tb.remap_column(tcols[0], target)
    np.testing.assert_array_equal(np.asarray(j.data), t.data.numpy())
