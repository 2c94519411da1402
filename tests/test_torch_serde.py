"""The port's wire format against the reference's (presto_tpu/native/
codec.py, presto_tpu/server/serde.py): codec frames and whole pages
byte-identical for the same bytes, each package decoding the other's
pages, corrupt frames rejected. Everything here is exact."""

import datetime
import decimal
import os

import numpy as np
import pytest

from presto_tpu import batch as rbatch
from presto_tpu import types as rtypes
from presto_tpu.native import codec as rcodec
from presto_tpu.server import serde as rserde
from presto_tpu_torch import batch as pbatch
from presto_tpu_torch import types as ptypes
from presto_tpu_torch.native import codec as pcodec
from presto_tpu_torch.server import serde as pserde


def _payloads():
    rng = np.random.default_rng(7)
    return [
        b"",
        b"x",
        b"abcdefgh" * 3 + b"tail",
        bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
        np.repeat(np.arange(64, dtype=np.int64), 300).tobytes(),
        (b"presto " * 2000) + bytes(range(256)),
    ]


@pytest.mark.parametrize("i", range(6))
def test_native_frames_identical(i):
    data = _payloads()[i]
    assert pcodec.native_available()
    frame = pcodec.encode(data)
    assert frame == rcodec.encode(data)
    assert pcodec.decode(rcodec.encode(data)) == data
    assert rcodec.decode(frame) == data


@pytest.mark.parametrize("i", range(6))
def test_zlib_frames_identical(monkeypatch, i):
    monkeypatch.setattr(pcodec, "load_pageserde", lambda: None)
    monkeypatch.setattr(rcodec, "load_pageserde", lambda: None)
    data = _payloads()[i]
    frame = pcodec.encode(data)
    assert frame[:1] == b"Z"
    assert frame == rcodec.encode(data)
    assert pcodec.decode(frame) == data and rcodec.decode(frame) == data


@pytest.mark.parametrize("i", range(6))
def test_checksum_python_matches_native(i):
    data = _payloads()[i]
    assert pcodec._checksum_py(data) == pcodec.checksum(data)


def _columns():
    """(name, SQL type name, python values with NULLs)."""
    d0 = datetime.date(1995, 3, 15)
    return [
        ("big", "bigint", [1, None, -(2 ** 62), 7, 0, 2 ** 40, None]),
        ("int", "integer", [3, 2 ** 31 - 1, None, -5, 0, 11, 12]),
        ("dbl", "double", [1.5, None, -0.0, 3e300, 2.25, None, 7.0]),
        ("real", "real", [0.5, 1.25, None, -2.0, 3.0, 4.0, None]),
        ("dt", "date", [(d0 - datetime.date(1970, 1, 1)).days, None, 0,
                        -1, 10000, 5, 6]),
        ("dec", "decimal(12,2)", [decimal.Decimal("12.34"), None,
                                  decimal.Decimal("-0.05"),
                                  decimal.Decimal("999.99"),
                                  decimal.Decimal("0"),
                                  decimal.Decimal("1.10"), None]),
        ("flag", "boolean", [True, False, None, True, True, False, None]),
        ("s", "varchar", ["b", None, "a", "BUILDING", "b", "é", "z"]),
    ]


def _batches(cols):
    ref = rbatch.Batch.from_pydict(
        {n: (v, rtypes.parse_type(t)) for n, t, v in cols})
    port = pbatch.Batch.from_pydict(
        {n: (v, ptypes.parse_type(t)) for n, t, v in cols})
    return ref, port


@pytest.mark.parametrize("which", ["all", "numeric", "strings"])
def test_pages_identical_and_cross_decoded(which):
    cols = _columns()
    if which == "numeric":
        cols = [c for c in cols if c[1] not in ("varchar", "boolean")]
    elif which == "strings":
        cols = [c for c in cols if c[1] in ("varchar", "boolean")]
    ref, port = _batches(cols)
    rb = rserde.batch_to_bytes(ref)
    pb = pserde.batch_to_bytes(port)
    assert pb == rb
    # each package decodes the other's page to the same rows
    assert pserde.batch_from_bytes(rb).to_pylist() == port.to_pylist()
    assert rserde.batch_from_bytes(pb).to_pylist() == ref.to_pylist()
    # the host pages agree field by field
    pp, rp = pserde.page_from_bytes(rb), rserde.page_from_bytes(pb)
    assert list(pp.columns) == list(rp.columns)
    for name in pp.columns:
        a, b = pp.columns[name], rp.columns[name]
        assert a.type_name == b.type_name and a.dictionary == b.dictionary
        assert a.data.dtype.str == b.data.dtype.str
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.mask, b.mask)
    assert pserde.page_to_bytes(pp) == rserde.page_to_bytes(rp)


def test_dead_rows_do_not_travel():
    """Only live rows are framed: a batch with dead lanes compacts to
    the same page the reference writes."""
    cols = _columns()
    ref, port = _batches(cols)
    keep = np.array([True, False, True, True, False, True, True]
                    + [False] * (ref.capacity - 7))
    import jax.numpy as jnp
    import torch
    ref = rbatch.Batch(ref.columns, jnp.asarray(keep))
    port = pbatch.Batch(port.columns, torch.from_numpy(keep))
    rb = rserde.batch_to_bytes(ref)
    assert pserde.batch_to_bytes(port) == rb
    assert pserde.batch_from_bytes(rb).num_valid() == 5


@pytest.mark.parametrize("damage", ["short", "checksum", "codec", "size"])
def test_corrupt_frame_raises(damage):
    _, port = _batches(_columns())
    page = bytearray(pserde.batch_to_bytes(port))
    hlen = int.from_bytes(page[:4], "big")
    frame = 4 + hlen
    if damage == "short":
        page = page[:frame + 5]
    elif damage == "checksum":
        page[frame + 9] ^= 0xFF
    elif damage == "codec":
        page[frame] = ord("Q")
    else:
        page[frame + 1:frame + 9] = (1 << 40).to_bytes(8, "little")
    with pytest.raises(pcodec.PageCorruption):
        pserde.batch_from_bytes(bytes(page))


def test_codec_library_builds_under_the_package():
    from presto_tpu_torch import native
    lib = native.load_pageserde()
    assert lib is not None
    built = [p for p in os.listdir(native.BUILD_DIR)
             if p.startswith("pageserde-") and p.endswith(".so")]
    assert built
